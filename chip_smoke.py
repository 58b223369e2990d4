#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # what the repository's check runs
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one request's and one training
                                       # step's device time by kernel, on
                                       # every model path (and, with 2-4
                                       # cards, of every rank of each
                                       # multi-card run)
    python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.multi_card_check())"
                                       # on 2-4 cards: only the multi-card
                                       # runs (fsdp, tp, cp, TorchTrainer
                                       # over dp 2) and the world-1 steps
                                       # they are held to
    python3 chip_smoke.py --compare-fwd OLD/flash_fwd.cu
    python3 chip_smoke.py --compare-bwd OLD/flash_bwd.cu
                                       # also time another design of a
                                       # kernel (same C entry point, e.g.
                                       # an earlier one from git history)
                                       # against this one

Phases, each fatal on failure (there is no CPU path and no caught phase):

1. Build every hand-written kernel from ops/csrc/ with nvcc (one process per
   source, all started together) and print ptxas' report per kernel:
   registers, static and dynamic shared memory, spills, and the highest
   register in the SASS (cuobjdump), which setmaxnreg may lift above the
   launch count. Any spill fails.
2. Hold each kernel against its plain PyTorch version on the card, at every
   model path's shapes and at the edge cases, within the stated tolerances
   (the backward also by mean error, which a moved rounding point fails,
   and by a second call that must equal the first in every bit; a tp
   rank's shape among them: llama_1b's 16 of 32 heads over tp 2),
   and time the kernel, the plain version and one PyTorch library call that
   computes the same function (a yardstick the port never calls) with CUDA
   events, the forward wrapper's host time per call, and the backward's C
   call alone (its three kernels, without the wrapper's checks and
   allocations). Print the bound: the larger of the bytes the function
   must move over 3.35 TB/s and its tensor-core operations over 989 TFLOP/s
   (H100 SXM data sheet, dense bf16).
3. GPT-2 serving: GPT-2-124M (full width, bf16, random weights from a
   seeded generator) in a Checkpoint, served by a TorchPredictor that
   answers 4 requests of 8 x 1024 tokens. Every launch count is set to 0
   just before and read just after; flash_fwd must have run exactly once
   per layer per request. The logits of one batch are checked against the
   same model with the plain attention path.
4. GPT-2 training: make_gpt2_train_step(gpt2_124m(), device="cuda") at
   B 24 x 1024 tokens (bench.py's first per-chip batch, remat off), one
   warm-up step, then 8 steps on one repeated synthetic batch. Every launch
   count is set to 0 just before and read just after; flash_fwd and
   flash_bwd must each have run exactly once per layer per step. Loss and
   grad norm must be finite and the loss must fall. Step time, tokens/s,
   peak device memory and the share of 989 TFLOP/s are printed. Then the
   loss and every parameter's gradient of one B 8 batch are checked against
   the same model with the plain attention path.
5. Llama serving: llama_7b at full depth and width (L 32, D 4096, H 32,
   hd 128, S 4096; 27 GB of f32 weights), as phase 3, 4 requests of
   2 x 4096 tokens: 32 flash_fwd launches a request.
6. Llama training: make_llama_train_step(llama_1b()) at full depth and
   width (L 22, D 2048, H 32 over 8 kv heads, hd 64, S 2048), as phase 4,
   at B 8 x 2048 tokens; its gradients are checked on one sequence.
7. The hd-128 backward inside a model: llama_7b at full width and S 4096,
   cut to 2 layers, one sequence; loss and every gradient, flash kernels
   against the plain attention path.
8. [moe] The MoE layer at GPT-2-124M's width (D 768, F 3072, E 8, top-2,
   8 x 1024 tokens), bf16 and f32, capacity factors 1.25 and 0.5 (drops):
   `moe_mlp` (index dispatch, the model path's) against `moe_mlp_plain`
   (the reference's dense einsums): identical routing, y, aux and every
   gradient within the stated tolerances, two calls bitwise equal; both
   timed, forward and forward + backward.
9. [moe-serve] gpt2_124m(moe_experts=8) at full width and depth (521 M
   params), as phase 3: 12 flash_fwd launches a request. The logits are
   checked against the plain attention path within limits measured on the
   card, and the routing decisions that differ between the two paths
   (discrete choices that bf16 noise can flip) are counted and bounded.
10. [moe-train] The same model as phase 4 at B 24 x 1024: 12 launches of
   each kernel a step, finite and falling loss; the share of 989 TFLOP/s
   from the work the card executes (E x C capacity slots per T tokens)
   printed beside the JAX formula's (which counts every expert for every
   token); gradients of one B 8 batch against the plain attention path,
   with the differing routing decisions counted.
   Each model path starts with the device memory the last one used freed,
   so that the peak memory it prints is its own.
11. [parallel] The port's device mesh at world 1: the smoke starts a
   one-rank NCCL process group and make_mesh(MeshSpec()) on cuda.
   GPT-2-124M at B 24 x 1024 through make_gpt2_train_step(mesh=...), 1 + 8
   steps, and gpt2_124m(moe_experts=8), one step, each held to the plain
   step from the same seeded parameters: first-step loss within 1e-6
   relative, grad norm within 1e-3 and every gradient within the dense
   limit, beside the plain step's own run-to-run spread (a second plain
   run, which repeats the first in every bit); 12 launches of each kernel a step on both
   paths; median step ms and peak memory of the mesh path beside the
   plain path's. [parallel-tp] llama_1b at full width and depth, B 8 x
   2048, through make_llama_train_step(mesh=...), 1 + 8 steps, held to the
   plain step in the same way (each gradient within twice the plain
   step's own spread there, 4e-2): the tensor-parallel code (column- and
   row-parallel products, vocab-parallel embedding, head and
   cross-entropy) on a tp group of one; 22 launches of each kernel a
   step; the collectives over tp counted against tp_collectives_per_step
   (on every mesh path; the plain path runs none); step ms, tokens/s and
   peak memory of both paths. [pipeline] GPT-2-124M's 12 blocks as 4 stages of 3 through
   parallel.pipeline.pipeline_apply without a group, 4 microbatches of the
   B 24 batch, against the blocks one after another: loss and every
   gradient within the dense limits, 48 launches of each kernel (the live
   (layer, microbatch) pairs; the bubble is skipped), both timed. With 2
   to 4 cards the phase also trains, one NCCL rank a card, GPT-2-124M over
   fsdp on every card, llama_1b over tp 2 (tp 4 on four cards) and, on
   four, GPT-2-124M over fsdp2·tp2 (multi_card_plans), each held to its
   model's world-1 mesh step; with one card it says that run did not take
   place. [parallel-cp] gpt2_124m(attention_impl="ring") at B 24 x 1024,
   1 + 8 steps, through ring attention on a cp group of one, held to the
   plain step as [parallel] is; the collectives over cp counted against
   cp_collectives_per_step on every mesh path. [parallel-moe-cp]
   gpt2_124m(moe_experts=8, attention_impl="ring") and [parallel-gathered]
   gpt2_124m(attention_impl="pallas"), each at B 24 x 1024, 1 + 8 steps,
   held to the plain step the same way: the MoE queue over (batch, cp)
   and a ring of one; k and v gathered over a cp group of one
   (ops/gathered_attention.py). With 2 to 4 cards the multi-card runs add
   GPT-2-124M over cp 2 (cp 4 on four cards), its MoE over cp 2 (fsdp2·cp2
   on four), gpt2_124m(attention_impl="pallas") over cp 2 and, on four,
   llama_1b over cp2·tp2 and over pp2·tp2 and GPT-2-124M over pp2·cp2: the
   ring and the gather over NCCL between cards.
12. [ring]: ring attention's step schedule (ops/ring_attention.py's
   virtual ring, all cp chunks on this card) at GPT-2-124M's attention
   [24, 12, 1024, 64] and llama_1b's [8, 32, 2048, 64] in 4 chunks,
   forward and backward: launches against ring_launches (cp rank r
   launches each kernel r + 1 times; counts set to 0 just before, read
   just after), held to the whole-sequence kernels and to the same
   schedule on the plain versions, timed beside the whole-sequence
   kernels; and each kernel held and timed at a chunk's shape at each
   kind of offsets the ring gives it (a kv chunk wholly in the past, the
   diagonal one at a non-zero offset, one wholly in the causal future),
   also at each multi-card cp plan's rank shape. It runs after the model
   paths, whose host-bound mesh steps it would otherwise precede.
13. [gathered]: the gathered path ("pallas" under cp,
   ops/gathered_attention.py's virtual gather, all cp chunks on this card)
   at GPT-2-124M's attention [24, 12, 1024, 64] and llama_1b's
   [8, 32, 2048, 64] (its 8 kv heads gathered, then repeated) over cp 2 and
   4, and llama_7b's hd-128 attention [1, 32, 4096, 128] over cp 2, forward
   and backward: cp launches of each kernel a call (gathered_launches),
   held to the whole-sequence kernels and to the same calls on the plain
   versions with [ring]'s limits, timed beside the whole-sequence kernels;
   and each kernel held and timed at each chunk's shape, q
   [B, H, S/cp, hd] at offset r·S/cp against k and v [B, H, S, hd], beside
   SDPA with an explicit boolean mask (is_causal aligns top-left), on the
   first backend that takes it (named in the row).
14. [rllib-ppo]: RLlib (ray_tpu_torch/rllib) through the reference's entry
   point, PPOConfig()...build().train(), rollouts on the host CPU and the
   learner on the card: BASELINE config 2 at the reference's settings
   (CartPole-v1, 16 envs, fragments of 256, train batch 4000, minibatch
   128, 10 epochs, lr 3e-4, seed 0) until episode_reward_mean >= 150 over
   >= 20 episodes, fatal past 100k env steps. The learner's parameters and
   Adam moments must be CUDA tensors, the runner's policy CPU tensors.
   Per iteration: sample seconds, update seconds (synchronized),
   minibatch steps/s, env-steps/s overall, peak device memory. With
   --profile, one more update's device time by kernel and the device's
   busy share.
15. [rllib-impala]: IMPALAConfig()...build().train() (the reference's
   synchronous path) to the reference's CartPole target (best
   episode_reward_mean >= 150 within 40 iterations of 8 updates of 16 x 64
   steps), then 3 iterations on Pong-v0 at the same shape: env-steps/s,
   update ms and sample ms, inline in one process (BASELINE config 4's
   asynchronous actors are not ported, so not comparable with it).
16. [rllib-dqn]: DQNConfig()...build().train() at the reference's learning
   test's settings (tests/test_rllib_dqn.py::test_dqn_learns_cartpole:
   CartPole-v1, 8 envs, fragments of 8, lr 1e-3, batch 64, learning from
   500 rows, target synced every 60 updates, 8 updates an iteration,
   epsilon over 6000 env steps, prioritized replay), fatal unless the best
   episode_reward_mean reaches 150 within 500 iterations. The replay
   buffer and the rollouts stay on the host; the learner's parameters,
   target and Adam moments must be CUDA tensors. Printed: iterations and
   env steps to the target, update ms (host clock around a synchronized
   update()) and updates/s, sample ms an iteration, peak device memory;
   with --profile, the busy share of one more training_step.
17. [rllib-sac]: SACConfig()...build().train() in the same way at its
   test's settings (fragments of 16, lr 3e-3, batch 256): 150 within 600
   iterations.
18. [rllib-bc]: the reference test's scripted CartPole expert, 40 episodes
   recorded with the port's JsonWriter into a temporary directory, then
   BCConfig().offline_data(...)...build().train() (lr 3e-3, batch 256, 32
   updates an iteration, an evaluation fragment of 64 steps): 120 within
   40 iterations.
19. [rllib-ma]: one train() of two-agent MultiAgentCartPole with two
   policies, each policy's learner on the card, the result keys the
   reference's.
20. [rllib-parity]: two optimizer steps of PPO (two epochs of one
   minibatch of the whole batch), and two updates each of IMPALA, DQN
   (its target synced at the second), SAC and BC from the same weights and
   batch on the card and on the CPU: every leaf's gradient at every step
   within 1e-5 of its largest element (a leaf no loss reaches 0 on both),
   parameters and targets within 1e-6 absolute, metrics and |TD| errors
   within 1e-5 relative or 1e-6 times the batch's mean |term| absolute
   (RLLIB_PARITY_*). Each [rllib-*] phase prints its seconds.
21. [core]: the runtime's in-process mode (ray_tpu_torch.init(local_mode=
   True)): cluster_resources() reports GPU and GPU-<kind> = the card count;
   a @remote(num_gpus=1) task takes q, k, v and do (bf16 [8, 12, 1024, 64],
   GPT-2-124M's serving shape) as put refs and runs flash_attention forward
   and backward on its own thread: its o bitwise equal to the same call on
   the main thread, its gradients within the backward kernel's limits, one
   launch of each kernel; get(put(t))
   is t for a CUDA tensor; serialize of a 256 MiB CUDA tensor gives one
   out-of-band buffer of exactly its bytes, and deserialize a CPU tensor
   equal to its .cpu(), timed (host clock, synchronized).
22. [trainer]: Train on that runtime: TorchTrainer(trainer_loop,
   scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit() trains
   GPT-2-124M (remat off) at B 24 x 1024 on the smoke's repeated synthetic
   batch, the loop reporting loss, grad norm, step and step ms every step
   and a Checkpoint.from_torch of params, ClippedAdamW's state_dict and step
   at its end: run A 4 steps; B resumed from A's checkpoint to step 8; C, C2
   and C3 8 straight steps; D under FailureConfig(max_failures=1), its first
   attempt checkpointed at step 2 and failing after step 3, retried from
   that checkpoint. Each fit ends without error, one metrics row a report,
   finite losses; C's loss falls; A's checkpoint restored by to_torch into
   a fresh state on the card equals A's final state bitwise (params,
   moments, step, count); B's losses within resume_limit of C's; each
   kernel 12 launches a step of all the runs (counts set to 0 just before
   the first fit, read just after the last). Prints each fit's seconds and
   peak memory, and the median steady step ms beside [train]'s.
23. [data]: the Data layer (ray_tpu_torch.data) in the in-process
   runtime: a 1 GiB f32 Dataset (from_numpy, rows of 4096, 16 blocks)
   through iter_batches(batch_size=16384, device="cuda",
   prefetch_batches=1), 256 MiB a batch staged in reused pinned buffers
   and copied on a side stream; every batch equal to its numpy source in
   every bit. Prints one batch's host staging ms and its pinned H2D GB/s
   beside a pageable torch.as_tensor(x).to("cuda"), and the loop's wall
   time with a fixed device workload a batch (4 f32 products with a
   [4096, 4096] matrix), three times, with the host's time inside the
   iterator's next(), beside the sums of copy and workload and of staging,
   copy and workload.
   Then iter_stacked_batches feeds one stack of 4 GPT-2-124M steps at
   B 24 to multi_step_fn: its losses equal, in every bit, step_fn's on the
   same numpy batches, with 48 launches of each kernel.
24. [cluster]: the multi-process runtime on one node:
   ray_tpu_torch.init() without local mode starts a GCS, a raylet and
   worker processes. cluster_resources() reports GPU and GPU-<kind> = the
   card count; neither the GCS nor the raylet holds a /dev/nvidia* file
   open (nvidia-smi's compute apps are printed, not checked: a container
   of its own PID namespace sees other pids there). A
   @remote(num_gpus=1) task in a worker process gets q, k, v and do
   (bf16 [8, 12, 1024, 64]) as put refs (their bytes through the node's
   shm store), moves them onto the card and runs flash_attention forward
   and backward: o, dk and dv bitwise equal to this process's own call, dq
   within the backward kernel's limits, one launch of each kernel counted
   in the worker, a pid not the driver's, no jax and no ray_tpu module in
   the worker and no kernel built there. Two tasks that each hold every
   card do not overlap (their start and end stamps). A GPU task whose
   first attempt calls os._exit is retried in another worker process (a
   new CUDA context) and returns the same o. Printed: a fresh process's
   import of ray_tpu_torch, init() to the first result, a warm no-op GPU
   task's round trip, a fresh worker's CUDA context start and its card
   memory (nvidia-smi's memory.used before and after), and a 256 MiB CUDA
   tensor put here, got in a worker and moved onto the card, put there and
   got and moved back here, in GB/s each step.
25. [cluster-trainer]: TorchTrainer(..., ScalingConfig(num_workers=1,
   use_gpu=True)).fit() on that cluster trains GPT-2-124M at B 24 x 1024
   in a worker process: run E straight to step 8, its losses falling and
   within [trainer]'s resume limit of [trainer]'s straight run C, its
   final Checkpoint.from_torch (written in the worker) restored here by
   to_torch bitwise against the state the worker saved; run F under
   FailureConfig(max_failures=1), its worker process exiting (os._exit)
   right after its step-2 checkpoint, retried from it in a new process;
   12 launches of each kernel a step counted in the workers. Prints each
   fit's set-up, first step and teardown seconds and the steady step ms
   beside [trainer]'s and [train]'s. With 2 to 4 cards, then two
   @remote(num_gpus=1) tasks at once on different cards (each lease names
   its card, which the worker makes its CUDA_VISIBLE_DEVICES) and
   TorchTrainer(num_workers=2, use_gpu=True) over dp 2 (NCCL, a card a
   worker) held to the world-1 mesh step as the fsdp plan is; with one
   card each says that the run did not take place.
26. [data-train] on that cluster: TorchTrainer(datasets={"train": ds},
   num_workers=1, use_gpu=True) trains GPT-2-124M at B 24 x 1024 for 12
   steps in a worker process, its batches from get_dataset_shard("train")
   .iter_batches(batch_size=24, device="cuda", drop_last=True) over a
   Dataset of the 12 synthetic_batch(cfg, 24, seed=i) batches as 288 rows
   (tokens, targets; int32). Its 12 losses equal, in every bit, the same
   step fed the same numpy batches here; 144 launches of each kernel in
   the worker. Prints the steady step beside [cluster-trainer]'s, the
   fit's set-up and each step's wait for its batch.
27. [data-serve] on that cluster: a Dataset of [main]'s 4 requests (32
   rows of 1024 tokens and an id) through BatchPredictor.from_checkpoint(
   ckpt, TorchPredictor, apply_fn=<[main]'s>, device="cuda").predict(ds,
   batch_size=8, num_workers=1, keep_columns=("id",)) on one GPU actor:
   next_token and logit equal [main]'s answers in every bit, 48 flash_fwd
   and 0 flash_bwd launches in the actor. Prints ms a batch beside [main]'s
   request, rows/s, the checkpoint's bytes, its put here and the actor's
   start to its first answer.
28. [rllib-remote] on that cluster: PPO at BASELINE config 2 with 2 CPU
   EnvRunner actors (8 envs each) and the learner on the card, to
   [rllib-ppo]'s target within its step budget, iterations and env-steps/s
   beside [rllib-ppo]'s inline run; learner_mode="remote" (a PPO learner on
   a num_gpus=1 actor): one update on a fixed batch equal to the local
   learner's on the card in every bit (metrics and weights), its ms;
   IMPALA's asynchronous loop with 2 workers at the reference test's
   settings (Pong-v0, 4 envs, fragments of 32, 4 updates an iteration),
   held to that test's checks, env-steps/s and the learner's updates/s;
   DQN and SAC with 2 sampling workers, 3 iterations each, updates/s.
29. [collective] on that cluster: two GPT-2-124M (full width, remat off)
   actors at num_gpus=0.5 on the one card (CUDA_VISIBLE_DEVICES naming it
   once in each, the same card uuid), a world-2 util.collective group.
   Rank 0 broadcasts its flat f32 parameters (0.5 GB) to rank 1, which
   started from other weights; then 3 data-parallel steps, each rank the
   loss and gradients of its half (12 x 1024) of [train]'s B 24 batch on
   both flash kernels, the flat f32 gradient to the host, allreduced as
   "mean" over the ring, back to the card, then ClippedAdamW. The ranks'
   parameters must be bitwise equal (blake2b of their bytes) after the
   broadcast and after every step; step 1's mean loss and averaged
   gradient within COLLECTIVE_LOSS_TOL and COLLECTIVE_GRAD_REL_TOL of the
   whole batch's in one process (rank 0, same weights, before step 1);
   each actor 12 launches of each kernel a step. Prints the broadcast's
   and each allreduce's ms and bus GB/s (2(W-1)/W x bytes over the time)
   and each step's compute, device-to-host, ring, host-to-device and
   optimizer ms by rank.
30. [actor-pool] on that cluster: two TorchPredictor actors at
   num_gpus=0.5 ([main]'s weights from the same seeded generator on their
   card) in a util.ActorPool; a CPU task puts [main]'s 4 request batches
   into a util.queue.Queue, this process takes them in order and sends
   them through pool.map: next_token and logit equal [main]'s in every
   bit, in order; pool.map_unordered gives the same set; flash_fwd 12 a
   request over the actors, flash_bwd 0. Prints each request's ms beside
   [main]'s, rows/s (from the requests after each actor's first) and the
   launches by actor.
31. [stream] from the pool's first actor: a method called with
   num_returns="streaming" and generator_backpressure_num_objects=1
   yields [main]'s 4 answers one by one, each equal to [main]'s in every
   bit; then one item of a 256 MiB CUDA tensor, which arrives its host
   copy (as every CUDA tensor crossing processes, core/serialization.py)
   and, moved onto the card here, equals the same seeded bytes made here
   (GB/s to the host and to the card printed); then a
   stream that raises at item 3: items 0-2 arrive equal, get on item 3
   re-raises the producer's error, and the stream ends. Prints the time to
   the first item and to the last. Then shutdown(): no process the
   cluster spawned is left in /proc.
32. [multi-node]: a cluster of two nodes on this host, each in a shm
   session of its own (cluster_utils.Cluster, add_node(session=...)), so
   objects cross between them through the pull manager: the head
   (num_cpus 2, num_gpus 0; this driver's node) and a GPU node (num_cpus 2,
   num_gpus 1, GPU-<kind>). nodes() lists both, GPU only on the GPU node; a
   num_gpus=1 task from the head runs there, the head raylet counting the
   spillback. [main]'s checkpoint (GPT-2-124M's f32 parameters, 0.5 GB) is
   put here; a num_gpus=1 TorchPredictor actor takes the ref as its
   constructor argument, and the GPU node's raylet pulls it by the chunked
   rung (its bytes_in covers the checkpoint, no other rung taken). The
   actor answers [main]'s 4 requests equal to [main]'s in every bit, with
   48 flash_fwd and 0 flash_bwd launches. Prints the pull's seconds and
   GB/s, the actor's start to its first answer, each request's ms beside
   [main]'s.
33. [multi-node-lineage]: a num_gpus=1, max_retries=2 task on the GPU node
   takes GPT-2-124M's loss and gradients of one B 8 x 1024 batch on both
   flash kernels and returns the flat f32 gradient as a CUDA tensor
   (0.5 GB), which reaches this process as its host copy, pulled by the
   head's raylet (chunked); moved to the card it equals the same
   computation done here in every bit. The same object's bytes fetched
   straight from the GPU node's sendfile daemon (native.fetch_to_file)
   equal the pulled copy's. Then the head drops its pulled copy
   (free_objects), the GPU node's raylet is SIGKILLed and the object's
   file removed from its session; a new GPU node joins, and get rebuilds
   the gradient through lineage there, equal in every bit. 12 launches of
   each kernel in each of the two workers. Prints the first and the
   rebuilt get's seconds and how long the death took to be seen.
34. [client]: a ClientServer here; a subprocess driver that imports only
   ray_tpu_torch calls init("ray://...") and sends one num_gpus=1 task,
   [main]'s first request: its answer equals [main]'s in every bit, 12
   flash_fwd in the task's worker on the GPU node. Then shutdown(): no
   process the cluster spawned is left in /proc, neither one of the killed
   node's nor an rt_transfer daemon.
35. [pipelined]: a one-node cluster of its own, started with
   RAY_TPU_SANITIZE=1 (every daemon and worker sanitized),
   worker_requeue_after_ms pinned at 5000 and a 500 ms metrics period.
   GPT-2-124M's parameters (from [main]'s seeded generator) are put once;
   a @remote(num_gpus=0.5) request task gets them once per worker process
   and keeps a TorchPredictor (two GPU workers share the card). A pair of
   requests at worker_max_tasks_in_flight=1 meets at a barrier, so both
   workers load; then 24 of [main]'s B 8 requests at once, pipelined: every
   answer equal to [main]'s in every bit, some lease carrying 2 to
   worker_max_tasks_in_flight specs at once (counted at the owner), 12
   flash_fwd a request; the same 24 again at depth 1 (a contrast, each
   lease one spec). Then a blocker request holds its run slot in a 3 s
   sleep after its forward, and 12 requests submitted behind it answer
   equal, within 1.5 s: the owner stole specs off the blocked worker (the
   requeue bound cannot act in that time) and the workers count the
   steals. Prints both bursts' wall time and requests/s and the stolen
   requests' time beside the blocker's.
36. [observe] on that cluster: a request submitted under
   deadline_context(now - 0.1) raises DeadlineExceededError and never
   reaches a worker (its task events end FAILED with no DISPATCHED or
   RUNNING; both workers' flash_fwd counts equal the launches of the
   requests that ran); a request under a 30 s deadline sees
   remaining_time_s() in (0, 30]. timeline() is written to
   build/observe_timeline.json: one FINISHED row per request, each
   request's profile_span("forward") inside its task's RUNNING slice on
   the same worker row; summarize_tasks() counts every request FINISHED
   and the shed one FAILED; the GCS's task_e2e_ms histogram counts every
   request. No lock-order or affinity violation in this driver
   (sanitizers.violation_counts) or in the daemons and workers
   (sanitizer_violations_total in the merged series, less this driver's).
   Prints metric_percentile("task_e2e_ms", 0.5) beside the host clock's
   median of the pipelined burst, and the forward's span beside its
   CUDA-event time. Then shutdown(): no process of the cluster left.
37. Print the kernels line (each kernel's numbers by model path), the card's
   name and power limit, and last the result line {"ok": true, ...}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

# kernel vs plain version, both bf16 on the card: o is rounded to bf16 (one
# step is 2**-7 near 1) and p is rounded to bf16 against the running max in
# the kernel but against the row max in the plain version, so o may differ
# by a few bf16 steps; lse is f32 and differs only by summation order and
# the fast exp (relative ~1e-6, |lse| < 20).
O_TOL = 2e-2
LSE_TOL = 1e-3
# main path: flash kernel vs the plain "xla" attention path of the same
# model. That path rounds the logits to bf16 before the softmax (as the JAX
# model's does), which moves each probability by up to 2**-8 relative, so
# the two differ by more than the kernel does from its own plain version.
LOGITS_MAX_TOL = 0.125
LOGITS_MEAN_TOL = 1e-2
# backward kernel vs its plain version, both bf16 on the card, for dq, dk
# and dv, relative to each reference's max-abs: both round p and ds to
# bf16, but the kernel's p comes from its own f32 logits (another summation
# order, the fast exp), so an entry near a rounding edge falls one bf16
# step (2**-8 relative) the other way; dq is summed by bulk reduce-adds
# in an order of its own (fixed: the kernel repeats every bit).
GRAD_REL_TOL = 2e-2
# backward kernel vs its plain version (which rounds where the TPU kernel
# rounds), mean |difference| over mean |reference| per gradient: with the
# same rounding points only entries near a bf16 rounding edge fall the other
# way, a step each (measured on an H100: 2e-6 to 6e-6), while a moved
# rounding point or a small error anywhere in the sums moves most entries
# (the scale applied to f32 sums instead of to q and k at hd 128: 2.7e-3 to
# 3.2e-3).
MEAN_REL_TOL = 1e-4
# [ring]: ring attention's gradients against the whole-sequence backward
# kernel, mean |difference| over mean |reference|. The ring rounds each
# chunk pair's dq, dk and dv to bf16 before its f32 sum (as the
# reference's ring does), the whole kernel rounds once, so most entries
# move by up to cp bf16 half-steps of their parts (cp 4, measured on an
# H100: 1.00e-3 to 1.63e-3 at GPT-2-124M's and llama_1b's attention, the
# max rel_err 5.3e-3, inside GRAD_REL_TOL; the CPU's plain versions give
# the same). The tight check is the same schedule on the plain versions,
# held to MEAN_REL_TOL (measured on an H100: 2.5e-6 to 5.3e-6).
RING_WHOLE_MEAN_REL_TOL = 4e-3
RING_CP = 4
# training path, flash kernels vs the plain "xla" attention path of the
# same model and batch: the loss (about 11.0) and each parameter's
# gradient relative to its max-abs. The plain path rounds the logits to
# bf16 before the softmax, which moves each probability by up to 2**-8
# relative, and the two sum in other orders (measured on an H100: loss
# 5e-5 apart, worst gradient 7.6e-3 relative).
LOSS_TOL = 1e-3
GRAD_PATH_REL_TOL = 2e-2
# the Llama paths against their plain "xla" path: llama_7b is 32 bf16
# layers at S 4096 whose attention logits reach about 8 (GPT-2-124M's stay
# near 1), where the plain path's bf16 rounding of the logits is a step of
# up to 2**-4 and moves a probability by up to 3 % relative. The smoke
# prints each path's distance from attention computed in f32 from the same
# bf16 q, k, v (f32_attention); measured on an H100: serving logits
# (|logits| up to 7.5) kernel 0.42 max / 0.053 mean, plain 0.66 / 0.073,
# so 0.64 / 0.074 between them; llama_7b's gradients at 2 layers, worst
# leaf relative to its max-abs, kernel 0.017, plain 0.031, 0.029 between
# them. The kernel path is the nearer one; the limits hold the distance
# between the two paths to about twice (logits) and three times
# (gradients) what was measured, and a kernel defect (a lost mask, a wrong
# scale or operand) moves it by O(1).
LLAMA_LOGITS_MAX_TOL = 1.5
LLAMA_LOGITS_MEAN_TOL = 0.15
LLAMA_GRAD_PATH_REL_TOL = 0.1

# the MoE paths against their plain attention path. Routing is discrete:
# bf16 noise between the two attention paths sends a near-tie choice to
# another expert, which moves that token's output by O(1), shifts the
# queue places (so the drops) of later tokens of that expert, and reaches
# later tokens through attention and later layers through the residual.
# Measured on an H100 (gpt2_124m(moe_experts=8), 12 layers; four runs):
# serving 8 x 1024 tokens, 35 of 16,384 decisions differ between the two
# paths in the first layer (0.21 %) and 4.8 % over all layers, and each
# path differs from attention computed in f32 as much as from the other
# (kernel 5.3 %, plain 5.0 %); in the B 8 gradient check after 8 training
# steps, 0.21-0.26 % in the first layer and 0.74-1.34 % in all (the
# trained state then differed from run to run: flash_bwd summed dq in a
# run-dependent order; its order is fixed now, and the phase repeats every
# number from run to run on one card). A kernel defect moves most decisions, the first
# layer's most of all. The free-running serving logits then differ by up
# to their own size at the tokens routed otherwise (max 3.41 with
# |logits| up to 3.52; mean 0.047, while kernel and plain are 0.052 and
# 0.048 from the f32 path), the B 8 loss by 1.2e-5 to 1.7e-4 and the
# worst gradient by 0.031 to 0.067 (kernel 0.037-0.061 and plain
# 0.033-0.048 from the f32 path). The limits below are about twice
# those. The tight check is the plain path run on the kernel path's
# routing, held to the dense GPT-2 limits (measured: logits 0.047 max,
# 0.0057 mean; worst gradient 0.0051-0.0087).
MOE_FIRST_LAYER_FLIP_SHARE_TOL = 0.01
MOE_FLIP_SHARE_TOL = 0.1
MOE_LOGITS_MAX_TOL = 7.0
MOE_LOGITS_MEAN_TOL = 0.1
MOE_LOSS_TOL = LOSS_TOL
MOE_GRAD_PATH_REL_TOL = 0.15
# moe_mlp against moe_mlp_plain on the same inputs, relative to the plain
# version's max-abs: both dispatch exact copies of the tokens and run the
# same expert products; the combine sums a token's k (= 2) products in f32
# in both, so y may differ by one bf16 step at most (2**-8); gradients
# reach the router through the gate's gradient, rounded to bf16 after
# products summed in other orders (GRAD_REL_TOL, as the kernels'); f32
# differs only by summation order. aux: the same f32 formula on the same
# routing (1e-6 relative).
MOE_Y_REL_TOL = {torch.bfloat16: 2 ** -8, torch.float32: 1e-5}
MOE_GRAD_REL_TOL = {torch.bfloat16: GRAD_REL_TOL, torch.float32: 1e-5}
MOE_AUX_REL_TOL = 1e-6
MOE_EXPERTS = 8

N_REQUESTS, REQUEST_BATCH = 4, 8
TRAIN_BATCH, TRAIN_STEPS, COMPARE_BATCH = 24, 8, 8
# [pipeline]: GPT-2-124M's 12 blocks as 4 stages of 3, the B 24 batch in 4
# microbatches
PIPELINE_STAGES, PIPELINE_MICROBATCHES = 4, 4
# llama_7b: requests of 2 x 4096 tokens; llama_1b: TinyLlama's per-GPU
# micro-batch of 8 x 2048 tokens, its gradients checked on one sequence
# (the plain path keeps [B, 32, 2048, 2048] probabilities per layer);
# llama_7b's hd-128 gradients checked at 2 of its 32 layers
LLAMA_REQUESTS, LLAMA_REQUEST_BATCH = 4, 2
LLAMA_TRAIN_BATCH, LLAMA_COMPARE_BATCH = 8, 1
LLAMA_GRAD_LAYERS = 2
# [core]: the remote task's attention at GPT-2-124M's serving shape, and the
# serialization hook on a 256 MiB CUDA tensor
CORE_SHAPE = (REQUEST_BATCH, 12, 1024, 64)
SERIALIZE_BYTES = 256 * 2 ** 20
# [trainer]: GPT-2-124M at TRAIN_BATCH through TorchTrainer: run A to step
# TRAINER_A, B from A's checkpoint to TRAINER_UNTIL, C, C2 and C3 straight
# to it, D checkpointed at TRAINER_D_CKPT and failing after its step
# TRAINER_D_FAIL on its first attempt, then retried from that checkpoint
TRAINER_A, TRAINER_UNTIL = 4, 8
TRAINER_D_CKPT, TRAINER_D_FAIL = 2, 3
# B's losses against C's at the same steps: B resumes from a checkpoint that
# restores A's state bitwise (checked), so B is C. The limit was set while
# dq's sums ran in a run-dependent order, the noise that set the straight
# runs apart; with that order fixed the runs repeat every bit and the limit
# is its floor. The limit is four times the largest distance between
# two of C, C2 and C3 over those steps, and at least LOSS_TOL (the loss
# distance the smoke allows between two attention paths). It grows with the
# step: on an H100 the runs were up to 2.7e-4 apart at step 5 and 1.2e-3 by
# step 8; B once sat 1.6e-3 from C there against C 4.7e-4 from C2, too close
# to a limit from one pair, hence three runs. A resume that lost the
# optimizer's count or moments would move each resumed loss by about a
# step's change (0.02 to 0.13 between steps 4 and 8).
TRAINER_RESUME_FACTOR = 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back calls (inputs warm in L2, as a layer's fresh q, k, v are)."""
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


def host_call_ms(fn, iters: int = 20) -> float:
    """Host time of one fn() call in ms, from the host clock around `iters`
    calls that are only enqueued (no synchronization): where it exceeds the
    device time, the card waits for the host."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters
    torch.cuda.synchronize()
    return host * 1e3


def visible_pairs(Sq, Skv, q_off, kv_off, causal) -> int:
    """(query, key) pairs this call's mask lets through: the work it needs."""
    if not causal:
        return Sq * Skv
    rows = q_off + torch.arange(Sq, dtype=torch.int64)
    return int((rows - kv_off + 1).clamp(0, Skv).sum())


def bound(nbytes: int, flops: int):
    """(bound ms, what bounds it, bytes, operations)."""
    t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations",
            nbytes, flops)


def kv_rows_needed(Sq, Skv, q_off, kv_off, causal) -> int:
    """The kv rows some query of this call sees: those past the last
    query's position are never needed under a causal mask."""
    if not causal:
        return Skv
    return max(0, min(Skv, q_off + Sq - kv_off))


def attention_bound(q, k, q_off, kv_off, causal):
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    kv = kv_rows_needed(Sq, Skv, q_off, kv_off, causal)
    # q and the k, v rows it sees read once; o (bf16) and lse (f32)
    # written once
    nbytes = 2 * B * H * (2 * Sq + 2 * kv) * hd + 4 * B * H * Sq
    # s = q.k^T and o = p.v: 2 products of 2 * hd operations per pair
    flops = 4 * hd * B * H * visible_pairs(Sq, Skv, q_off, kv_off, causal)
    return bound(nbytes, flops)


def attention_bwd_bound(q, k, q_off, kv_off, causal):
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    kv = kv_rows_needed(Sq, Skv, q_off, kv_off, causal)
    # q, o, do, the k, v rows the queries see (bf16) and lse (f32) read
    # once; dq, dk, dv written once (dk, dv over every kv row)
    nbytes = 2 * B * H * (4 * Sq + 2 * kv + 2 * Skv) * hd + 4 * B * H * Sq
    # s, dp, dv, dk, dq: 5 products of 2 * hd operations per visible pair
    flops = 10 * hd * B * H * visible_pairs(Sq, Skv, q_off, kv_off, causal)
    return bound(nbytes, flops)


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref| (at least 1e-3: a gradient that is 0
    in exact arithmetic is held in absolute terms)."""
    scale = max(ref.float().abs().max().item(), 1e-3)
    return (out.float() - ref.float()).abs().max().item() / scale


def mean_rel_err(out, ref) -> float:
    """mean |out - ref| over mean |ref|: small only if most entries agree."""
    scale = max(ref.float().abs().mean().item(), 1e-6)
    return (out.float() - ref.float()).abs().mean().item() / scale


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Phase 1: build
# --------------------------------------------------------------------------- #

def ptxas_report(log: str):
    """Per compiled entry function of a `-Xptxas -v` log: its template
    arguments, registers, static shared memory and spilled bytes."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:   # int and bool template arguments, in order
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            cur = dict(entry=m.group(1), template=args, registers=None,
                       smem_static=0, spill_stores=0, spill_loads=0)
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_static"] = int(m.group(1))
    return entries


def sass_highest_registers(lib: Path) -> dict:
    """Per entry function of a built library: the highest general register
    its SASS names (`R237`), from cuobjdump beside nvcc."""
    from ray_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    top, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            top[cur] = None
        elif cur is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                if top[cur] is None or int(r) > int(top[cur][1:]):
                    top[cur] = f"R{r}"
    return top


def build():
    from ray_tpu_torch.ops import _build, attention

    kernels = [attention.KERNEL, attention.BWD_KERNEL]
    t0 = time.perf_counter()
    _build.build_all(kernels)   # one nvcc per source, all started together
    log(f"[build] {', '.join(k + '.cu' for k in kernels)} built for sm_90a "
        f"in {time.perf_counter() - t0:.1f} s")
    smem_bytes = {name: getattr(_build.load(name), f"{name}_smem_bytes")
                  for name in kernels}
    spills = []
    for name in kernels:
        build_log = _build.build_log(name)
        if not ptxas_report(build_log):
            fail(f"no ptxas report for {name}.cu")
        top_reg = sass_highest_registers(_build._library_path(name))
        for line in build_log.splitlines():
            if "wgmma" in line or "warning" in line.lower():
                log(f"[build]   {name}: {line.strip()}")
        for e in ptxas_report(build_log):
            row = dict(kernel=name, template=e["template"],
                       registers=e["registers"], smem_static=e["smem_static"],
                       spill_stores=e["spill_stores"],
                       spill_loads=e["spill_loads"],
                       sass_highest_register=top_reg.get(e["entry"]))
            if f"{name}_kernelILi" in e["entry"]:   # the main kernel's <HD, ...>
                row["smem_dynamic"] = smem_bytes[name](*map(int, e["template"]))
            log(f"[build] {json.dumps(row)}")
            if e["spill_stores"] or e["spill_loads"]:
                spills.append(row)
    if spills:
        fail(f"ptxas spilled registers: {spills}")


# --------------------------------------------------------------------------- #
# Phase 2: kernel vs plain version
# --------------------------------------------------------------------------- #

def sdpa(q, k, v, causal):
    """SDPA's forward (the library yardstick; the port never calls it)."""
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)


def forward_case(name, q, k, v, q_off=0, kv_off=0, causal=True, library=None,
                 library_name="sdpa"):
    """flash_fwd against mha_forward_plain on the same inputs, timed; fails
    outside O_TOL / LSE_TOL. Returns (row, o, lse) of the kernel."""
    from ray_tpu_torch.ops import attention as A

    o, lse = A.mha_forward_kernel(q, k, v, q_off, kv_off, causal=causal)
    po, plse = A.mha_forward_plain(q, k, v, q_off, kv_off, causal=causal)
    torch.cuda.synchronize()
    o_err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    del po, plse
    ms = cuda_ms(lambda: A.mha_forward_kernel(q, k, v, q_off, kv_off,
                                              causal=causal))
    host_ms = host_call_ms(lambda: A.mha_forward_kernel(q, k, v, q_off, kv_off,
                                                        causal=causal))
    plain_ms = cuda_ms(lambda: A.mha_forward_plain(q, k, v, q_off, kv_off,
                                                   causal=causal), iters=5)
    library_ms = cuda_ms(library) if library else None
    bound_ms, bound_by, nbytes, flops = attention_bound(q, k, q_off, kv_off,
                                                        causal)
    row = dict(case=name, shape=list(q.shape), skv=k.shape[2], q_off=q_off,
               kv_off=kv_off, causal=causal, o_err=o_err, lse_err=lse_err,
               max_abs_err=max(o_err, lse_err),
               ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=library_ms, library=library_name if library else None,
               bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, bound_share=bound_ms / ms)
    log(f"[kernel] {json.dumps(row)}")
    if not (o_err <= O_TOL and lse_err <= LSE_TOL):
        fail(f"flash_fwd case {name}: |o| err {o_err} (tol {O_TOL}), "
             f"|lse| err {lse_err} (tol {LSE_TOL})")
    return row, o, lse


def attention_cases(gen):
    def rand(B, H, S, hd):
        return [torch.randn(B, H, S, hd, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(3)]

    check = forward_case
    rows = {}
    q, k, v = rand(8, 12, 1024, 64)
    rows["main"], full_o, _ = check("causal B8 H12 S1024 hd64", q, k, v,
                                    library=sdpa(q, k, v, True))
    rows["full"], _, _ = check("non-causal B8 H12 S1024 hd64", q, k, v,
                               causal=False, library=sdpa(q, k, v, False))
    qr, kr, vr = (x[:, :, :1000].contiguous() for x in (q, k, v))
    rows["ragged"], _, _ = check("ragged causal S1000", qr, kr, vr,
                                 library=sdpa(qr, kr, vr, True))

    # the second half of the queries against kv chunks at 0 and 512, merged
    # by lse, must give the second half of full causal attention
    qh = q[:, :, 512:].contiguous()
    parts = []
    for off in (0, 512):
        kc, vc = (x[:, :, off:off + 512].contiguous() for x in (k, v))
        row, o, lse = check(f"q@512 vs kv@{off}", qh, kc, vc, 512, off)
        rows[f"offsets{off}"] = row
        parts.append((o.float(), lse))
    (oa, la), (ob, lb) = parts
    m = torch.maximum(la, lb)
    wa, wb = torch.exp(la - m)[..., None], torch.exp(lb - m)[..., None]
    merged = (oa * wa + ob * wb) / (wa + wb)
    merge_err = (merged - full_o[:, :, 512:].float()).abs().max().item()
    log(f"[kernel] merged-by-lse vs full causal: max |err| {merge_err}")
    if not merge_err <= O_TOL:
        fail(f"lse merge differs from full attention by {merge_err}")

    row, o, lse = check("fully masked kv@10000", qh, kc, vc, 0, 10_000)
    rows["masked"] = row
    if not (torch.all(o == 0) and torch.all(lse == -1e30)):
        fail("fully masked chunk: o must be 0 and lse -1e30 everywhere")

    q8, k8, v8 = rand(8, 12, 1024, 128)
    rows["hd128"], _, _ = check("causal B8 H12 S1024 hd128", q8, k8, v8,
                                library=sdpa(q8, k8, v8, True))
    del q8, k8, v8
    ql, kl, vl = rand(LLAMA_REQUEST_BATCH, 32, 4096, 128)
    rows["llama_serve"], _, _ = check(
        f"causal B{LLAMA_REQUEST_BATCH} H32 S4096 hd128 (llama_7b serving shape)",
        ql, kl, vl, library=sdpa(ql, kl, vl, True))
    return rows


def compare_forward(src: str, gen):
    """Time the flash_fwd built from another source `src` (with the same C
    entry point, e.g. an earlier design unpacked from git history) against
    the one in ops/csrc/, in turns old, new, new, old, at the main paths'
    shapes; both are first held against the plain version."""
    from ray_tpu_torch.ops import _build, attention as A

    out = _build.BUILD_DIR / "libflash_fwd_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = A._entry(ctypes.CDLL(str(out)), "flash_fwd_bf16", 5)

    def old(q, k, v):
        o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
        B, H, S, hd = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, H, S, S, hd, 0, 0, hd ** -0.5, 1,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_fwd_bf16 (compared source)")
        return o, lse

    def new(q, k, v):
        return A.mha_forward_kernel(q, k, v)

    for B, hd in ((TRAIN_BATCH, 64), (REQUEST_BATCH, 64), (REQUEST_BATCH, 128)):
        q, k, v = (torch.randn(B, 12, 1024, hd, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        po, plse = A.mha_forward_plain(q, k, v)
        errs = {}
        for name, f in (("old", old), ("new", new)):
            o, lse = f(q, k, v)
            torch.cuda.synchronize()
            errs[name] = max((o.float() - po.float()).abs().max().item(),
                             (lse - plse).abs().max().item())
        ms = [cuda_ms(lambda f=f: f(q, k, v)) for f in (old, new, new, old)]
        row = dict(shape=[B, 12, 1024, hd], src=src, max_abs_err=errs,
                   old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]))
        log(f"[compare] {json.dumps(row)}")
        if not all(e <= O_TOL for e in errs.values()):
            fail(f"compared forward kernels disagree with the plain version: "
                 f"{errs}")


def sdpa_backward(q, k, v, do, causal):
    """SDPA's flash backward alone, on SDPA's own saved outputs (the
    library yardstick; the port never calls it)."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset, _ = (
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal))
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)


def backward_call(q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True, lib=None):
    """The backward's C call alone, on outputs and scratch allocated once:
    its three kernels (prologue, main kernel, dq's cast) without the
    wrapper's checks and allocations. `lib`: another build with the same C
    entry point (default: the one of ops/csrc/)."""
    from ray_tpu_torch.ops import _build, attention as A

    B, H, Sq, hd = q.shape
    current = _build.load(A.BWD_KERNEL)
    lib = lib or current
    scratch = torch.empty(A._scratch_bytes(current)(B * H, Sq, hd) // 4,
                          dtype=torch.float32, device="cuda")
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    fn = A._entry(lib, "flash_bwd_bf16", 10)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, *outs, scratch)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(*ptrs, B, H, Sq, k.shape[2], hd, q_off, kv_off,
                        hd ** -0.5, int(causal), stream), "flash_bwd_bf16")
        return outs
    call.scratch = scratch   # alive as long as the call: the kernel writes it
    return call


def compare_backward(src: str, gen):
    """Time the flash_bwd built from another source `src` with the same C
    entry point (e.g. an earlier design unpacked from git history) against
    the one in ops/csrc/, in turns old, new, new, old, at the training and
    serving shapes and at hd 128. Both are first held against the plain
    version, by max error (GRAD_REL_TOL; the old one must pass it) and by
    mean error (printed for both), and SDPA's flash backward is timed beside
    them."""
    from ray_tpu_torch.ops import _build, attention as A

    out = _build.BUILD_DIR / "libflash_bwd_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    # a header the source includes is looked up beside it, then in csrc/
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(out), src],
                           check=True, capture_output=True, text=True, timeout=600)
    spills = sum(e["spill_stores"] + e["spill_loads"]
                 for e in ptxas_report(built.stdout + built.stderr))
    lib = ctypes.CDLL(str(out))

    for B, hd in ((TRAIN_BATCH, 64), (REQUEST_BATCH, 64), (REQUEST_BATCH, 128)):
        q, k, v, do = (torch.randn(B, 12, 1024, hd, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = A.mha_forward_kernel(q, k, v)
        args = (q, k, v, o, lse, do)
        old, new = backward_call(*args, lib=lib), backward_call(*args)
        ref = A.mha_backward_plain(*args)
        errs, mean_errs = {}, {}
        for name, f in (("old", old), ("new", new)):
            got = f()
            torch.cuda.synchronize()
            errs[name] = {n: rel_err(a, b)
                          for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
            mean_errs[name] = {n: mean_rel_err(a, b)
                               for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        del ref
        ms = [cuda_ms(f) for f in (old, new, new, old)]
        row = dict(shape=[B, 12, 1024, hd], src=src, spill_bytes=spills,
                   rel_err=errs, mean_rel_err=mean_errs,
                   old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]),
                   sdpa_backward_ms=cuda_ms(sdpa_backward(q, k, v, do, True)))
        log(f"[compare-bwd] {json.dumps(row)}")
        if not all(e <= GRAD_REL_TOL for d in errs.values() for e in d.values()):
            fail(f"compared backward kernels disagree with the plain version: "
                 f"{errs}")


def backward_case(name, q, k, v, o, lse, do, q_off=0, kv_off=0, causal=True,
                  library=None, library_name="sdpa flash backward alone",
                  library_base=None):
    """flash_bwd against mha_backward_plain on the same inputs, timed (the
    wrapper and its C call alone); fails outside GRAD_REL_TOL and
    MEAN_REL_TOL, and where a call after the timed ones differs from the
    first in any bit of dq, dk or dv (dq's sum has a fixed order). The library's time is library()'s less library_base()'s
    where that is given (a forward and backward less the forward). Returns
    (row, (dq, dk, dv) of the kernel)."""
    from ray_tpu_torch.ops import attention as A

    args = (q, k, v, o, lse, do, q_off, kv_off)
    out = A.mha_backward_kernel(*args, causal=causal)
    ref = A.mha_backward_plain(*args, causal=causal)
    torch.cuda.synchronize()
    errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), out, ref)}
    max_abs = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(out, ref))
    mean_errs = {n: mean_rel_err(a, b)
                 for n, a, b in zip(("dq", "dk", "dv"), out, ref)}
    del ref
    ms = cuda_ms(lambda: A.mha_backward_kernel(*args, causal=causal))
    kernel_ms = cuda_ms(backward_call(*args, causal=causal))
    plain_ms = cuda_ms(lambda: A.mha_backward_plain(*args, causal=causal),
                       iters=3, warmup=1)
    library_ms = cuda_ms(library) if library else None
    if library and library_base:
        library_ms -= cuda_ms(library_base)
    again = A.mha_backward_kernel(*args, causal=causal)
    differs = [n for n, a, b in zip(("dq", "dk", "dv"), out, again)
               if not torch.equal(a, b)]
    del again
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound(
        q, k, q_off, kv_off, causal)
    row = dict(case=name, shape=list(q.shape), skv=k.shape[2], q_off=q_off,
               kv_off=kv_off, causal=causal, rel_err=errs,
               mean_rel_err=mean_errs, max_abs_err=max_abs,
               differs_from_run_to_run=differs,
               ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library=library_name if library else None,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, bound_share=bound_ms / ms)
    log(f"[kernel-bwd] {json.dumps(row)}")
    if not all(e <= GRAD_REL_TOL for e in errs.values()):
        fail(f"flash_bwd case {name}: relative errors {errs} "
             f"(tol {GRAD_REL_TOL})")
    if not all(e <= MEAN_REL_TOL for e in mean_errs.values()):
        fail(f"flash_bwd case {name}: mean relative errors {mean_errs} "
             f"(tol {MEAN_REL_TOL})")
    if differs:
        fail(f"flash_bwd case {name}: two calls on the same inputs differ in "
             f"{differs}")
    return row, out


def backward_cases(gen, plans=None):
    from ray_tpu_torch.ops import attention as A

    def rand(B, H, S, hd):
        return [torch.randn(B, H, S, hd, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    check = backward_case

    def forward(q, k, v, causal=True):
        return A.mha_forward_kernel(q, k, v, causal=causal)

    rows = {}
    q, k, v, do = rand(TRAIN_BATCH, 12, 1024, 64)
    # the training path's forward at its own shape, held and timed like the
    # serving shape's; its o and lse feed the backward cases
    rows["fwd_main"], o, lse = forward_case(
        f"causal B{TRAIN_BATCH} H12 S1024 hd64 (training shape)", q, k, v,
        library=sdpa(q, k, v, True))
    rows["main"], full = check(
        f"causal B{TRAIN_BATCH} H12 S1024 hd64 (training shape)",
        q, k, v, o, lse, do, library=sdpa_backward(q, k, v, do, True))
    # the [pipeline] path's microbatch: a quarter of the training batch
    mb = TRAIN_BATCH // PIPELINE_MICROBATCHES
    qm, km, vm, dm = (x[:mb].contiguous() for x in (q, k, v, do))
    name = f"causal B{mb} H12 S1024 hd64 (pipeline microbatch)"
    rows["fwd_pipeline"], om, lsem = forward_case(name, qm, km, vm,
                                                  library=sdpa(qm, km, vm, True))
    rows["pipeline"], _ = check(name, qm, km, vm, om, lsem, dm,
                                library=sdpa_backward(qm, km, vm, dm, True))
    del qm, km, vm, dm, om, lsem
    # a [collective] rank's half of the training batch
    half = TRAIN_BATCH // COLLECTIVE_WORLD
    qd, kd, vd, dd = (x[:half].contiguous() for x in (q, k, v, do))
    name = f"causal B{half} H12 S1024 hd64 ([collective] rank's half batch)"
    rows["fwd_collective"], od, lsed = forward_case(name, qd, kd, vd,
                                                    library=sdpa(qd, kd, vd, True))
    rows["collective"], _ = check(name, qd, kd, vd, od, lsed, dd,
                                  library=sdpa_backward(qd, kd, vd, dd, True))
    del qd, kd, vd, dd, od, lsed
    on, lsen = forward(q, k, v, causal=False)
    rows["full"], _ = check("non-causal", q, k, v, on, lsen, do, causal=False,
                            library=sdpa_backward(q, k, v, do, False))
    qr, kr, vr, dr = (x[:, :, :1000].contiguous() for x in (q, k, v, do))
    orr, lser = forward(qr, kr, vr)
    rows["ragged"], _ = check("ragged causal S1000", qr, kr, vr, orr, lser, dr,
                              library=sdpa_backward(qr, kr, vr, dr, True))

    # q rows [512, 1024) against kv chunks at 0 and 512 with the GLOBAL lse:
    # dq summed and dk, dv stacked equal the full backward of those rows
    d_tail = do.clone()
    d_tail[:, :, :512] = 0
    _, tail = check("full, do of rows < 512 zeroed", q, k, v, o, lse, d_tail)
    qh, oh, dh = (x[:, :, 512:].contiguous() for x in (q, o, do))
    lseh = lse[:, :, 512:].contiguous()
    parts = []
    for off in (0, 512):
        kc, vc = (x[:, :, off:off + 512].contiguous() for x in (k, v))
        row, out = check(f"q@512 vs kv@{off}, global lse", qh, kc, vc, oh, lseh,
                         dh, 512, off)
        rows[f"offsets{off}"] = row
        parts.append(out)
    sums = {"dq": rel_err(parts[0][0].float() + parts[1][0].float(),
                          tail[0][:, :, 512:]),
            "dk": rel_err(torch.cat([parts[0][1], parts[1][1]], 2), tail[1]),
            "dv": rel_err(torch.cat([parts[0][2], parts[1][2]], 2), tail[2])}
    log(f"[kernel-bwd] offset chunks summed vs full backward: {json.dumps(sums)}")
    if not all(e <= GRAD_REL_TOL for e in sums.values()):
        fail(f"offset chunks do not sum to the full backward: {sums}")

    # the [core] task's backward: GPT-2-124M's serving shape
    qc, kc, vc, dc = rand(*CORE_SHAPE)
    oc, lsec = forward(qc, kc, vc)
    rows["core"], _ = check(f"causal B{REQUEST_BATCH} H12 S1024 hd64 ([core] "
                            "task's shape)", qc, kc, vc, oc, lsec, dc,
                            library=sdpa_backward(qc, kc, vc, dc, True))
    del qc, kc, vc, dc, oc, lsec

    q8, k8, v8, d8 = rand(8, 12, 1024, 128)
    o8, lse8 = forward(q8, k8, v8)
    rows["hd128"], _ = check("causal B8 H12 S1024 hd128", q8, k8, v8, o8, lse8,
                             d8, library=sdpa_backward(q8, k8, v8, d8, True))
    del q, k, v, do, o, lse, q8, k8, v8, d8, o8, lse8, full, tail, parts

    # the Llama paths' shapes: llama_1b's training step (hd 64, 32 heads,
    # forward and backward) and llama_7b's hd-128 gradient check
    name = f"causal B{LLAMA_TRAIN_BATCH} H32 S2048 hd64 (llama_1b training shape)"
    q, k, v, do = rand(LLAMA_TRAIN_BATCH, 32, 2048, 64)
    rows["fwd_llama_train"], o, lse = forward_case(name, q, k, v,
                                                   library=sdpa(q, k, v, True))
    rows["llama_train"], _ = check(name, q, k, v, o, lse, do,
                                   library=sdpa_backward(q, k, v, do, True))
    del q, k, v, do, o, lse

    def rank_case(key, shape, kv, what):
        """Rows `key` and fwd_`key` at one rank's shape, its `kv` kv heads
        repeated in place to H as the model repeats them."""
        B, H, S, hd = shape
        name = (f"causal B{B} H{H} S{S} hd{hd} ({what}, one rank; its {kv} "
                f"kv heads repeated)")
        q, k, v, do = rand(*shape)
        k, v = (x[:, :kv].repeat_interleave(H // kv, dim=1).contiguous()
                for x in (k, v))
        rows[f"fwd_{key}"], o, lse = forward_case(name, q, k, v,
                                                  library=sdpa(q, k, v, True))
        rows[key], _ = check(name, q, k, v, o, lse, do,
                             library=sdpa_backward(q, k, v, do, True))

    # llama_1b over tp 2: 16 of the 32 heads, 4 of the 8 kv heads
    rank_case("llama_tp2", (LLAMA_TRAIN_BATCH, 16, 2048, 64), 4, "llama_1b over tp 2")
    # each multi-card run's rank (none on one card): rows rank_<plan> and
    # fwd_rank_<plan> at its shape; a shape that ran above shares its rows
    seen = {((LLAMA_TRAIN_BATCH, 16, 2048, 64), 4): "llama_tp2",
            ((mb, 12, 1024, 64), 12): "pipeline"}
    if plans is None:
        plans = multi_card_plans(torch.cuda.device_count())
    for plan in plans:
        if plan["mesh"].get("cp", 1) > 1:
            continue        # a ring's chunks: ring_phase's rows
        shape, kv = rank_attention_shape(plan)
        key = f"rank_{plan['name']}"
        if (shape, kv) not in seen:
            rank_case(key, shape, kv, f"{plan['config']} over {plan['mesh']}")
            seen[(shape, kv)] = key
        same = seen[(shape, kv)]
        rows[f"fwd_{key}"], rows[key] = rows[f"fwd_{same}"], rows[same]
    q, k, v, do = rand(1, 32, 4096, 128)
    o, lse = forward(q, k, v)
    rows["llama_hd128"], _ = check(
        "causal B1 H32 S4096 hd128 (llama_7b gradient check shape)",
        q, k, v, o, lse, do, library=sdpa_backward(q, k, v, do, True))
    return rows


# --------------------------------------------------------------------------- #
# [ring]: ring attention's schedule on the card
# --------------------------------------------------------------------------- #

def ring_launches(cp: int, causal: bool = True) -> int:
    """Each kernel's launches in one forward (or backward) of a virtual ring
    of cp chunks (ops/ring_attention.py): cp rank r launches r + 1 times
    under a causal mask (a kv chunk wholly in its future is skipped), cp
    times without."""
    return cp * (cp + 1) // 2 if causal else cp * cp


@contextmanager
def plain_ring():
    """Within, the ring's schedule runs on the kernels' plain versions, on
    the card too."""
    from ray_tpu_torch.ops import attention as A, ring_attention as R

    saved = R._mha_forward_bhsd, R._mha_backward_bhsd
    R._mha_forward_bhsd, R._mha_backward_bhsd = (A.mha_forward_plain,
                                                 A.mha_backward_plain)
    try:
        yield
    finally:
        R._mha_forward_bhsd, R._mha_backward_bhsd = saved


def ring_run(q, k, v, do, cp: int):
    """q, k, v [B, H, S, hd] as cp chunks through virtual_ring_attention,
    forward and backward with the gradient do: (o, (dq, dk, dv)), each put
    back together along S."""
    from ray_tpu_torch.ops.ring_attention import virtual_ring_attention

    chunks = [[c.contiguous().requires_grad_(True) for c in x.detach().chunk(cp, 2)]
              for x in (q, k, v)]
    out = virtual_ring_attention(*chunks)
    grads = torch.autograd.grad(out, [c for cs in chunks for c in cs],
                                [c.contiguous() for c in do.chunk(cp, 2)])
    return (torch.cat(out, 2).detach(),
            tuple(torch.cat(grads[i * cp:(i + 1) * cp], 2) for i in range(3)))


def ring_schedule(q, k, v, do, cp: int, outs=None, lses=None):
    """The ring's forward and backward schedules called directly (no
    autograd) over the virtual ring of cp chunks of q, k, v and do: the
    forward's (o, lse) by chunk, then the backward's (dq, dk, dv) joined
    along S, from `outs` and `lses` where given (else the forward's). On
    the kernels, or under plain_ring on the plain versions: given the
    kernels' outputs, the plain backward is held on the same inputs."""
    from ray_tpu_torch.ops import ring_attention as R

    ring, scale = R._VirtualRing(cp), q.shape[-1] ** -0.5
    qs, ks, vs, dos = ([c.contiguous() for c in x.detach().chunk(cp, 2)]
                       for x in (q, k, v, do))
    acc = R._ring_forward(ring, qs, ks, vs, True, scale)
    fwd = [(o.to(q.dtype), lse) for o, lse in acc]
    outs = outs or [o for o, _ in fwd]
    lses = lses or [lse for _, lse in fwd]
    grads = R._ring_backward(ring, qs, ks, vs, outs, lses, dos, True, scale)
    return fwd, tuple(torch.cat([g[i] for g in grads], 2) for i in range(3))


def ring_distance(o, grads, ref_o, ref_grads) -> dict:
    """o's max |difference| and each gradient's rel_err and mean_rel_err
    from a reference."""
    names = ("dq", "dk", "dv")
    return {"o": (o.float() - ref_o.float()).abs().max().item(),
            "rel": {n: rel_err(a, b) for n, a, b in zip(names, grads, ref_grads)},
            "mean": {n: mean_rel_err(a, b) for n, a, b in zip(names, grads, ref_grads)}}


def ring_chunk_rows(name: str, q, k, v, o, lse, do, cp: int) -> dict:
    """flash_fwd and flash_bwd at one ring chunk's shape [B, H, S/cp, hd]
    (forward_case, backward_case: held to the plain versions, timed beside
    the bound and SDPA), at each kind of offsets the ring gives them: a kv
    chunk wholly in the past (no mask), the diagonal chunk at the last
    rank's offset, and a chunk wholly in the causal future (which the ring
    skips; no library call computes it). The backward takes the GLOBAL lse
    of the whole sequence (`lse`). Rows fwd_<where> and <where>."""
    Sc = q.shape[2] // cp

    def chunk(x, i):
        return x[:, :, i * Sc:(i + 1) * Sc].contiguous()

    rows = {}
    for where, qi, ki in (("past", 1, 0), ("diagonal", cp - 1, cp - 1),
                          ("future", 0, 1)):
        qc, kc, vc, oc, lc, dc = (chunk(x, i) for x, i in (
            (q, qi), (k, ki), (v, ki), (o, qi), (lse, qi), (do, qi)))
        label = f"{name}, ring chunk {where}: q@{qi * Sc} kv@{ki * Sc}"
        causal_lib = {"past": False, "diagonal": True}.get(where)
        rows[f"fwd_{where}"], _, _ = forward_case(
            label, qc, kc, vc, qi * Sc, ki * Sc,
            library=None if causal_lib is None else sdpa(qc, kc, vc, causal_lib))
        rows[where], _ = backward_case(
            label + ", global lse", qc, kc, vc, oc, lc, dc, qi * Sc, ki * Sc,
            library=(None if causal_lib is None
                     else sdpa_backward(qc, kc, vc, dc, causal_lib)))
    return rows


def ring_case(card: str, name: str, shape, cp: int, gen) -> dict:
    """[ring] at one shape: q, k, v [B, H, S, hd] bf16 as cp chunks of S/cp
    through the virtual ring, forward and backward, launches counted
    (counts set to 0 just before, read just after) against ring_launches;
    held to the whole-sequence kernels (o within O_TOL, each gradient
    within GRAD_REL_TOL and RING_WHOLE_MEAN_REL_TOL) and to the same
    schedule on the plain versions (o within O_TOL and lse within LSE_TOL
    from q, k, v; each gradient within GRAD_REL_TOL and MEAN_REL_TOL from
    the kernels' outputs and lse: ring_schedule);
    timed beside the whole-sequence kernels; then ring_chunk_rows.
    Returns the launches and the rows."""
    from ray_tpu_torch.ops import attention as A

    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o_w, lse_w = A.mha_forward_kernel(q, k, v)
    g_w = A.mha_backward_kernel(q, k, v, o_w, lse_w, do)
    reset_launches()
    o, grads = ring_run(q, k, v, do, cp)
    torch.cuda.synchronize()
    launches = launches_since_reset()
    whole = ring_distance(o, grads, o_w, g_w)
    # the plain schedule's forward from q, k, v; its backward from the
    # kernels' outputs and lse, so that each half is held on the same
    # inputs (a bf16 step of o moves delta = rowsum(do·o), whose
    # difference with dp cancels)
    fwd, _ = ring_schedule(q, k, v, do, cp)
    outs, lses = [o_c for o_c, _ in fwd], [lse for _, lse in fwd]
    with plain_ring():
        fwd_p, g_p = ring_schedule(q, k, v, do, cp, outs, lses)
    plain = ring_distance(o, grads, torch.cat([o_c for o_c, _ in fwd_p], 2), g_p)
    plain["lse"] = max((a - b).abs().max().item()
                       for a, (_, b) in zip(lses, fwd_p))
    del fwd, fwd_p, g_p, outs, lses
    expected = ring_launches(cp)
    ms = cuda_ms(lambda: ring_run(q, k, v, do, cp), iters=5)
    whole_ms = cuda_ms(lambda: A.mha_backward_kernel(
        q, k, v, *A.mha_forward_kernel(q, k, v), do), iters=5)
    log("[ring] " + json.dumps(dict(
        card=card, case=name, shape=list(shape), cp=cp, launches=launches,
        expected_launches=expected, vs_whole_sequence=whole,
        vs_plain_schedule=plain, ring_fwd_bwd_ms=ms,
        whole_sequence_fwd_bwd_ms=whole_ms)))
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"ring {name}: launches {launches}, the formula says {expected} each")
    for against, dist_, mean_tol in (("the whole-sequence kernels", whole,
                                      RING_WHOLE_MEAN_REL_TOL),
                                     ("the plain schedule", plain, MEAN_REL_TOL)):
        if not (dist_["o"] <= O_TOL and dist_.get("lse", 0) <= LSE_TOL
                and all(e <= GRAD_REL_TOL for e in dist_["rel"].values())
                and all(e <= mean_tol for e in dist_["mean"].values())):
            fail(f"ring {name} disagrees with {against}: {dist_}")
    rows = ring_chunk_rows(name, q, k, v, o_w, lse_w, do, cp)
    return {"launches": launches, "rows": rows}


def ring_phase(card: str, gen, plans=None) -> dict:
    """[ring]: ring_case at GPT-2-124M's attention (B TRAIN_BATCH) and
    llama_1b's (B LLAMA_TRAIN_BATCH, 32 heads) at full width, RING_CP
    chunks; then the chunk rows at each multi-card cp
    plan's rank shape not already run. Returns each case by name, and the
    multi-card plans' diagonal rows as rank_<plan> / fwd_rank_<plan>."""
    out = {}
    for name, shape in (("gpt2_124m", (TRAIN_BATCH, 12, 1024, 64)),
                        ("llama_1b", (LLAMA_TRAIN_BATCH, 32, 2048, 64))):
        out[name] = ring_case(card, name, shape, RING_CP, gen)
        free_device_memory()
    seen = {((TRAIN_BATCH, 12, 1024 // RING_CP, 64), 12): out["gpt2_124m"]["rows"]}
    if plans is None:
        plans = multi_card_plans(torch.cuda.device_count())
    for plan in plans:
        cp = plan["mesh"].get("cp", 1)
        if cp == 1 or gathered_plan(plan):
            continue        # no ring; the gathered path's rows: [gathered]
        (B, H, Sc, hd), kv = rank_attention_shape(plan)
        if ((B, H, Sc, hd), kv) not in seen:
            from ray_tpu_torch.ops import attention as A

            q, k, v, do = (torch.randn(B, H, Sc * cp, hd, generator=gen,
                                       device="cuda", dtype=torch.bfloat16)
                           for _ in range(4))
            k, v = (x[:, :kv].repeat_interleave(H // kv, dim=1).contiguous()
                    for x in (k, v))
            o, lse = A.mha_forward_kernel(q, k, v)
            seen[((B, H, Sc, hd), kv)] = ring_chunk_rows(
                f"{plan['config']} over {plan['mesh']}, one rank", q, k, v,
                o, lse, do, cp)
            free_device_memory()
        rows = seen[((B, H, Sc, hd), kv)]
        out[f"fwd_rank_{plan['name']}"] = rows["fwd_diagonal"]
        out[f"rank_{plan['name']}"] = rows["diagonal"]
    return out


# --------------------------------------------------------------------------- #
# [gathered]: "pallas" attention under cp (k and v gathered) on the card
# --------------------------------------------------------------------------- #

GATHERED_CPS = (2, 4)
# the SDPA backends, in SDPA's own order of preference, tried one at a time
# for a call with an explicit mask: the first that takes it is the yardstick
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def gathered_launches(cp: int) -> int:
    """Each kernel's launches in one forward (or backward) of a virtual
    gathered attention over cp chunks (ops/gathered_attention.py): one a
    chunk, its queries against the whole sequence."""
    return cp


def group_sum(g, kv_heads: int):
    """[B, H, S, hd] gradients of kv heads repeated in place to H → their
    sums over each group, [B, KH, S, hd], as the repeat's backward sums
    them (in g's dtype)."""
    B, H, S, hd = g.shape
    return g.view(B, kv_heads, H // kv_heads, S, hd).sum(2)


def gathered_run(q, k, v, do, cp: int):
    """q [B, H, S, hd], k and v [B, KH, S, hd] as cp chunks through
    virtual_gathered_attention ("pallas"), forward and backward with the
    gradient do: (o, (dq, dk, dv)), each put back together along S."""
    from ray_tpu_torch.ops.gathered_attention import virtual_gathered_attention

    chunks = [[c.contiguous().requires_grad_(True) for c in x.detach().chunk(cp, 2)]
              for x in (q, k, v)]
    out = virtual_gathered_attention(*chunks, impl="pallas")
    grads = torch.autograd.grad(out, [c for cs in chunks for c in cs],
                                [c.contiguous() for c in do.chunk(cp, 2)])
    return (torch.cat(out, 2).detach(),
            tuple(torch.cat(grads[i * cp:(i + 1) * cp], 2) for i in range(3)))


def gathered_schedule(q, k, v, do, cp: int, outs=None, lses=None, plain=False):
    """The gathered path's kernel calls made directly (no autograd): each
    chunk's queries against the whole k and v (repeated to H) at the
    chunk's offset, forward (o, lse by chunk), then backward from `outs`
    and `lses` where given (else the forward's), the chunks' dk and dv
    summed over each kv group in the input dtype, then over the chunks in
    f32 and cast once, as the path rounds them. On the kernels, or with
    `plain` on the plain versions. Returns (the forward's (o, lse) by
    chunk, (dq, dk, dv) joined)."""
    from ray_tpu_torch.ops import attention as A

    fwd_fn, bwd_fn = ((A.mha_forward_plain, A.mha_backward_plain) if plain
                      else (A.mha_forward_kernel, A.mha_backward_kernel))
    H, S, KH = q.shape[1], q.shape[2], k.shape[1]
    Sc = S // cp
    kr, vr = (x.repeat_interleave(H // KH, dim=1).contiguous() for x in (k, v))
    qs, dos = ([c.contiguous() for c in x.detach().chunk(cp, 2)] for x in (q, do))
    fwd = [fwd_fn(qs[r], kr, vr, r * Sc, 0) for r in range(cp)]
    outs = outs or [o for o, _ in fwd]
    lses = lses or [lse for _, lse in fwd]
    dq, dk, dv = [], 0, 0
    for r in range(cp):
        g = bwd_fn(qs[r], kr, vr, outs[r], lses[r], dos[r], r * Sc, 0)
        dq.append(g[0])
        dk = dk + group_sum(g[1], KH).float()
        dv = dv + group_sum(g[2], KH).float()
    return fwd, (torch.cat(dq, 2), dk.to(k.dtype), dv.to(v.dtype))


def sdpa_masked(q, k, v, q_off: int, backward_do=None):
    """SDPA with an explicit boolean mask of the causal rows q_off.. against
    keys 0.. (is_causal aligns its mask top-left, which is wrong where
    Sq != Skv), on the first backend of SDPA_BACKENDS that takes it: (the
    forward call, the backend's name), or with `backward_do` (the forward
    and backward call, the forward call, the name). The library yardstick;
    the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    Sq, Skv = q.shape[2], k.shape[2]
    rows = q_off + torch.arange(Sq, device=q.device)[:, None]
    mask = rows >= torch.arange(Skv, device=q.device)[None, :]
    grad = backward_do is not None
    qg, kg, vg = (x.detach().requires_grad_(grad) for x in (q, k, v))
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)

        def fwd(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        def fwd_bwd(fwd=fwd):
            return torch.autograd.grad(fwd(), (qg, kg, vg), backward_do)
        try:
            (fwd_bwd if grad else fwd)()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (fwd_bwd, fwd, name) if grad else (fwd, name)
    fail("no SDPA backend takes an explicit mask")


def gathered_chunk_rows(name: str, q, k, v, o, lse, do, cp: int) -> dict:
    """flash_fwd and flash_bwd at each chunk's shape on the gathered path,
    q [B, H, S/cp, hd] at offset r·S/cp against the whole k and v
    [B, H, S, hd] (forward_case, backward_case: held to the plain versions,
    timed beside the bound and SDPA with the explicit mask; the backward
    from the whole sequence's o and lse, which are the chunk's). Rows
    fwd_q@<offset> and q@<offset>."""
    Sc = q.shape[2] // cp
    rows = {}
    for r in range(cp):
        qc, oc, lc, dc = (x[:, :, r * Sc:(r + 1) * Sc].contiguous()
                          for x in (q, o, lse, do))
        label = f"{name}, gathered cp {cp}: q@{r * Sc} (S/cp {Sc}) vs kv@0 (S {q.shape[2]})"
        fwd, lib = sdpa_masked(qc, k, v, r * Sc)
        rows[f"fwd_q@{r * Sc}"], _, _ = forward_case(
            label, qc, k, v, r * Sc, 0, library=fwd,
            library_name=f"sdpa {lib}, explicit mask")
        fwd_bwd, fwd, lib = sdpa_masked(qc, k, v, r * Sc, backward_do=dc)
        rows[f"q@{r * Sc}"], _ = backward_case(
            label, qc, k, v, oc, lc, dc, r * Sc, 0, library=fwd_bwd,
            library_base=fwd,
            library_name=f"sdpa {lib}, explicit mask: forward + backward less forward")
    return rows


def gathered_case(card: str, name: str, shape, kv_heads: int, cp: int, gen) -> dict:
    """[gathered] at one shape and cp: q [B, H, S, hd], k and v
    [B, KH, S, hd] bf16 as cp chunks through the virtual gathered path
    ("pallas"), forward and backward, launches counted (counts set to 0
    just before, read just after) against gathered_launches; held to the
    whole-sequence kernels (k and v repeated to H, dk and dv summed over
    each kv group: o within O_TOL, each gradient within GRAD_REL_TOL and
    RING_WHOLE_MEAN_REL_TOL, [ring]'s basis: each chunk's dk and dv round
    to bf16 before their f32 sum) and to the same calls on the plain
    versions (gathered_schedule: o within O_TOL and lse within LSE_TOL from
    q, k, v; each gradient within GRAD_REL_TOL and MEAN_REL_TOL from the
    kernels' outputs and lse); timed beside the whole-sequence kernels;
    then gathered_chunk_rows. Returns the launches and the rows."""
    from ray_tpu_torch.ops import attention as A

    B, H, S, hd = shape
    q, do = (torch.randn(*shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, kv_heads, S, hd, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    kr, vr = (x.repeat_interleave(H // kv_heads, dim=1).contiguous() for x in (k, v))
    o_w, lse_w = A.mha_forward_kernel(q, kr, vr)
    dq_w, dk_w, dv_w = A.mha_backward_kernel(q, kr, vr, o_w, lse_w, do)
    g_w = (dq_w, group_sum(dk_w, kv_heads), group_sum(dv_w, kv_heads))
    del dq_w, dk_w, dv_w
    reset_launches()
    o, grads = gathered_run(q, k, v, do, cp)
    torch.cuda.synchronize()
    launches = launches_since_reset()
    whole = ring_distance(o, grads, o_w, g_w)
    fwd, _ = gathered_schedule(q, k, v, do, cp)
    outs, lses = [o_c for o_c, _ in fwd], [lse for _, lse in fwd]
    fwd_p, g_p = gathered_schedule(q, k, v, do, cp, outs, lses, plain=True)
    plain = ring_distance(o, grads, torch.cat([o_c for o_c, _ in fwd_p], 2), g_p)
    plain["lse"] = max((a - b).abs().max().item()
                       for a, (_, b) in zip(lses, fwd_p))
    del fwd, fwd_p, g_p, outs, lses, g_w
    expected = gathered_launches(cp)
    ms = cuda_ms(lambda: gathered_run(q, k, v, do, cp), iters=5)
    whole_ms = cuda_ms(lambda: A.mha_backward_kernel(
        q, kr, vr, *A.mha_forward_kernel(q, kr, vr), do), iters=5)
    log("[gathered] " + json.dumps(dict(
        card=card, case=name, shape=list(shape), kv_heads=kv_heads, cp=cp,
        launches=launches, expected_launches=expected,
        vs_whole_sequence=whole, vs_plain_versions=plain,
        gathered_fwd_bwd_ms=ms, whole_sequence_fwd_bwd_ms=whole_ms)))
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"gathered {name} cp {cp}: launches {launches}, the formula "
             f"says {expected} each")
    for against, dist_, mean_tol in (("the whole-sequence kernels", whole,
                                      RING_WHOLE_MEAN_REL_TOL),
                                     ("the plain versions", plain, MEAN_REL_TOL)):
        if not (dist_["o"] <= O_TOL and dist_.get("lse", 0) <= LSE_TOL
                and all(e <= GRAD_REL_TOL for e in dist_["rel"].values())
                and all(e <= mean_tol for e in dist_["mean"].values())):
            fail(f"gathered {name} cp {cp} disagrees with {against}: {dist_}")
    rows = gathered_chunk_rows(name, q, kr, vr, o_w, lse_w, do, cp)
    return {"launches": launches, "rows": rows}


# [gathered]'s shapes: (name, [B, H, S, hd], kv heads, the cps run)
GATHERED_SHAPES = (
    ("gpt2_124m", (TRAIN_BATCH, 12, 1024, 64), 12, GATHERED_CPS),
    ("llama_1b", (LLAMA_TRAIN_BATCH, 32, 2048, 64), 8, GATHERED_CPS),
    # hd 128 (llama_7b's width, its gradient check's sequence): the
    # kernels' other tiling at Sq != Skv
    ("llama_7b", (1, 32, 4096, 128), 32, (2,)),
)


def gathered_phase(card: str, gen) -> dict:
    """[gathered]: gathered_case at each of GATHERED_SHAPES and its cps.
    Returns each case by "<name>_cp<cp>"."""
    out = {}
    for name, shape, kv, cps in GATHERED_SHAPES:
        for cp in cps:
            out[f"{name}_cp{cp}"] = gathered_case(card, name, shape, kv, cp, gen)
            free_device_memory()
    return out


# --------------------------------------------------------------------------- #
# Phases 3 to 7: the model paths
# --------------------------------------------------------------------------- #

def reset_launches() -> None:
    from ray_tpu_torch.ops import attention as A

    A.mha_forward_kernel.launches = 0
    A.mha_backward_kernel.launches = 0


def launches_since_reset() -> dict:
    from ray_tpu_torch.ops import attention as A

    return {"flash_fwd": A.mha_forward_kernel.launches,
            "flash_bwd": A.mha_backward_kernel.launches}


@contextmanager
def f32_attention(model):
    """Within the block, `model`'s attention (models.gpt2 or models.llama)
    is computed in f32 from its bf16 q, k and v (k and v repeated to q's
    heads as the model repeats them): a reference nearer exact arithmetic
    than either the kernel or the plain path, to measure each against. The
    port never runs it."""
    def attention(q, k, v, cfg):
        groups = q.shape[1] // k.shape[1]
        k, v = (x.repeat_interleave(groups, dim=1) for x in (k, v))
        S = q.shape[2]
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return (p @ v.float()).to(q.dtype)

    kept, model._attention = model._attention, attention
    try:
        yield
    finally:
        model._attention = kept


def is_moe(cfg) -> bool:
    return getattr(cfg, "moe_experts", 0) > 0


@contextmanager
def recorded_routing(model, sink: list):
    """Within the block, each call of `model`'s MoE layer (models.gpt2)
    appends its routing (an ops.moe.Routing, by ops.moe.route on the
    layer's own inputs) to `sink`; the layer runs unchanged."""
    from ray_tpu_torch.ops import moe

    layer = model.moe_mlp

    def recording(x, params, *, top_k, capacity_factor, dtype):
        T = x.shape[0] * x.shape[1]
        C = moe.moe_capacity(T, params["router_w"].shape[-1], top_k,
                             capacity_factor)
        with torch.no_grad():
            sink.append(moe.route(x.detach().reshape(T, -1),
                                  params["router_w"].detach(), top_k, C))
        return layer(x, params, top_k=top_k, capacity_factor=capacity_factor,
                     dtype=dtype)

    model.moe_mlp = recording
    try:
        yield
    finally:
        model.moe_mlp = layer


@contextmanager
def routing_of(model, cfg, routing: dict, path):
    """recorded_routing into routing[path] for an MoE configuration and a
    named path, nothing otherwise."""
    if not is_moe(cfg) or path is None:
        yield
        return
    with recorded_routing(model, routing[path]):
        yield


@contextmanager
def forced_routing(recorded: list):
    """Within the block, the MoE layers of successive calls take their
    discrete decisions (expert, queue place, kept) from `recorded`, a run's
    routing in layer order, instead of from their own router; probabilities
    and gates are still computed from the layer's inputs, so gradients
    flow as usual. Two attention paths compared on one routing differ by
    their attention alone."""
    from ray_tpu_torch.ops import moe

    own, decisions = moe.route, iter(recorded)

    def route(xt, router_w, top_k, capacity):
        r = next(decisions)
        probs = moe.router_probs(xt, router_w)
        gate = moe._renormalise(probs.gather(1, r.expert))
        return moe.Routing(probs, gate, r.expert, r.pos, r.keep)

    moe.route = route
    try:
        yield
    finally:
        moe.route = own


def routing_flips(a: list, b: list) -> dict:
    """The (token, choice) routing decisions of two runs of one MoE model
    (per layer, routings with .expert and .keep [T, k], as recorded_routing
    gives them) that differ: in the expert chosen, and in whether the
    choice was kept or dropped; in all and layer by layer."""
    if len(a) != len(b) or not a:
        fail(f"routing recorded for {len(a)} and {len(b)} layers")
    experts = [int((ra.expert != rb.expert).sum()) for ra, rb in zip(a, b)]
    drops = [int((ra.keep != rb.keep).sum()) for ra, rb in zip(a, b)]
    return {
        "decisions": sum(r.expert.numel() for r in a),
        "expert_differs": sum(experts), "drop_differs": sum(drops),
        "expert_differs_by_layer": experts, "drop_differs_by_layer": drops,
        "dropped": sum(int((~r.keep).sum()) for r in a),
    }


def report_routing(tag: str, routing: dict) -> dict:
    """Print the routing decisions that differ between the kernel, plain
    and f32-attention paths; returns those between kernel and plain."""
    for path in ("kernel", "plain"):
        log(f"[{tag}] routing, {path} path vs attention in f32: "
            f"{json.dumps(routing_flips(routing[path], routing['f32']))}")
    flips = routing_flips(routing["kernel"], routing["plain"])
    log(f"[{tag}] routing, kernel path vs plain path: {json.dumps(flips)}")
    return flips


def check_flips(tag: str, flips: dict) -> None:
    share = max(flips["expert_differs"], flips["drop_differs"]) / flips["decisions"]
    per_layer = flips["decisions"] / len(flips["expert_differs_by_layer"])
    first = max(flips["expert_differs_by_layer"][0],
                flips["drop_differs_by_layer"][0]) / per_layer
    log(f"[{tag}] share of routing decisions that differ between the kernel "
        f"and plain paths: {share} (tol {MOE_FLIP_SHARE_TOL}), first layer "
        f"{first} (tol {MOE_FIRST_LAYER_FLIP_SHARE_TOL})")
    if not (share <= MOE_FLIP_SHARE_TOL
            and first <= MOE_FIRST_LAYER_FLIP_SHARE_TOL):
        fail(f"{tag}: the MoE routing of the kernel and plain paths differs "
             f"in {share} of its decisions, {first} in the first layer")


def executed_flops_per_token(model, cfg, num_tokens: int) -> float:
    """Training FLOPs per token that the card executes: 6 per parameter a
    token's work runs through, plus the attention term, as
    model.flops_per_token counts them, except that an MoE layer runs its
    E x C capacity slots per T tokens, filled or empty (about k x the
    capacity factor experts a token), where flops_per_token (the JAX
    formula) counts all E experts for every token."""
    if not is_moe(cfg):
        return model.flops_per_token(cfg)
    from ray_tpu_torch.ops import moe

    n = model.param_count(cfg)
    attention = model.flops_per_token(cfg) - 6.0 * n
    E, D, F_ = cfg.moe_experts, cfg.d_model, cfg.d_ff
    one_expert = cfg.n_layer * (2 * D * F_ + F_ + D)   # fc and out, all layers
    C = moe.moe_capacity(num_tokens, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    slots_per_token = E * C / num_tokens
    return 6.0 * (n - E * one_expert + slots_per_token * one_expert) + attention


def moe_case(x, params, dy, dtype, capacity_factor, top_k=2) -> dict:
    """moe_mlp against moe_mlp_plain on the same inputs: routing decision
    for decision, y, aux and the gradients of sum(y * dy) + aux with
    respect to x and every parameter; two calls of moe_mlp bitwise equal;
    both timed, forward (no grad) and forward + backward."""
    from ray_tpu_torch.ops import moe

    B, S, D = x.shape
    T = B * S
    E = params["router_w"].shape[-1]
    C = moe.moe_capacity(T, E, top_k, capacity_factor)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, dtype=dtype)
    with torch.no_grad():
        r = moe.route(x.reshape(T, D), params["router_w"], top_k, C)
        rp = moe.route_plain(x.reshape(T, D), params["router_w"], top_k, C)[0]
    same_routing = {n: torch.equal(getattr(r, n), getattr(rp, n))
                    for n in ("expert", "pos", "keep")}
    dropped = 1.0 - r.keep.float().mean().item()

    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    xg = x.detach().clone().requires_grad_(True)

    def fwd_bwd(fn):
        for t in (xg, *leaves.values()):
            t.grad = None
        y, aux = fn(xg, leaves, **kw)
        ((y.float() * dy).sum() + aux).backward()
        return y.detach(), aux.detach(), {"x": xg.grad, **{
            n: v.grad for n, v in leaves.items()}}

    y, aux, g = fwd_bwd(moe.moe_mlp)
    y2, aux2, g2 = fwd_bwd(moe.moe_mlp)
    bitwise = (torch.equal(y, y2) and torch.equal(aux, aux2)
               and all(torch.equal(g[n], g2[n]) for n in g))
    del y2, aux2, g2
    yp, auxp, gp = fwd_bwd(moe.moe_mlp_plain)
    torch.cuda.synchronize()
    y_err = rel_err(y, yp)
    aux_err = abs(aux.item() - auxp.item()) / abs(auxp.item())
    grad_errs = {n: rel_err(g[n], gp[n]) for n in g}
    del yp, gp

    def forward(fn):
        def call():
            with torch.no_grad():
                return fn(x, params, **kw)
        return call

    times = {
        "ms": cuda_ms(forward(moe.moe_mlp), iters=10),
        "plain_ms": cuda_ms(forward(moe.moe_mlp_plain), iters=5, warmup=1),
        "fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(moe.moe_mlp), iters=10),
        "plain_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(moe.moe_mlp_plain), iters=5,
                                    warmup=1),
    }
    F_ = params["fc_w"].shape[-1]
    expert_flops = 4 * E * C * D * F_       # the two expert products, forward
    row = dict(dtype=str(dtype).replace("torch.", ""), tokens=T, experts=E,
               top_k=top_k, capacity_factor=capacity_factor, capacity=C,
               slots_per_token=E * C / T, dropped_share=dropped,
               same_routing=same_routing, bitwise_repeatable=bitwise,
               y_rel_err=y_err, aux_rel_err=aux_err, grad_rel_err=grad_errs,
               expert_product_flops=expert_flops, **times)
    log(f"[moe] {json.dumps(row)}")
    y_tol, grad_tol = MOE_Y_REL_TOL[dtype], MOE_GRAD_REL_TOL[dtype]
    if not all(same_routing.values()):
        fail(f"moe_mlp routes otherwise than moe_mlp_plain: {same_routing}")
    if not bitwise:
        fail("two calls of moe_mlp differ")
    if not (y_err <= y_tol and aux_err <= MOE_AUX_REL_TOL
            and all(e <= grad_tol for e in grad_errs.values())):
        fail(f"moe_mlp disagrees with moe_mlp_plain: y {y_err} (tol {y_tol}), "
             f"aux {aux_err} (tol {MOE_AUX_REL_TOL}), gradients {grad_errs} "
             f"(tol {grad_tol})")
    return row


def moe_layer_cases(gen) -> list:
    """Phase [moe]: the MoE layer at GPT-2-124M's width with 8 experts, one
    request's tokens (REQUEST_BATCH x 1024), random weights at the init's
    scales with nonzero biases (so that the bias adds and the empty slots'
    outputs count), in bf16 and f32, at capacity factors 1.25 and 0.5."""
    from ray_tpu_torch.ops import moe

    D, F_ = 768, 3072
    params = {n: v[0] for n, v in moe.moe_init(gen, 1, D, F_, MOE_EXPERTS,
                                                device="cuda").items()}
    for n in ("fc_b", "out_b"):
        params[n] = 0.02 * torch.randn(params[n].shape, generator=gen,
                                       device="cuda")
    x = torch.randn(REQUEST_BATCH, 1024, D, generator=gen, device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    rows = []
    for cf in (1.25, 0.5):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(moe_case(x.to(dtype), params, dy, dtype, cf))
    if not rows[-1]["dropped_share"] > 0:
        fail("capacity factor 0.5 dropped no choice")
    return rows


def free_device_memory() -> None:
    """Between paths: free what the last one left, so that each path's peak
    memory is its own."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def serve_apply_fn(model, cfg):
    """A serving path's apply_fn: each row's next token (the argmax of the
    last position's logits over the vocabulary) and that logit."""
    def apply_fn(params, batch):
        logits = model.forward(params, batch["tokens"], cfg)[:, -1, :cfg.vocab_size]
        best = logits.float().max(dim=-1)
        return {"next_token": best.indices, "logit": best.values}

    return apply_fn


def serve_path(card: str, profile: bool, tag: str, name: str, model, cfg,
               n_requests: int, batch: int, logits_tol,
               keep: Optional[dict] = None) -> int:
    """`model` (models.gpt2 or models.llama) at `cfg` with random weights from
    a seeded generator, in a Checkpoint served by a TorchPredictor that
    answers n_requests requests of batch x seq_len tokens. Launch counts are
    set to 0 just before and read just after: flash_fwd must have run once
    per layer per request, flash_bwd never. The logits of the first request
    are checked against the same weights through the plain attention path,
    within logits_tol = (max, mean); with MoE the routing decisions that
    differ between the two paths are counted and bounded. Returns
    flash_fwd's launches; `keep` (a dict) gets the answers and the median
    request ms after the first."""
    from ray_tpu_torch.train.batch_predictor import TorchPredictor
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.train_step import synthetic_batch

    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {name}: {model.param_count(cfg)} params, L={cfg.n_layer} "
        f"D={cfg.d_model} H={cfg.n_head} hd={cfg.d_model // cfg.n_head} "
        f"S={cfg.seq_len} vocab={cfg.padded_vocab}, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.2f} s")

    predictor = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}),
        apply_fn=serve_apply_fn(model, cfg), device="cuda")
    requests = [synthetic_batch(cfg, batch, seed=i)["tokens"]
                for i in range(n_requests)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    answers, times = [], []
    for tokens in requests:
        t = time.perf_counter()
        answers.append(predictor.predict({"tokens": tokens}))  # numpy: synced
        times.append(time.perf_counter() - t)
    launches = launches_since_reset()
    peak = torch.cuda.max_memory_allocated()

    expected = cfg.n_layer * n_requests
    log(f"[{tag}] flash_fwd launches: {launches['flash_fwd']} (expected "
        f"{expected}), flash_bwd {launches['flash_bwd']} (expected 0)")
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"{name} serving path launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    for ans in answers:
        tok, logit = ans["next_token"], ans["logit"]
        if tok.shape != (batch,) or not (
                (tok >= 0).all() and (tok < cfg.vocab_size).all()):
            fail(f"predictions out of range: {tok}")
        if not all(map(math.isfinite, logit.tolist())):
            fail(f"non-finite logits: {logit}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    if keep is not None:
        keep.update(answers=answers, request_ms=steady * 1e3)
    log(f"[{tag}] " + json.dumps(dict(
        card=card, model=name, requests=n_requests, batch=batch,
        seq_len=cfg.seq_len, request_ms=[t * 1e3 for t in times],
        median_after_first_ms=steady * 1e3,
        tokens_per_s=batch * cfg.seq_len / steady, peak_memory_bytes=peak,
        next_tokens=answers[0]["next_token"].tolist(),
    )))

    # the same weights and batch through the plain attention path
    toks = torch.as_tensor(requests[0], device="cuda")
    plain_cfg = replace(cfg, attention_impl="xla")
    routing = {"kernel": [], "plain": [], "f32": []}

    def logits(impl_cfg, path=None):
        with torch.inference_mode(), routing_of(model, cfg, routing, path):
            return model.forward(params, toks, impl_cfg).float()

    lk, lp = logits(cfg, "kernel"), logits(plain_cfg, "plain")
    with f32_attention(model):
        lf = logits(cfg, "f32")
    for path, out in (("kernel", lk), ("plain", lp)):
        d = (out - lf).abs()
        log(f"[{tag}] {path} path vs attention in f32: max |err| "
            f"{d.max().item()}, mean |err| {d.mean().item()}")
    del lf, d
    checks = [("plain attention path", lp, logits_tol)]
    if is_moe(cfg):
        flips = report_routing(tag, routing)
        with forced_routing(routing["kernel"]):
            checks.append(("plain attention path on the kernel path's routing",
                           logits(plain_cfg), (LOGITS_MAX_TOL, LOGITS_MEAN_TOL)))
    failed = []
    for what, ref, (max_tol, mean_tol) in checks:
        diff = (lk - ref).abs()
        agree = (lk[:, :, :cfg.vocab_size].argmax(-1)
                 == ref[:, :, :cfg.vocab_size].argmax(-1)).float().mean().item()
        log(f"[{tag}] logits vs {what}: max |err| {diff.max().item()} (tol "
            f"{max_tol}), mean |err| {diff.mean().item()} (tol {mean_tol}), "
            f"|logits| max {ref.abs().max().item()}, argmax agreement {agree}")
        if not (torch.isfinite(lk).all() and diff.max().item() <= max_tol
                and diff.mean().item() <= mean_tol):
            failed.append(what)
    del lk, lp, checks, diff
    if is_moe(cfg):
        check_flips(tag, flips)
    if failed:
        fail(f"{name} serving logits disagree with the {failed}")

    if profile:
        profile_device_time(f"one {name} request",
                            lambda: predictor.predict({"tokens": requests[0]}))
    return launches["flash_fwd"]


_CATEGORIES = (        # kernel name fragment -> category, first match wins
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd", "flash_bwd (prologue, main kernel, dq cast)"),
    ("nvjet", "matrix products (cuBLAS)"), ("gemm", "matrix products (cuBLAS)"),
    ("index", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("gather", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("scatter", "indexing (MoE dispatch and combine, embedding lookup)"),
    ("sort", "MoE routing (sort, scan)"), ("scan", "MoE routing (sort, scan)"),
    ("nccl", "collectives (NCCL)"),
    ("reduce_kernel", "reductions"), ("copy", "copies and casts"),
    ("elementwise", "other elementwise"),
)


def profile_device_time(what: str, fn, top: int = 12):
    """Device time of one call of fn by kernel name and by category
    (torch.profiler); fn ends in a synchronization."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    # kernels only: an operator's row repeats the device time of its
    # kernels, and a user annotation (Optimizer.step) spans kernels too
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    total = sum(e.self_device_time_total for e in events)
    log(f"[profile] {what}: wall {wall * 1e3:.3f} ms, device busy "
        f"{total / 1e3:.3f} ms ({100 * total / 1e6 / wall:.1f}% of wall)")
    by_category = {}
    for e in events:
        name = e.key.lower()
        cat = next((c for frag, c in _CATEGORIES if frag in name), "other")
        by_category[cat] = by_category.get(cat, 0) + e.self_device_time_total
    for cat, us in sorted(by_category.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {us / 1e3:9.3f} ms {100 * us / max(total, 1):5.1f}% "
            f"{cat}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")


def compare_gradients(tag: str, model, cfg, params, batch, grad_tol,
                      loss_tol=LOSS_TOL) -> None:
    """The loss and every parameter's gradient of one batch, flash kernels
    against the plain attention path of the same model, within loss_tol and
    grad_tol of each leaf's max-abs; with MoE the routing decisions that
    differ between the two paths are counted and bounded."""
    from ray_tpu_torch.train.train_step import named_leaves, param_leaves

    leaves = param_leaves(params)
    names = [name for name, _ in named_leaves(params)]
    routing = {"kernel": [], "plain": [], "f32": []}
    plain_cfg = replace(cfg, attention_impl="xla")

    def loss_and_grads(impl_cfg, path=None):
        with routing_of(model, cfg, routing, path):
            loss = model.loss_fn(params, batch["tokens"], batch["targets"],
                                 impl_cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    lk, gk = loss_and_grads(cfg, "kernel")
    lp, gp = loss_and_grads(plain_cfg, "plain")
    with f32_attention(model):
        lf, gf = loss_and_grads(cfg, "f32")
    for path, loss, grads in (("kernel", lk, gk), ("plain", lp, gp)):
        errs = {n: rel_err(a, b) for n, a, b in zip(names, grads, gf)}
        far = max(errs, key=errs.get)
        log(f"[{tag}] {path} path vs attention in f32: loss {loss} vs {lf}, "
            f"worst gradient {far} {errs[far]}")
    del gf
    checks = [("plain attention path", lp, gp, loss_tol, grad_tol)]
    if is_moe(cfg):
        flips = report_routing(tag, routing)
        with forced_routing(routing["kernel"]):
            checks.append(("plain attention path on the kernel path's routing",
                           *loss_and_grads(plain_cfg), LOSS_TOL,
                           GRAD_PATH_REL_TOL))
    failed = []
    for what, loss, grads, l_tol, g_tol in checks:
        by_leaf = {n: rel_err(a, b) for n, a, b in zip(names, gk, grads)}
        worst = max(by_leaf, key=by_leaf.get)
        log(f"[{tag}] B{len(batch['tokens'])} vs {what}: loss flash {lk} vs "
            f"{loss} (tol {l_tol}); gradient relative errors "
            f"{json.dumps(by_leaf)}, worst {worst} {by_leaf[worst]} (tol "
            f"{g_tol})")
        if not (abs(lk - loss) <= l_tol and by_leaf[worst] <= g_tol):
            failed.append(what)
    if is_moe(cfg):
        check_flips(tag, flips)
    if failed:
        fail(f"{tag}: loss or gradients disagree with the {failed}")


def train_path(card: str, profile: bool, tag: str, name: str, model,
               make_train_step, cfg, batch: int, compare_batch: int,
               grad_tol: float, loss_tol: float = LOSS_TOL) -> dict:
    """make_train_step(cfg, device="cuda") (remat as cfg says), one warm-up
    step, then TRAIN_STEPS steps on one repeated synthetic batch of
    batch x seq_len tokens. Launch counts are set to 0 just before the
    steps and read just after: flash_fwd and flash_bwd must each have run
    once per layer per step. Loss and grad norm must be finite and the loss
    must fall. The share of 989 TFLOP/s is printed from the work the card
    executes and from the JAX formula (flops_per_token; the two differ only
    with MoE). Then the loss and gradients of one compare_batch batch are
    checked against the plain attention path (loss_tol, grad_tol). Returns
    the launches and the median step ms."""
    from ray_tpu_torch.train.train_step import default_optimizer, synthetic_batch

    t0 = time.perf_counter()
    bundle = make_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = {k: torch.as_tensor(v, device="cuda")   # device-resident batch
              for k, v in synthetic_batch(cfg, batch, seed=0).items()}
    state = bundle.state
    state, _ = bundle.step_fn(state, tokens)         # warm-up step
    torch.cuda.synchronize()
    log(f"[{tag}] {name} B={batch} S={cfg.seq_len} remat={cfg.remat}; init "
        f"and warm-up step {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = bundle.step_fn(state, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    launches = launches_since_reset()
    peak = torch.cuda.max_memory_allocated()

    expected = cfg.n_layer * TRAIN_STEPS
    log(f"[{tag}] launches: {json.dumps(launches)} (expected {expected} each)")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"{name} training path launched {launches}, expected {expected} each")
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    if not all(map(math.isfinite, losses + norms)):
        fail(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_s = sorted(times)[len(times) // 2]
    tokens_per_s = batch * cfg.seq_len / step_s
    executed = executed_flops_per_token(model, cfg, batch * cfg.seq_len)
    log(f"[{tag}] " + json.dumps(dict(
        card=card, model=name, batch=batch, seq_len=cfg.seq_len,
        steps=TRAIN_STEPS, loss=losses, grad_norm=norms,
        step_ms=[t * 1e3 for t in times], step_ms_median=step_s * 1e3,
        tokens_per_s=tokens_per_s, peak_memory_bytes=peak,
        executed_flops_per_token=executed,
        share_of_989_tflops_executed=executed * tokens_per_s / PEAK_BF16_FLOPS,
        jax_formula_flops_per_token=model.flops_per_token(cfg),
        share_of_989_tflops_jax_formula=model.flops_per_token(cfg)
        * tokens_per_s / PEAK_BF16_FLOPS,
    )))
    if profile:
        def one_step():
            bundle.step_fn(state, tokens)
            torch.cuda.synchronize()
        profile_device_time(f"one {name} training step", one_step, top=16)

    compare_gradients(tag, model, cfg, state["params"],
                      synthetic_batch(cfg, compare_batch, seed=1), grad_tol,
                      loss_tol)
    return {"launches": launches, "step_ms_median": step_s * 1e3}


def llama_hd128_gradients() -> None:
    """The hd-128 backward inside a model: llama_7b at full width and
    sequence, cut to LLAMA_GRAD_LAYERS layers, one sequence; loss and every
    gradient, flash kernels against the plain attention path. The kernel
    path launches each kernel once per layer, the plain path none."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.train_step import param_leaves, synthetic_batch

    cfg = llama.llama_7b(n_layer=LLAMA_GRAD_LAYERS)
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    for p in param_leaves(params):
        p.requires_grad_(True)
    log(f"[llama-hd128] llama_7b cut to {cfg.n_layer} of 32 layers, full width "
        f"(D={cfg.d_model} H={cfg.n_head} hd={cfg.head_dim}), S={cfg.seq_len}, "
        f"B=1")
    reset_launches()
    compare_gradients("llama-hd128", llama, cfg, params,
                      synthetic_batch(cfg, 1, seed=2), LLAMA_GRAD_PATH_REL_TOL)
    launches = launches_since_reset()
    expected = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    log(f"[llama-hd128] launches: {json.dumps(launches)} (expected "
        f"{json.dumps(expected)})")
    if launches != expected:
        fail(f"hd-128 gradient check launched {launches}, expected {expected}")


# --------------------------------------------------------------------------- #
# Phase 11: [parallel] the meshed train step and the local pipeline
# --------------------------------------------------------------------------- #

# the meshed step at world 1 against the plain step, from the same initial
# parameters and batch: the same kernels and products on the same rows,
# the collectives on groups of one (copies). The forward is the same, so
# the first step's loss may differ only where the MoE aux loss takes its
# means as global sums over the global count (1e-6 relative; measured 0).
# These limits were set while flash_bwd summed dq in a run-dependent order
# (fixed since: two plain steps now repeat every bit). The bf16 backward
# carried that order on, so two plain steps from the same parameters and
# batch differed in the grad norm
# (GPT-2-124M and its MoE at B 24 on an H100: 9.1e-6 to 1.6e-4 relative)
# and in each gradient by up to 1.2e-2 of its max-abs; the phase prints
# that spread beside the mesh path's distance (measured: grad norm 1.3e-5
# to 6.2e-5, worst gradient 1.1e-2). The grad norm is held to 1e-3 and
# each gradient to the
# dense limit GRAD_PATH_REL_TOL: a gradient counted twice or lost moves
# its leaf by O(1). (The parameters after Adam's first step are not
# compared: it moves each weight by about lr·sign(g), so a near-zero
# gradient whose sign the dq order flips moves its weight by 2·lr on
# either path alike.) llama_1b's 22 layers at B 8 x 2048 carry the dq
# order further: two plain steps differ in some leaf by 1.7e-2 to 1.9e-2
# of its max-abs (H100, two runs), the mesh path from the plain one by
# 1.8e-2, so [parallel-tp] holds each gradient to twice that spread.
MESH_LOSS_REL_TOL = 1e-6
MESH_NORM_REL_TOL = 1e-3
# a multi-card MoE plan against its world-1 step: the bf16 activations
# that reach the router are rounded otherwise (the ring's chunks, the
# rows split over fsdp), which sends near-tie choices to other experts and
# moves the drops of later tokens ([moe-train]: 1 % of decisions between
# two attention paths, gradients up to 0.10 of a leaf's max-abs apart).
# Measured on four H100 80GB HBM3 cards at 700 W (gpt2_124m(moe_experts=8)
# over fsdp2·cp2 at B 24): loss 5.8e-5 from world 1, grad norm 2.7e-3
# relative, where the dense plans stay within 2.6e-4. The loss keeps
# LOSS_TOL; the grad norm is held to about four times what was measured.
MOE_MESH_NORM_REL_TOL = 1e-2
LLAMA_MESH_GRAD_REL_TOL = 4e-2
MULTI_CARD_MAX = 4


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_run(make_train_step, cfg, batch, device, steps: int,
              mesh=None, profile: str = "") -> dict:
    """make_train_step(cfg) on `device`, over `mesh` when given, from the
    parameters a generator seeded 0 draws, on one repeated batch: the
    first step's loss and grad norm and each parameter's gradient in it
    (this rank's shard), then `steps` more steps' losses, grad norms and
    times (host clock around a synchronized step); the kernel launches
    and the collectives by mesh axis of all the steps (counts reset just
    before the first). With `profile`, then one more step's device time
    by kernel under that name."""
    from ray_tpu_torch.parallel.mesh import collectives
    from ray_tpu_torch.train.train_step import default_optimizer, named_leaves

    bundle = make_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device=device).manual_seed(0),
        device=device, mesh=mesh)
    reset_launches()
    collectives.clear()
    state, m = bundle.step_fn(bundle.state, batch)
    shards = state["opt_state"].param_groups[0]["params"]
    run = {"first": {k: v.item() for k, v in m.items()},
           "grads": {n: p.grad.detach().clone() for (n, _), p
                     in zip(named_leaves(state["params"]), shards)},
           "loss": [], "grad_norm": [], "step_ms": []}
    for _ in range(steps):
        t = time.perf_counter()
        state, m = bundle.step_fn(state, batch)
        sync(device)
        run["step_ms"].append((time.perf_counter() - t) * 1e3)
        run["loss"].append(m["loss"].item())
        run["grad_norm"].append(m["grad_norm"].item())
    run["launches"] = launches_since_reset()
    run["collectives"] = dict(collectives)
    if profile:
        def one_step():
            bundle.step_fn(state, batch)
            sync(device)
        profile_device_time(f"one {profile} step", one_step, top=16)
    return run


def tp_collectives_per_step(model, cfg) -> int:
    """The collectives over tp that one meshed train step runs (dense or
    MoE blocks, the fused loss, pp 1; PERF.md §6): in the forward the
    vocab-parallel embedding's sum, a row-parallel sum out of attention
    and out of the MLP (or the experts) in each layer, the cross-entropy's
    max and its [Σexp, target logit] sum; in the backward a column-parallel
    input's gradient sum into attention and into the MLP in each layer and
    into the LM head; then in the step one sum of squares for the norm for
    each distinct set of mesh axes that shards a leaf split over tp, and a
    broadcast over tp of each leaf every tp rank holds whole. A
    checkpointed dense block (remat True) recomputes its forward in the
    backward only as far as the last tensor it saved, so the sum out of
    attention runs again and the MLP's, which ends the block, does not."""
    from ray_tpu_torch.parallel.sharding import partition_spec
    from ray_tpu_torch.train.train_step import named_leaves

    per_layer = 4 + (1 if cfg.remat else 0)
    keys, whole = set(), 0
    for _, axes in named_leaves(model.logical_axes(cfg)):
        mesh_axes = frozenset(a for t in partition_spec(axes) if t is not None
                              for a in ((t,) if isinstance(t, str) else t))
        if "tp" in mesh_axes:
            keys.add(mesh_axes)
        else:
            whole += 1
    return per_layer * cfg.n_layer + 1 + 1 + 2 + len(keys) + whole


def blocks_per_step(model, cfg, pp: int = 1) -> int:
    """The blocks one rank runs in a step: every layer, or in a GPT-2
    pipeline over pp its stage's L/pp layers for each microbatch (Llama
    runs no pipeline: pp is a replica axis)."""
    from ray_tpu_torch.models import gpt2

    if pp > 1 and model is gpt2:
        return cfg.n_layer // pp * (cfg.pipeline_microbatches or pp)
    return cfg.n_layer


def launches_per_step(model, cfg, cp: int, cp_rank: int, pp: int = 1) -> int:
    """Each kernel's launches on one rank of a mesh in a step (on the card):
    one a block it runs, or on a ring cp_rank + 1 (a kv chunk wholly in
    the causal future is skipped); "xla" launches none."""
    from ray_tpu_torch.models.common import attention_path

    if cfg.attention_impl == "xla":
        return 0
    ring = attention_path(cfg.attention_impl, cp) == "ring"
    return blocks_per_step(model, cfg, pp) * (cp_rank + 1 if ring else 1)


def cp_collectives_per_step(model, cfg, cp: int, pp: int = 1) -> int:
    """The collectives over cp that one meshed train step runs on a rank
    (PERF.md §6): in each block it runs (blocks_per_step), the ring's
    rotations, cp − 1 forward and cp backward (none on a cp group of one,
    where a rotation moves nothing), or on the gathered path ("pallas" and
    "xla" under a mesh, ops/gathered_attention.py) one all-gather of k and
    v forward and one reduce-scatter of dk and dv backward, on a group of
    one too; the attention's forward collectives once more for a
    checkpointed block (remat True or "dots"), which runs again; an MoE
    block's queue all-gather and its load-balancing loss's two sums (no
    smoke path runs MoE blocks with remat); then a gradient sum over cp for
    every leaf (each rank holds every parameter whole over cp), and the
    sums of the count of targets and of the loss."""
    from ray_tpu_torch.models.common import attention_path
    from ray_tpu_torch.train.train_step import named_leaves

    path = attention_path(cfg.attention_impl, cp)
    if path == "ring":
        fwd, bwd = (0, 0) if cp == 1 else (cp - 1, cp)
    elif path == "gathered":
        fwd, bwd = 1, 1
    else:
        fwd, bwd = 0, 0
    per_block = fwd * (2 if cfg.remat else 1) + bwd + (3 if is_moe(cfg) else 0)
    leaves = len(list(named_leaves(model.logical_axes(cfg))))
    return per_block * blocks_per_step(model, cfg, pp) + leaves + 2


def first_step_distance(a: dict, b: dict) -> dict:
    """How far run a's first step is from run b's: loss and grad norm
    relative to b's, each gradient by rel_err, the worst of them."""
    out = {k: abs(a["first"][k] - b["first"][k]) / abs(b["first"][k])
           for k in ("loss", "grad_norm")}
    by_leaf = {n: rel_err(a["grads"][n], g) for n, g in b["grads"].items()}
    worst = max(by_leaf, key=by_leaf.get)
    return {**out, "grads": by_leaf, "worst_grad": worst,
            "worst_grad_rel_err": by_leaf[worst]}


def check_mesh_against_plain(tag: str, plain: dict, meshed: dict,
                             grad_tol: float = GRAD_PATH_REL_TOL) -> dict:
    """The first step of a world-1 mesh run against the plain run's: loss
    within MESH_LOSS_REL_TOL relative, grad norm within MESH_NORM_REL_TOL,
    each gradient within grad_tol of its max-abs (rel_err).
    Returns the distances."""
    d = first_step_distance(meshed, plain)
    log(f"[{tag}] mesh vs plain, first step: "
        f"{json.dumps({'mesh': meshed['first'], 'plain': plain['first']})}; "
        f"relative errors loss {d['loss']} (tol {MESH_LOSS_REL_TOL}), grad "
        f"norm {d['grad_norm']} (tol {MESH_NORM_REL_TOL}); gradients "
        f"{json.dumps(d['grads'])}, worst {d['worst_grad']} "
        f"{d['worst_grad_rel_err']} (tol {grad_tol})")
    if not (d["loss"] <= MESH_LOSS_REL_TOL
            and d["grad_norm"] <= MESH_NORM_REL_TOL
            and d["worst_grad_rel_err"] <= grad_tol):
        fail(f"{tag}: the mesh step disagrees with the plain step: loss "
             f"{d['loss']}, grad norm {d['grad_norm']}, {d['worst_grad']} "
             f"{d['worst_grad_rel_err']}")
    return d


def pipeline_and_sequential(cfg, batch, device, stages: int,
                            microbatches: int, repeats: int = 3) -> dict:
    """GPT-2's blocks as a `stages`-stage GPipe pipeline in this process
    (pipeline_apply without a group, `microbatches` microbatches of the
    batch) against the same blocks one after another, from one seeded
    init: the loss (embedding, blocks, final LayerNorm, tied head, mean
    cross-entropy) and every gradient; the kernel launches of one
    pipelined forward and backward (counts reset just before); each path's
    median time over `repeats` (host clock around a synchronized forward
    and backward)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.common import layers
    from ray_tpu_torch.ops.cross_entropy import softmax_xent
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stages_from_layers
    from ray_tpu_torch.train.train_step import named_leaves, param_leaves

    params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    targets = torch.as_tensor(batch["targets"], device=device).long()
    dt = cfg.dtype

    def stage_fn(stage, h):
        for layer in layers(stage):
            h = gpt2._block(h, layer, cfg)
        return h

    def loss_and_grads(pipelined: bool):
        x = params["wte"].to(dt)[tokens] + params["wpe"][:tokens.shape[1]].to(dt)
        if pipelined:
            y = pipeline_apply(stage_fn, stages_from_layers(params["blocks"], stages),
                               x, num_stages=stages, num_microbatches=microbatches)
        else:
            y = stage_fn(params["blocks"], x)
        h = gpt2._layernorm(y, params["lnf_scale"], params["lnf_bias"])
        loss = softmax_xent(h @ params["wte"].to(dt).T, targets).sum()
        loss = loss / (targets >= 0).sum()
        return loss.item(), torch.autograd.grad(loss, leaves)

    reset_launches()
    lp, gp = loss_and_grads(True)
    launches = launches_since_reset()
    ls, gs = loss_and_grads(False)
    names = [n for n, _ in named_leaves(params)]
    by_leaf = {n: rel_err(a, b) for n, a, b in zip(names, gp, gs)}
    del gp, gs
    ms = {}
    for path in (True, False):
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            loss_and_grads(path)
            sync(device)
            times.append((time.perf_counter() - t) * 1e3)
        ms["pipeline" if path else "sequential"] = sorted(times)[len(times) // 2]
    worst = max(by_leaf, key=by_leaf.get)
    return {"loss": lp, "sequential_loss": ls, "worst_grad": worst,
            "worst_grad_rel_err": by_leaf[worst], "launches": launches,
            "ms": ms}


def peak_memory(device, less: int = 0):
    """Peak device memory in bytes less `less`; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() - less


def mesh_against_plain(card: str, tag: str, name: str, model, make_train_step,
                       cfg, batch_size: int, steps: int, mesh,
                       device="cuda", profile: bool = False,
                       grad_tol: float = GRAD_PATH_REL_TOL,
                       plain_cfg=None) -> dict:
    """The meshed step on `mesh` (world 1) against the plain step, from the
    same seeded parameters and one synthetic batch of batch_size x seq_len:
    plain and mesh 1 + `steps` steps each, then the plain step once more
    (its own run-to-run spread). The first step held by
    check_mesh_against_plain (each gradient within grad_tol); each kernel launched once per layer per step
    on the card (the plain versions on the CPU); the collectives over tp
    and cp as many as tp_collectives_per_step and cp_collectives_per_step
    say, the plain path none; with
    steps, the mesh path's loss finite and falling. Prints step ms,
    tokens/s and peak memory of both paths; with `profile`, one step of
    each by kernel (after the timed ones). The plain path runs `plain_cfg`
    where given (default cfg: a "ring" config needs a mesh). Returns the
    mesh run."""
    from ray_tpu_torch.train.train_step import synthetic_batch

    batch = {k: torch.as_tensor(v, device=device)
             for k, v in synthetic_batch(cfg, batch_size, seed=0).items()}
    runs, peak = {}, {}
    # "again": the plain step once more, for its own run-to-run spread
    for path, m, n in (("plain", None, steps), ("mesh", mesh, steps),
                       ("again", None, 0)):
        held = sum(g.numel() * g.element_size() for r in runs.values()
                   for g in r["grads"].values())   # earlier runs' grads
        what = f"{name} {path}" if profile and path != "again" else ""
        runs[path] = train_run(make_train_step, cfg if m else plain_cfg or cfg,
                               batch, device, n, m, what)
        peak[path] = peak_memory(device, held)
        free_device_memory()
    spread = first_step_distance(runs.pop("again"), runs["plain"])
    log(f"[{tag}] plain vs plain again, first step (the backward's "
        f"run-to-run spread): loss {spread['loss']}, grad norm "
        f"{spread['grad_norm']}, worst gradient {spread['worst_grad']} "
        f"{spread['worst_grad_rel_err']}")
    check_mesh_against_plain(tag, runs["plain"], runs["mesh"], grad_tol)
    log(f"[{tag}] peak memory bytes of each run (less the earlier "
        f"runs' gradients it holds): {json.dumps(peak)}")
    per_step = cfg.n_layer if torch.device(device).type == "cuda" else 0
    expected = per_step * (1 + steps)
    for path, run in runs.items():
        log(f"[{tag}] {path}: launches {json.dumps(run['launches'])} "
            f"(expected {expected} each), collectives by axis "
            f"{json.dumps(run['collectives'])}")
        if run["launches"] != {"flash_fwd": expected, "flash_bwd": expected}:
            fail(f"{tag} {path} path launched {run['launches']}, "
                 f"expected {expected} each")
    cp = mesh.size(mesh.mesh_dim_names.index("cp"))
    for axis, formula in (("tp", tp_collectives_per_step(model, cfg)),
                          ("cp", cp_collectives_per_step(model, cfg, cp))):
        got, want = runs["mesh"]["collectives"].get(axis, 0), formula * (1 + steps)
        log(f"[{tag}] collectives over {axis}: {got} in {1 + steps} steps "
            f"(the formula: {want})")
        if got != want or runs["plain"]["collectives"]:
            fail(f"{tag}: {got} collectives over {axis}, the formula says "
                 f"{want}; the plain path ran {runs['plain']['collectives']}")
    if steps:
        losses = runs["mesh"]["loss"]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f"{tag}: mesh path losses {losses}")
        med = {p: sorted(r["step_ms"])[steps // 2] for p, r in runs.items()}
        log(f"[{tag}] " + json.dumps(dict(
            card=card, model=name, mesh="world 1 (MeshSpec())",
            batch=batch_size, seq_len=cfg.seq_len, steps=steps,
            mesh_loss=losses, mesh_step_ms=runs["mesh"]["step_ms"],
            plain_step_ms=runs["plain"]["step_ms"],
            mesh_step_ms_median=med["mesh"], plain_step_ms_median=med["plain"],
            mesh_minus_plain_ms=med["mesh"] - med["plain"],
            mesh_tokens_per_s=batch_size * cfg.seq_len / med["mesh"] * 1e3,
            plain_tokens_per_s=batch_size * cfg.seq_len / med["plain"] * 1e3,
            mesh_peak_memory_bytes=peak["mesh"],
            plain_peak_memory_bytes=peak["plain"])))
    return runs["mesh"]


def remat_against_mesh(card: str, mesh, ref: dict, cfg, batch_size: int,
                       device="cuda") -> dict:
    """[parallel-tp] once more with each block checkpointed (cfg, a Llama
    config with remat True): one meshed step at batch_size. On the card the
    backward, and with it each block's rerun, runs on the autograd
    engine's own thread, and the rerun must run under the mesh: the
    collectives over tp as tp_collectives_per_step counts them with
    remat, each kernel once per layer and flash_fwd once more for the
    rerun (none off the card), the first step's loss and grad norm those
    of the run without remat (`ref`) within MESH_LOSS_REL_TOL and
    MESH_NORM_REL_TOL relative. Returns the launches."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.train_step import make_llama_train_step, synthetic_batch

    batch = {k: torch.as_tensor(v, device=device)
             for k, v in synthetic_batch(cfg, batch_size, seed=0).items()}
    run = train_run(make_llama_train_step, cfg, batch, device, 0, mesh)
    err = {k: abs(run["first"][k] - ref["first"][k]) / abs(ref["first"][k])
           for k in ("loss", "grad_norm")}
    per = cfg.n_layer if torch.device(device).type == "cuda" else 0
    expected = {"flash_fwd": 2 * per, "flash_bwd": per}
    tp, want = run["collectives"].get("tp", 0), tp_collectives_per_step(llama, cfg)
    log("[parallel-tp] remat True, one step: " + json.dumps(dict(
        card=card, batch=batch_size, first=run["first"],
        without_remat=ref["first"], rel_err=err, launches=run["launches"],
        expected_launches=expected, tp_collectives=tp, tp_formula=want)))
    if not (err["loss"] <= MESH_LOSS_REL_TOL and err["grad_norm"] <= MESH_NORM_REL_TOL):
        fail(f"parallel-tp remat step disagrees with the step without: {err}")
    if run["launches"] != expected or tp != want:
        fail(f"parallel-tp remat step: launches {run['launches']} (expected "
             f"{expected}), {tp} collectives over tp (the formula: {want})")
    return run["launches"]


def multi_card_plans(count: int) -> list:
    """The multi-card runs on `count` visible cards (at most
    MULTI_CARD_MAX used; none on one card): GPT-2-124M over fsdp on every
    card; llama_1b over tp 2, or tp 4 on four cards; GPT-2-124M over cp 2,
    or cp 4 on four cards; gpt2_124m(moe_experts=8) over cp 2, or
    fsdp2·cp2 on four cards; gpt2_124m(attention_impl="pallas") over cp 2
    (the gathered path); on four, GPT-2-124M over fsdp2·tp2 and over
    pp2·cp2 (4 microbatches), llama_1b over cp2·tp2 and over pp2·tp2 (pp a
    replica axis). A plan's "overrides" change its config, and
    "reference" names the world-1 run it is held to (default: its
    model's)."""
    if count < 2:
        return []
    world = min(count, MULTI_CARD_MAX)
    tp = 4 if world == 4 else 2
    plans = [dict(name=f"gpt2_124m_fsdp{world}", model="gpt2", config="gpt2_124m",
                  mesh={"fsdp": world}, batch=TRAIN_BATCH),
             dict(name=f"llama_1b_tp{tp}", model="llama", config="llama_1b",
                  mesh={"tp": tp}, batch=LLAMA_TRAIN_BATCH),
             dict(name=f"gpt2_124m_cp{tp}", model="gpt2", config="gpt2_124m",
                  mesh={"cp": tp}, batch=TRAIN_BATCH)]
    moe_mesh = {"fsdp": 2, "cp": 2} if world == 4 else {"cp": 2}
    plans += [dict(name="gpt2_124m_moe8_" + "".join(f"{a}{n}" for a, n in moe_mesh.items()),
                   model="gpt2", config="gpt2_124m",
                   overrides={"moe_experts": MOE_EXPERTS}, reference="gpt2_moe8",
                   mesh=moe_mesh, batch=TRAIN_BATCH),
              dict(name="gpt2_124m_pallas_cp2", model="gpt2", config="gpt2_124m",
                   overrides={"attention_impl": "pallas"}, mesh={"cp": 2},
                   batch=TRAIN_BATCH)]
    if world == 4:
        plans += [dict(name="gpt2_124m_fsdp2tp2", model="gpt2",
                       config="gpt2_124m", mesh={"fsdp": 2, "tp": 2},
                       batch=TRAIN_BATCH),
                  dict(name="llama_1b_cp2tp2", model="llama", config="llama_1b",
                       mesh={"cp": 2, "tp": 2}, batch=LLAMA_TRAIN_BATCH),
                  dict(name="gpt2_124m_pp2cp2", model="gpt2", config="gpt2_124m",
                       overrides={"pipeline_microbatches": 4},
                       mesh={"pp": 2, "cp": 2}, batch=TRAIN_BATCH),
                  dict(name="llama_1b_pp2tp2", model="llama", config="llama_1b",
                       mesh={"pp": 2, "tp": 2}, batch=LLAMA_TRAIN_BATCH)]
    return plans


def plan_model(plan: dict):
    """(model module, config) of a multi-card plan, remat off, with its
    overrides."""
    from ray_tpu_torch.models import gpt2, llama

    model = {"gpt2": gpt2, "llama": llama}[plan["model"]]
    return model, getattr(model, plan["config"])(remat=False,
                                                 **plan.get("overrides", {}))


def gathered_plan(plan: dict) -> bool:
    """Whether a multi-card plan's attention takes the gathered path."""
    from ray_tpu_torch.models.common import attention_path

    _, cfg = plan_model(plan)
    return attention_path(cfg.attention_impl, plan["mesh"].get("cp", 1)) == "gathered"


def rank_attention_shape(plan: dict):
    """The q shape [B, H, S, hd] that one rank of a multi-card plan gives
    the flash kernels, and how many kv heads it holds before it repeats
    them to H: the batch split over dp·fsdp (and a pipeline's microbatches),
    the heads and kv heads over tp, the sequence over cp (a ring chunk; on
    the gathered path the queries' chunk, against the whole sequence)."""
    from ray_tpu_torch.models import gpt2

    model, cfg = plan_model(plan)
    mesh = {"dp": 1, "fsdp": 1, "tp": 1, "cp": 1, "pp": 1, **plan["mesh"]}
    rows = plan["batch"] // (mesh["dp"] * mesh["fsdp"])
    if mesh["pp"] > 1 and model is gpt2:
        rows //= cfg.pipeline_microbatches or mesh["pp"]
    kv = getattr(cfg, "n_kv_head", cfg.n_head)
    return ((rows, cfg.n_head // mesh["tp"], cfg.seq_len // mesh["cp"],
             cfg.head_dim), kv // mesh["tp"])


def mesh_rank(rank: int, init_method: str, out: str, plan: dict,
              backend: str = "nccl", device: str = "cuda") -> None:
    """One rank of a multi-card run (multi_card starts one process a card):
    the plan's model (remat off, its overrides) over its MeshSpec at its
    global batch, as
    train_run (profiling one more step when the plan says "profile");
    writes this rank's first step's metrics, step times,
    launches, collectives, index on the cp axis and peak memory to `out`
    (JSON)."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.train.train_step import (
        make_gpt2_train_step, make_llama_train_step, synthetic_batch,
    )

    spec = mesh_lib.MeshSpec(**plan["mesh"])
    mesh_lib.init_distributed(backend, init_method=init_method, rank=rank,
                              world_size=spec.num_devices, timeout_s=300)
    try:
        make = {"gpt2": make_gpt2_train_step,
                "llama": make_llama_train_step}[plan["model"]]
        _, cfg = plan_model(plan)
        mesh = mesh_lib.make_mesh(spec, device)
        # every rank profiles its extra step: a step on some ranks only
        # would leave the others' collectives unmatched
        what = f"{plan['name']} rank {rank}" if plan.get("profile") else ""
        run = train_run(make, cfg, synthetic_batch(cfg, plan["batch"], seed=0),
                        device, TRAIN_STEPS, mesh, what)
        Path(out).write_text(json.dumps(
            {**{k: run[k] for k in ("first", "loss", "grad_norm", "step_ms",
                                     "launches", "collectives")},
             "cp_rank": mesh.get_local_rank("cp"),
             "pp_rank": mesh.get_local_rank("pp"),
             "peak_memory_bytes": peak_memory(device)}))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(plan: dict, world: int, **kw) -> list:
    """`world` processes of mesh_rank on `plan`, one a card (LOCAL_RANK),
    killed after 600 s; each rank's JSON."""
    init = f"tcp://localhost:{free_port()}"
    outs = [REPO / "build" / f"parallel_{plan['name']}.{r}.json" for r in range(world)]
    outs[0].parent.mkdir(exist_ok=True)
    for o in outs:
        o.unlink(missing_ok=True)
    code = ("import sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
            "chip_smoke.mesh_rank({r}, {init!r}, {out!r}, {plan!r}, **{kw!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(repo=str(REPO), r=r, init=init,
                                           out=str(outs[r]), plan=plan, kw=kw)],
        env={**os.environ, "LOCAL_RANK": str(r)})
        for r in range(world)]
    deadline = time.monotonic() + 600
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs) or not all(o.exists() for o in outs):
        fail(f"multi-card run {plan['name']} failed: exit codes "
             f"{[p.returncode for p in procs]}")
    return [json.loads(o.read_text()) for o in outs]


def hold_to_world_one(card: str, plan: dict, ranks: list, ref: dict,
                      device="cuda") -> None:
    """A multi-card run of `plan` (each rank's JSON from run_ranks) held
    to the world-1 mesh run of its model `ref`: the first step's loss
    within LOSS_TOL, its grad norm within MESH_NORM_REL_TOL relative, the
    limit the world-1 mesh step is held to (the rows are split and the
    row-parallel products sum their partial sums in another order, so the
    products round on other shapes; measured on four H100s: loss 9.5e-7
    to 2.9e-4 apart, grad norm 6.7e-6 to 9.0e-5, inside the plain step's
    own grad-norm spread of up to 1.6e-4; an MoE plan's grad norm within
    MOE_MESH_NORM_REL_TOL, its routing flips), every rank the same loss; each
    kernel as often on every rank as launches_per_step says (the plain
    versions off the card); the collectives over cp as
    cp_collectives_per_step says, and over tp as tp_collectives_per_step
    says where the plan runs no pipeline (on groups of one too). Prints
    step ms, tokens/s per card and peak memory per card."""
    from ray_tpu_torch.models import gpt2

    run, world = ranks[0], len(ranks)
    model, cfg = plan_model(plan)
    cp, pp = plan["mesh"].get("cp", 1), plan["mesh"].get("pp", 1)
    loss_err = abs(run["first"]["loss"] - ref["first"]["loss"])
    norm_err = (abs(run["first"]["grad_norm"] - ref["first"]["grad_norm"])
                / ref["first"]["grad_norm"])
    step = sorted(run["step_ms"])[len(run["step_ms"]) // 2]
    steps = 1 + len(run["step_ms"])
    want = {"cp": cp_collectives_per_step(model, cfg, cp, pp) * steps}
    if not (pp > 1 and model is gpt2):
        want["tp"] = tp_collectives_per_step(model, cfg) * steps
    log(f"[parallel] " + json.dumps(dict(
        card=card, cards=world, mesh=plan["mesh"], model=plan["config"],
        overrides=plan.get("overrides", {}),
        batch=plan["batch"], seq_len=cfg.seq_len, first=run["first"],
        world_one_first=ref["first"], loss_err=loss_err,
        grad_norm_rel_err=norm_err, loss=run["loss"],
        step_ms=run["step_ms"], step_ms_median=step,
        world_one_step_ms_median=sorted(ref["step_ms"])[len(ref["step_ms"]) // 2],
        tokens_per_s_per_card=plan["batch"] * cfg.seq_len / (step / 1e3) / world,
        peak_memory_bytes_per_card=[r["peak_memory_bytes"] for r in ranks],
        launches_by_rank=[r["launches"] for r in ranks],
        collectives=run["collectives"], collectives_formula=want)))
    norm_tol = MOE_MESH_NORM_REL_TOL if is_moe(cfg) else MESH_NORM_REL_TOL
    if not (loss_err <= LOSS_TOL and norm_err <= norm_tol):
        fail(f"multi-card {plan['name']} disagrees with the world-1 step: "
             f"loss {loss_err}, grad norm {norm_err} (tol {norm_tol})")
    if len({r["first"]["loss"] for r in ranks}) != 1:
        fail(f"multi-card {plan['name']}: the ranks' losses differ")
    on_card = torch.device(device).type == "cuda"
    for r in ranks:
        expected = (launches_per_step(model, cfg, cp, r["cp_rank"], pp) * steps
                    if on_card else 0)
        if r["launches"] != {"flash_fwd": expected, "flash_bwd": expected}:
            fail(f"multi-card {plan['name']}: a rank at cp index "
                 f"{r['cp_rank']} launched {r['launches']}, expected "
                 f"{expected} each")
    for axis, n in want.items():
        if run["collectives"].get(axis, 0) != n:
            fail(f"multi-card {plan['name']}: {run['collectives']} "
                 f"collectives, {n} over {axis} by the formula")


def multi_card(card: str, world_one: dict, profile: bool = False) -> dict:
    """With 2 or more cards: each of multi_card_plans, one NCCL rank a card,
    held to the world-1 mesh run of its model or its "reference"
    (world_one["gpt2"], ["llama"] or ["gpt2_moe8"]) by hold_to_world_one;
    with `profile`, every rank of each
    also profiles one more step by kernel. With one card
    it says that the run did not take place. Returns the launches of rank
    0 by plan."""
    count = torch.cuda.device_count()
    if count < 2:
        log("[parallel] multi-card run: did not take place (one card; "
            "multi-rank behaviour is proved on the CPU over gloo)")
        return {}
    launches = {}
    for plan in multi_card_plans(count):
        ranks = run_ranks({**plan, "profile": profile},
                          math.prod(plan["mesh"].values()))
        hold_to_world_one(card, plan, ranks,
                          world_one[plan.get("reference", plan["model"])])
        launches[plan["name"]] = ranks[0]["launches"]
    return launches


def multi_card_check(profile: bool = False) -> int:
    """The multi-card runs and what they are held to, alone, for a machine
    with 2 to 4 cards: python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.multi_card_check())". Builds the kernels, trains
    GPT-2-124M, its MoE (on a ring of one) and llama_1b through the world-1
    mesh path (one NCCL rank, card 0) as the [parallel], [parallel-moe-cp]
    and [parallel-tp] phases do, then each of
    multi_card_plans over the cards (multi_card; with `profile`, every rank
    profiles one more step: multi_card_check(True)), then on a one-node
    cluster two num_gpus=1 tasks on two cards at once (multi_card_leases)
    and TorchTrainer over dp 2 (multi_card_trainer)."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.train.train_step import (
        make_gpt2_train_step, make_llama_train_step, synthetic_batch,
    )

    if torch.cuda.device_count() < 2:
        print("chip_smoke: the multi-card run needs 2 or more cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    card = nvidia_smi()
    log(f"[env] {card}; {torch.cuda.device_count()} cards")
    build()
    mesh_lib.init_distributed("nccl", init_method=f"tcp://localhost:{free_port()}",
                              rank=0, world_size=1, timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), "cuda")
        world_one = {}
        for key, make, cfg, batch in (
                ("gpt2", make_gpt2_train_step, gpt2.gpt2_124m(remat=False),
                 TRAIN_BATCH),
                ("gpt2_moe8", make_gpt2_train_step,
                 gpt2.gpt2_124m(moe_experts=MOE_EXPERTS, attention_impl="ring",
                                remat=False), TRAIN_BATCH),
                ("llama", make_llama_train_step, llama.llama_1b(remat=False),
                 LLAMA_TRAIN_BATCH)):
            world_one[key] = train_run(
                make, cfg, synthetic_batch(cfg, batch, seed=0), "cuda",
                TRAIN_STEPS, mesh)
            world_one[key].pop("grads")
            log(f"[parallel] world 1, {key}: " + json.dumps(
                {k: world_one[key][k] for k in ("first", "loss", "step_ms")}))
            free_device_memory()
        multi_card(card, world_one, profile)
    finally:
        torch.distributed.destroy_process_group()
    free_device_memory()
    import ray_tpu_torch

    ray_tpu_torch.init()
    try:
        multi_card_leases()
        multi_card_trainer(card, world_one["gpt2"])
    finally:
        ray_tpu_torch.shutdown()
    log(card)
    return 0


def rank_shape_check(count: int = MULTI_CARD_MAX) -> int:
    """On one card, the kernel cases at the rank shapes of the plans that
    `count` cards run (multi_card_plans(count)), as the multi-card smoke
    runs them: the backward cases with each non-cp plan's rank shape and
    the ring's chunk rows with each cp plan's. For the kernel table's rank
    rows without `count` cards: python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.rank_shape_check())"."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"[env] {card}; the rank shapes of {count} cards on one")
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    plans = multi_card_plans(count)
    backward_cases(gen, plans)
    free_device_memory()
    ring_phase(card, gen, plans)
    log(card)
    return 0


def parallel_phase(card: str, profile: bool = False) -> dict:
    """[parallel]: a world-1 NCCL process group started here and its
    make_mesh(MeshSpec()) on cuda. GPT-2-124M at B TRAIN_BATCH through the
    mesh path, 1 + TRAIN_STEPS steps, held to the plain step (and timed
    beside it); gpt2_124m(moe_experts=8), one step each way; [parallel-tp]
    llama_1b at B LLAMA_TRAIN_BATCH, 1 + TRAIN_STEPS steps, through the
    same tensor-parallel code on a group of one (mesh_against_plain for
    all three), then once with remat (remat_against_mesh); [parallel-cp]
    gpt2_124m(attention_impl="ring") at B TRAIN_BATCH, 1 + TRAIN_STEPS
    steps, ring attention on a cp group of one against the plain step
    (mesh_against_plain); [parallel-moe-cp] gpt2_124m(moe_experts=8,
    attention_impl="ring") and [parallel-gathered]
    gpt2_124m(attention_impl="pallas"), each 1 + TRAIN_STEPS steps against
    the plain step (mesh_against_plain); the local
    pipeline (PIPELINE_STAGES stages, PIPELINE_MICROBATCHES microbatches)
    against the sequential blocks; the multi-card runs where there are
    cards for them. With `profile`, one
    step of each path of [parallel], [parallel-tp] and [parallel-cp] by
    kernel, and of every rank of each multi-card run.
    Returns the launches by path."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.train.train_step import (
        make_gpt2_train_step, make_llama_train_step, synthetic_batch,
    )

    free_device_memory()
    mesh_lib.init_distributed("nccl", init_method=f"tcp://localhost:{free_port()}",
                              rank=0, world_size=1, timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), "cuda")
        launches, world_one = {}, {}
        # the GPT-2 and Llama mesh runs are what the multi-card runs of
        # each model are held to
        for tag, name, model, make, cfg, batch, steps, key, grad_tol in (
                ("parallel", "gpt2_124m", gpt2, make_gpt2_train_step,
                 gpt2.gpt2_124m(remat=False), TRAIN_BATCH, TRAIN_STEPS, "gpt2",
                 GRAD_PATH_REL_TOL),
                ("parallel-moe", "gpt2_124m_moe8", gpt2, make_gpt2_train_step,
                 gpt2.gpt2_124m(moe_experts=MOE_EXPERTS, remat=False),
                 TRAIN_BATCH, 0, None, GRAD_PATH_REL_TOL),
                ("parallel-tp", "llama_1b", llama, make_llama_train_step,
                 llama.llama_1b(remat=False), LLAMA_TRAIN_BATCH, TRAIN_STEPS,
                 "llama", LLAMA_MESH_GRAD_REL_TOL)):
            run = mesh_against_plain(card, tag, name, model, make, cfg, batch,
                                     steps, mesh, profile=profile and steps > 0,
                                     grad_tol=grad_tol)
            launches[tag] = run.pop("launches")
            if key:
                world_one[key] = {k: run[k] for k in ("first", "step_ms")}
            del run
            free_device_memory()
        launches["parallel-tp-remat"] = remat_against_mesh(
            card, mesh, world_one["llama"], llama.llama_1b(remat=True),
            LLAMA_TRAIN_BATCH)
        free_device_memory()
        # [parallel-cp]: the ring over a cp group of one, against the plain
        # step (whose "auto" attention needs no mesh)
        run = mesh_against_plain(
            card, "parallel-cp", "gpt2_124m", gpt2, make_gpt2_train_step,
            gpt2.gpt2_124m(attention_impl="ring", remat=False), TRAIN_BATCH,
            TRAIN_STEPS, mesh, profile=profile,
            plain_cfg=gpt2.gpt2_124m(remat=False))
        launches["parallel-cp"] = run.pop("launches")
        del run
        free_device_memory()
        # [parallel-moe-cp]: the MoE layer's queue over (batch, cp) and a
        # ring of one; [parallel-gathered]: "pallas" under a mesh gathers k
        # and v over a cp group of one; each against the plain step
        for tag, name, cfg, plain_cfg, key in (
                ("parallel-moe-cp", "gpt2_124m_moe8",
                 gpt2.gpt2_124m(moe_experts=MOE_EXPERTS, attention_impl="ring",
                                remat=False),
                 gpt2.gpt2_124m(moe_experts=MOE_EXPERTS, remat=False), "gpt2_moe8"),
                ("parallel-gathered", "gpt2_124m",
                 gpt2.gpt2_124m(attention_impl="pallas", remat=False),
                 gpt2.gpt2_124m(remat=False), None)):
            run = mesh_against_plain(card, tag, name, gpt2, make_gpt2_train_step,
                                     cfg, TRAIN_BATCH, TRAIN_STEPS, mesh,
                                     profile=profile, plain_cfg=plain_cfg)
            launches[tag] = run.pop("launches")
            if key:
                world_one[key] = {k: run[k] for k in ("first", "step_ms")}
            del run
            free_device_memory()

        cfg = gpt2.gpt2_124m()
        pipe = pipeline_and_sequential(
            cfg, synthetic_batch(cfg, TRAIN_BATCH, seed=0), "cuda",
            PIPELINE_STAGES, PIPELINE_MICROBATCHES)
        expected = cfg.n_layer * PIPELINE_MICROBATCHES
        log("[pipeline] " + json.dumps(dict(
            card=card, model="gpt2_124m", batch=TRAIN_BATCH,
            stages=PIPELINE_STAGES, microbatches=PIPELINE_MICROBATCHES,
            expected_launches=expected, **pipe)))
        if pipe["launches"] != {"flash_fwd": expected, "flash_bwd": expected}:
            fail(f"pipeline launched {pipe['launches']}, expected {expected} each")
        if not (abs(pipe["loss"] - pipe["sequential_loss"]) <= LOSS_TOL
                and pipe["worst_grad_rel_err"] <= GRAD_PATH_REL_TOL):
            fail(f"pipeline disagrees with the sequential blocks: {pipe}")
        launches["pipeline"] = pipe["launches"]
        free_device_memory()
        launches["multi_card"] = multi_card(card, world_one, profile)
        # what [cluster-trainer]'s multi-card run is held to
        launches["world_one_gpt2"] = world_one["gpt2"]
    finally:
        torch.distributed.destroy_process_group()
    free_device_memory()
    return launches


# [rllib-*]: RLlib on the card (ray_tpu_torch/rllib): rollouts on the host
# CPU, the learner's SGD on `device`. [rllib-ppo] is BASELINE config 2 at
# the reference's settings (tests/test_rllib_ppo.py::test_cartpole_learning):
# CartPole-v1, 16 envs, fragments of 256, train batch 4000, minibatch 128, 10
# epochs, lr 3e-4, seed 0, until episode_reward_mean >= 150 over >= 20
# episodes, within 100k env steps; [rllib-impala] the reference's
# test_impala_learns_cartpole_sync target (best episode_reward_mean >= 150
# within 40 iterations of 8 updates of 16 x 64 steps), then Pong-v0 at the
# same shape for RLLIB_PONG_ITERS iterations.
RLLIB_TARGET_REWARD, RLLIB_MIN_EPISODES = 150.0, 20
RLLIB_PPO_MAX_STEPS = 100_000
RLLIB_IMPALA_MAX_ITERS = 40
RLLIB_PONG_ITERS = 3
RLLIB_NUM_ENVS = 16
RLLIB_PPO_FRAGMENT, RLLIB_IMPALA_FRAGMENT = 256, 64
RLLIB_PPO_TRAINING = dict(train_batch_size=4000, minibatch_size=128,
                          num_epochs=10, lr=3e-4)
# [rllib-ma]: one iteration of 2048 env steps (2048 rows a policy)
RLLIB_MA_TRAINING = dict(train_batch_size=2048, minibatch_size=256, num_epochs=4)
# [rllib-dqn], [rllib-sac], [rllib-bc]: the reference's learning tests'
# settings, 8 envs, 64×64 nets, seed 0: best episode_reward_mean >= 150
# within 500 DQN iterations (tests/test_rllib_dqn.py::
# test_dqn_learns_cartpole: fragments of 8, lr 1e-3, batch 64, replay warm
# at 500 rows, target synced every 60 updates, 8 updates an iteration,
# epsilon down to 0.05 over 6000 env steps, prioritized replay), >= 150
# within 600 SAC iterations (tests/test_rllib_sac.py::
# test_sac_learns_cartpole: fragments of 16, lr 3e-3, batch 256) and
# >= 120 within 40 BC iterations on a scripted expert's 40 logged
# episodes (tests/test_rllib_offline.py::test_bc_clones_scripted_expert:
# lr 3e-3, batch 256, 32 updates an iteration, evaluation fragments of 64).
# A row every RLLIB_LOG_EVERY iterations and at the target.
RLLIB_OFFPOLICY_ENVS = 8
RLLIB_DQN_FRAGMENT, RLLIB_SAC_FRAGMENT, RLLIB_BC_FRAGMENT = 8, 16, 64
RLLIB_DQN_TRAINING = dict(lr=1e-3, train_batch_size=64, learning_starts=500,
                          target_update_freq=60, train_intensity=8,
                          epsilon_timesteps=6_000)
RLLIB_SAC_TRAINING = dict(lr=3e-3, train_batch_size=256, learning_starts=500,
                          train_intensity=8)
RLLIB_BC_TRAINING = dict(lr=3e-3, train_batch_size=256, train_intensity=32)
RLLIB_DQN_MAX_ITERS, RLLIB_SAC_MAX_ITERS, RLLIB_BC_MAX_ITERS = 500, 600, 40
RLLIB_BC_TARGET_REWARD = 120.0
RLLIB_BC_EXPERT_EPISODES = 40
RLLIB_LOG_EVERY = 50
# [rllib-parity]: two optimizer steps of PPO (two epochs, each one
# minibatch of the whole batch), and two updates of IMPALA, DQN (its
# target synced at the second), SAC and BC, from the same weights and
# batch on the card and on the CPU, f32 with TF32 off. DQN, SAC and BC
# take one replay batch of RLLIB_PARITY_ROWS transitions: PER weights
# that are not uniform, some episodes' ends.
# - Every leaf's gradient at every step: |g_card - g_cpu| over max |g_cpu|
#   within 1e-5. Each element is a sum over the batch's rows in another
#   order on each device, so the two differ by rounding: some ulps of the
#   leaf's largest element, well under 1e-5 of it; a leaf wrong by a
#   factor of 1.001 fails. A leaf no loss reaches (DQN's, SAC's and BC's
#   value heads) is exactly 0 on both.
# - Parameters and targets within 1e-6 absolute (magnitude <~ 2). Adam's
#   first step is about ±lr whatever the gradient's size; its second
#   depends on the two steps' gradients' ratio, so a leaf's gradient wrong
#   by a factor moves the parameters by ~0.1·lr = 3e-5. A gradient element
#   at rounding level (exactly 0 on a device) would flip the first step by
#   2·lr; none is (checked).
# - Metrics (means over the steps of means over the batch), and DQN's and
#   SAC's |TD| errors element by element, within 1e-5 relative, or
#   absolutely within 1e-6 times the mean |term| of the batch the losses
#   average (PPO: the standardized advantages; IMPALA, DQN, SAC: the
#   rewards; BC: −log π of a near-uniform policy, log A), about 16 ulps of
#   a term: PPO's first-step policy_loss and mean_kl are rounding (0 on one
#   device, 1e-8 on the other), so these two are held by their second step
#   only.
RLLIB_PARITY_STEPS = 2
RLLIB_PARITY_GRAD_TOL = 1e-5     # relative to the leaf's largest element
RLLIB_PARITY_PARAM_TOL = 1e-6    # absolute, parameters of magnitude <~ 2
RLLIB_PARITY_METRIC_TOL = 1e-5   # relative,
RLLIB_PARITY_METRIC_ATOL = 1e-6  # or this times the batch's mean |term|
RLLIB_PARITY_ROWS = 256


def rllib_timed(algo, device) -> dict:
    """Wraps the algorithm's sampling and its learner's update with host
    clocks (the update ends in a synchronization) and returns the lists
    they fill: sample seconds, update seconds, minibatch steps."""
    t = {"sample_s": [], "update_s": [], "sgd_steps": []}
    groups = algo._all_learner_groups().values()
    runner = algo.local_runner
    sample = runner.sample

    def timed_sample(*a, **kw):
        s = time.perf_counter()
        out = sample(*a, **kw)
        t["sample_s"].append(time.perf_counter() - s)
        return out
    runner.sample = timed_sample
    for g in groups:
        learner, update = g._learner, g.update

        def timed_update(batch, _update=update, _learner=learner):
            steps, s = _learner._step, time.perf_counter()
            out = _update(batch)
            sync(device)
            t["update_s"].append(time.perf_counter() - s)
            t["sgd_steps"].append(_learner._step - steps)
            return out
        g.update = timed_update
    return t


def rllib_placement(tag: str, algo, device) -> None:
    """Each learner's parameters, targets (where it has them) and Adam
    moments on `device`, the runner's policy on the host CPU; one line
    says so."""
    from ray_tpu_torch.rllib.models import tree_leaves

    want = torch.device(device).type
    counts = []
    for pid, g in algo._all_learner_groups().items():
        learner = g._learner
        opt = [t for s in learner._optimizer.state.values() for t in s.values()]
        targets = [] if learner.target is None else tree_leaves(learner.target)
        params = tree_leaves(learner.params)
        where = {t.device.type for t in params + targets + opt}
        if where != {want}:
            fail(f"[{tag}] learner {pid} holds tensors on {where}, not {want}")
        counts.append(f"{len(params)} parameters, {len(targets)} targets, "
                      f"{len(opt)} moments")
    policies = getattr(algo.local_runner, "policies", None) or {
        "": algo.local_runner.params}
    where = {t.device.type for p in policies.values() for t in tree_leaves(p)}
    if where != {"cpu"}:
        fail(f"[{tag}] the runner's policy is on {where}, not the CPU")
    log(f"[{tag}] placement: learner {'; '.join(counts)} on {want}; the "
        f"runner's policy on the CPU")


def rllib_iteration_row(tag: str, it: int, result: dict, t: dict, device) -> str:
    """One iteration's numbers: sample and update seconds (this
    iteration's calls), minibatch steps/s, env-steps/s overall, peak
    device memory."""
    sample_s, update_s = sum(t["sample_s"]), sum(t["update_s"])
    steps = sum(t["sgd_steps"])
    peak = peak_memory(device)
    row = (f"[{tag}] iter {it}: reward {result.get('episode_reward_mean', float('nan')):.2f} "
           f"({result.get('episodes_this_window', 0)} episodes), "
           f"timesteps {result['timesteps_total']}, sample {sample_s:.3f} s, "
           f"update {update_s:.3f} s ({len(t['update_s'])} updates, {steps} "
           f"minibatch steps, {steps / max(update_s, 1e-9):.1f} steps/s), "
           f"env-steps/s {result['timesteps_total'] / result['time_total_s']:.1f}, "
           f"peak {'n/a' if peak is None else f'{peak / 1e9:.3f} GB'}")
    for v in t.values():
        v.clear()
    return row


def rllib_ppo(card: str, device="cuda", profile: bool = False) -> dict:
    """[rllib-ppo]: BASELINE config 2 through PPOConfig()...build().train()
    with the learner on `device`, until the target (fatal past
    RLLIB_PPO_MAX_STEPS env steps); with `profile`, one more update's
    device time by kernel."""
    from ray_tpu_torch.rllib.algorithms import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1", num_envs_per_worker=RLLIB_NUM_ENVS)
            .rollouts(num_rollout_workers=0,
                      rollout_fragment_length=RLLIB_PPO_FRAGMENT)
            .training(**RLLIB_PPO_TRAINING)
            .resources(learner_device=device)
            .debugging(seed=0)
            .build())
    rllib_placement("rllib-ppo", algo, device)
    t = rllib_timed(algo, device)
    result, it, update_ms, iteration_s = {}, 0, [], []
    while result.get("timesteps_total", 0) < RLLIB_PPO_MAX_STEPS:
        it += 1
        result = algo.train()
        update_ms.append(sum(t["update_s"]) * 1e3)
        iteration_s.append(result["time_this_iter_s"])
        log(rllib_iteration_row("rllib-ppo", it, result, t, device))
        if (result["episode_reward_mean"] >= RLLIB_TARGET_REWARD
                and result["episodes_this_window"] >= RLLIB_MIN_EPISODES):
            break
    else:
        fail(f"[rllib-ppo] episode_reward_mean "
             f"{result['episode_reward_mean']:.2f} < {RLLIB_TARGET_REWARD} "
             f"after {result['timesteps_total']} env steps")
    rllib_placement("rllib-ppo", algo, device)
    for k in ("total_loss", "grad_norm", "policy_loss", "vf_loss"):
        if not math.isfinite(result[k]):
            fail(f"[rllib-ppo] {k} is {result[k]}")
    log(f"[rllib-ppo] reached {result['episode_reward_mean']:.2f} over "
        f"{result['episodes_this_window']} episodes in {it} iterations, "
        f"{result['timesteps_total']} env steps; update ms by iteration "
        f"{[round(x, 1) for x in update_ms]}; {card}")
    if profile:
        batch = algo.sample_batch()

        def one_update():
            algo.learner_group.update(batch)
            sync(device)
        profile_device_time(f"one PPO update ({len(batch)} rows)", one_update,
                            top=16)
    return {"iterations": it, "env_steps": result["timesteps_total"],
            "env_steps_per_s": result["timesteps_total"] / result["time_total_s"],
            "iteration_s": iteration_s, "update_ms": update_ms}


def rllib_impala(card: str, device="cuda") -> dict:
    """[rllib-impala]: IMPALA's inline path (the reference's synchronous
    training_step) on CartPole to the reference's target, then Pong-v0's
    env-steps/s over RLLIB_PONG_ITERS iterations: one process, rollouts
    inline, not the reference's asynchronous actors (BASELINE config 4)."""
    from ray_tpu_torch.rllib.algorithms import IMPALAConfig

    def build(env, **training):
        return (IMPALAConfig()
                .environment(env, num_envs_per_worker=RLLIB_NUM_ENVS)
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=RLLIB_IMPALA_FRAGMENT)
                .training(updates_per_iteration=8, **training)
                .resources(learner_device=device)
                .debugging(seed=0)
                .build())

    algo = build("CartPole-v1", lr=5e-4, entropy_coeff=0.005)
    rllib_placement("rllib-impala", algo, device)
    t = rllib_timed(algo, device)
    best = -math.inf
    for it in range(1, RLLIB_IMPALA_MAX_ITERS + 1):
        result = algo.train()
        log(rllib_iteration_row("rllib-impala", it, result, t, device))
        if math.isfinite(result["episode_reward_mean"]):
            best = max(best, result["episode_reward_mean"])
        if best >= RLLIB_TARGET_REWARD:
            break
    if best < RLLIB_TARGET_REWARD:
        fail(f"[rllib-impala] best episode_reward_mean {best:.2f} < "
             f"{RLLIB_TARGET_REWARD} in {RLLIB_IMPALA_MAX_ITERS} iterations")
    log(f"[rllib-impala] CartPole best {best:.2f} in {it} iterations, "
        f"{result['timesteps_total']} env steps")

    pong = build("Pong-v0")
    t = rllib_timed(pong, device)
    rates = []
    for i in range(1, RLLIB_PONG_ITERS + 1):
        result = pong.train()
        sample_ms = 1e3 * sum(t["sample_s"]) / len(t["sample_s"])
        update_ms = 1e3 * sum(t["update_s"]) / len(t["update_s"])
        log(rllib_iteration_row("rllib-impala-pong", i, result, t, device))
        log(f"[rllib-impala-pong] iter {i} (inline, one process): "
            f"env_steps_per_sec {result['env_steps_per_sec']:.1f}, update "
            f"{update_ms:.3f} ms and sample {sample_ms:.3f} ms a round of "
            f"{RLLIB_NUM_ENVS} x {RLLIB_IMPALA_FRAGMENT} steps; {card}")
        rates.append(result["env_steps_per_sec"])
        if not math.isfinite(result["total_loss"]):
            fail(f"[rllib-impala-pong] total_loss is {result['total_loss']}")
    return {"cartpole_iterations": it, "pong_env_steps_per_sec": rates}


def rllib_to_target(card: str, tag: str, algo, device, max_iters: int,
                    target: float) -> dict:
    """train() until the best episode_reward_mean reaches `target`, fatal
    past `max_iters` iterations: a row every RLLIB_LOG_EVERY iterations and
    at the target, then iterations and env steps to it, update ms (host
    clock around a synchronized update()) and updates/s, sample ms an
    iteration, peak device memory, and the placement again."""
    rllib_placement(tag, algo, device)
    t = rllib_timed(algo, device)
    update_s, sample_s, best, result = [], [], -math.inf, {}
    for it in range(1, max_iters + 1):
        result = algo.train()
        update_s += t["update_s"]
        sample_s.append(sum(t["sample_s"]))
        if math.isfinite(result["episode_reward_mean"]):
            best = max(best, result["episode_reward_mean"])
        if best >= target or it % RLLIB_LOG_EVERY == 0:
            log(rllib_iteration_row(tag, it, result, t, device))
        for v in t.values():
            v.clear()
        if best >= target:
            break
    else:
        fail(f"[{tag}] best episode_reward_mean {best:.2f} < {target} in "
             f"{max_iters} iterations")
    if not math.isfinite(result["loss"]):
        fail(f"[{tag}] loss is {result['loss']}")
    rllib_placement(tag, algo, device)
    ms = 1e3 * np.asarray(update_s)
    peak = peak_memory(device)
    out = {"iterations": it, "env_steps": result["timesteps_total"], "best": best,
           "updates": len(ms), "update_ms": float(np.median(ms)),
           "updates_per_s": len(ms) / max(float(np.sum(update_s)), 1e-9),
           "sample_ms": 1e3 * float(np.median(sample_s)),
           "iteration_ms": 1e3 * result["time_total_s"] / it}
    log(f"[{tag}] reached {best:.2f} in {it} iterations, {out['env_steps']} env "
        f"steps, {result['time_total_s']:.1f} s; {len(ms)} updates: update ms "
        f"median {out['update_ms']:.3f} (p10 {np.percentile(ms, 10):.3f}, p90 "
        f"{np.percentile(ms, 90):.3f}), {out['updates_per_s']:.1f} updates/s; "
        f"sample ms an iteration median {out['sample_ms']:.3f}; iteration ms "
        f"mean {out['iteration_ms']:.3f}; peak "
        f"{'n/a' if peak is None else f'{peak / 1e9:.4f} GB'}; {card}")
    return out


def rllib_profile_step(tag: str, algo, device) -> None:
    """--profile: the device busy share of one more training_step."""
    cfg = algo.algo_config

    def one_step():
        algo.training_step()
        sync(device)
    profile_device_time(
        f"one {tag} training_step ({cfg.train_intensity} updates of "
        f"{cfg.train_batch_size} rows)", one_step, top=16)


def rllib_offpolicy_config(config_cls, fragment: int, training: dict, device):
    return (config_cls()
            .environment("CartPole-v1", num_envs_per_worker=RLLIB_OFFPOLICY_ENVS)
            .rollouts(num_rollout_workers=0, rollout_fragment_length=fragment)
            .training(hiddens=(64, 64), **training)
            .resources(learner_device=device)
            .debugging(seed=0))


def rllib_dqn(card: str, device="cuda", profile: bool = False) -> dict:
    """[rllib-dqn]: DQNConfig()...build().train() at the reference's
    learning test's settings to its target."""
    from ray_tpu_torch.rllib.algorithms import DQNConfig

    algo = rllib_offpolicy_config(DQNConfig, RLLIB_DQN_FRAGMENT,
                                  RLLIB_DQN_TRAINING, device).build()
    out = rllib_to_target(card, "rllib-dqn", algo, device, RLLIB_DQN_MAX_ITERS,
                          RLLIB_TARGET_REWARD)
    if profile:
        rllib_profile_step("rllib-dqn", algo, device)
    return out


def rllib_sac(card: str, device="cuda", profile: bool = False) -> dict:
    """[rllib-sac]: SACConfig()...build().train() at the reference's
    learning test's settings to its target."""
    from ray_tpu_torch.rllib.algorithms import SACConfig

    algo = rllib_offpolicy_config(SACConfig, RLLIB_SAC_FRAGMENT,
                                  RLLIB_SAC_TRAINING, device).build()
    out = rllib_to_target(card, "rllib-sac", algo, device, RLLIB_SAC_MAX_ITERS,
                          RLLIB_TARGET_REWARD)
    if profile:
        rllib_profile_step("rllib-sac", algo, device)
    return out


def record_expert(path: str, episodes: int) -> float:
    """The reference test's scripted CartPole controller
    (tests/test_rllib_offline.py::_record_expert, copied): action 1 when
    angle + 0.5·angular velocity > 0, one episode of at most 500 steps a
    batch through the port's JsonWriter; the mean return."""
    from ray_tpu_torch.rllib.env.cartpole import CartPoleVectorEnv
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    w = JsonWriter(path)
    env = CartPoleVectorEnv(num_envs=1)
    returns = []
    for ep in range(episodes):
        obs = env.reset(seed=ep)[0]
        obs_l, act_l = [], []
        total = 0.0
        for _ in range(500):
            a = int(obs[2] + 0.5 * obs[3] > 0)
            obs_l.append(obs.copy())
            act_l.append(a)
            obs_v, r, terminated, truncated = env.step(np.asarray([a]))
            obs = obs_v[0]
            total += float(r[0])
            if terminated[0] or truncated[0]:
                break
        returns.append(total)
        w.write(SampleBatch({
            SampleBatch.OBS: np.asarray(obs_l, np.float32),
            SampleBatch.ACTIONS: np.asarray(act_l, np.int64),
            SampleBatch.REWARDS: np.ones(len(act_l), np.float32),
        }))
    w.close()
    return float(np.mean(returns))


def rllib_bc(card: str, device="cuda") -> dict:
    """[rllib-bc]: the scripted expert recorded into a temporary directory,
    then BCConfig().offline_data(...)...build().train() at the reference's
    learning test's settings to its target."""
    import tempfile

    from ray_tpu_torch.rllib.algorithms import BCConfig

    with tempfile.TemporaryDirectory(prefix="rllib_bc_") as path:
        expert = record_expert(path, RLLIB_BC_EXPERT_EPISODES)
        algo = (BCConfig()
                .offline_data(path)
                .environment("CartPole-v1", num_envs_per_worker=RLLIB_OFFPOLICY_ENVS)
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=RLLIB_BC_FRAGMENT)
                .training(hiddens=(64, 64), **RLLIB_BC_TRAINING)
                .resources(learner_device=device)
                .debugging(seed=0)
                .build())
    log(f"[rllib-bc] expert: {RLLIB_BC_EXPERT_EPISODES} episodes, mean return "
        f"{expert:.1f}, {len(algo.buffer)} logged rows")
    out = rllib_to_target(card, "rllib-bc", algo, device, RLLIB_BC_MAX_ITERS,
                          RLLIB_BC_TARGET_REWARD)
    return {**out, "expert_mean_return": expert}


RLLIB_MA_KEYS = {"timesteps_this_iter", "policy/p0/loss", "policy/p1/loss",
                 "per_agent_reward_mean", "episode_reward_mean",
                 "training_iteration", "timesteps_total", "time_this_iter_s",
                 "time_total_s"}


def rllib_ma(device="cuda") -> dict:
    """[rllib-ma]: one train() of two-agent MultiAgentCartPole with two
    policies, each policy's learner on `device`; the result keys are the
    reference's (ray_tpu/rllib/algorithms/ppo.py::_ma_training_step)."""
    from ray_tpu_torch.rllib.algorithms import PPOConfig

    algo = (PPOConfig()
            .environment("MultiAgentCartPole", num_envs_per_worker=RLLIB_NUM_ENVS,
                         env_kwargs={"num_agents": 2})
            .rollouts(num_rollout_workers=0, rollout_fragment_length=128)
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=lambda aid: "p" + aid[-1])
            .training(**RLLIB_MA_TRAINING)
            .resources(learner_device=device)
            .debugging(seed=0)
            .build())
    rllib_placement("rllib-ma", algo, device)
    t = rllib_timed(algo, device)
    result = algo.train()
    if set(result) != RLLIB_MA_KEYS:
        fail(f"[rllib-ma] result keys {sorted(result)}, not the reference's "
             f"{sorted(RLLIB_MA_KEYS)}")
    if set(result["per_agent_reward_mean"]) != {"agent_0", "agent_1"}:
        fail(f"[rllib-ma] per-agent stats {result['per_agent_reward_mean']}")
    log(f"[rllib-ma] per-agent reward {result['per_agent_reward_mean']}, "
        f"{len(t['update_s'])} learner updates in "
        f"{1e3 * sum(t['update_s']):.1f} ms, sample {sum(t['sample_s']):.3f} s")
    return result


def leaf_paths(tree, path=()) -> list:
    """Each leaf's path of keys and indexes, in tree_leaves' order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, path + (i,))]
    return [path]


def rllib_parity_cases() -> list:
    """[rllib-parity]'s learners: (name, class, kwargs, batch, updates, the
    batch's mean |term|, whether a leaf path is one no loss reaches)."""
    from ray_tpu_torch.rllib.algorithms.bc import BCLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.learner import IMPALALearner, PPOLearner
    from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer

    def runner(**kw):
        return EnvRunner("CartPole-v1", seed=0, **kw)
    ppo, _ = runner(num_envs=RLLIB_NUM_ENVS).sample(RLLIB_PPO_FRAGMENT)
    adv = np.asarray(ppo["advantages"], np.float32)
    impala, _ = runner(num_envs=RLLIB_NUM_ENVS, postprocess="vtrace").sample(
        RLLIB_IMPALA_FRAGMENT)
    transitions, _ = runner(num_envs=RLLIB_OFFPOLICY_ENVS, postprocess="transitions",
                            act_mode="epsilon_greedy").sample(
        2 * RLLIB_PARITY_ROWS // RLLIB_OFFPOLICY_ENVS, epsilon=1.0)
    buffer = PrioritizedReplayBuffer(capacity=len(transitions), seed=0)
    buffer.update_priorities(buffer.add(transitions), np.random.default_rng(0)
                             .exponential(1.0, len(transitions)))
    replay = buffer.sample(RLLIB_PARITY_ROWS)
    if not (replay["terminateds"] | replay["truncateds"]).any() or (
            replay["weights"].min() == replay["weights"].max()):
        fail("[rllib-parity] the replay batch has no episode end or uniform weights")

    def value_head(path):
        return "vf" in path
    return [
        ("ppo", PPOLearner, dict(num_epochs=RLLIB_PARITY_STEPS,
                                 minibatch_size=len(ppo)), ppo, 1,
         float(np.abs((adv - adv.mean()) / max(float(adv.std()), 1e-6)).mean()),
         None),
        ("impala", IMPALALearner, {}, impala, RLLIB_PARITY_STEPS,
         float(np.abs(impala["rewards"]).mean()), None),
        ("dqn", DQNLearner, dict(target_update_freq=RLLIB_PARITY_STEPS), replay,
         RLLIB_PARITY_STEPS, float(np.abs(replay["rewards"]).mean()), value_head),
        ("sac", SACLearner, {}, replay, RLLIB_PARITY_STEPS,
         float(np.abs(replay["rewards"]).mean()), value_head),
        ("bc", BCLearner, {}, replay, RLLIB_PARITY_STEPS, float(np.log(2)),
         value_head),
    ]


def rllib_parity(devices=("cuda", "cpu")) -> dict:
    """[rllib-parity]: RLLIB_PARITY_STEPS optimizer steps of each learner
    (PPO: one minibatch of the whole batch an epoch; the others one update
    a step) from the same initial weights (drawn on the host) and the same
    batch on each of `devices`: every leaf's gradient at every step, the
    parameters and targets, the metrics and |TD| errors held to the first
    device's with the RLLIB_PARITY_* limits."""
    from ray_tpu_torch.rllib.models import tree_leaves

    out = {}
    for name, cls, kw, batch, n_updates, term, unreached in rllib_parity_cases():
        metric_atol = RLLIB_PARITY_METRIC_ATOL * term
        runs = []
        for device in devices:
            learner = cls(obs_dim=4, num_actions=2, seed=0, device=device, **kw)
            grads, step = [], learner._optimizer.step

            def recorded_step(_learner=learner, _step=step, _grads=grads):
                _grads.append([p.grad.detach().to("cpu", copy=True)
                               for p in _learner._leaves])
                return _step()
            learner._optimizer.step = recorded_step
            updates = [learner.update(batch) for _ in range(n_updates)]
            if len(grads) != RLLIB_PARITY_STEPS:
                fail(f"[rllib-parity] {name} on {device}: {len(grads)} "
                     f"optimizer steps, not {RLLIB_PARITY_STEPS}")
            paths = leaf_paths(learner.params)
            zero = {i for i, p in enumerate(paths) if unreached and unreached(p)}
            if any(bool(g[i].any()) for g in grads for i in zero):
                fail(f"[rllib-parity] {name} on {device}: a leaf no loss "
                     f"reaches has a gradient")
            if any(bool((g == 0).any()) for i, g in enumerate(grads[0])
                   if i not in zero):
                fail(f"[rllib-parity] {name} on {device}: a first-step "
                     f"gradient element is 0, where Adam's step is a coin flip")
            metrics = {k: float(np.mean([m[k] for m in updates]))
                       for k in updates[0] if k != "td_errors"}
            td = (np.concatenate([m["td_errors"] for m in updates])
                  if "td_errors" in updates[0] else np.zeros(0))
            state = learner.get_state()
            weights = tree_leaves(state["params"]) + tree_leaves(state.get("target", []))
            runs.append((metrics, td, weights, grads, zero))
        (m0, td0, w0, g0, zero), (m1, td1, w1, g1, _) = runs
        grad_err = max(float((a - b).abs().max() / a.abs().max())
                       for s0, s1 in zip(g0, g1)
                       for i, (a, b) in enumerate(zip(s0, s1)) if i not in zero)
        param_err = max(float(abs(a - b).max()) for a, b in zip(w0, w1))
        metric_err = {k: abs(m0[k] - m1[k]) for k in m0}
        bad = [k for k, e in metric_err.items()
               if e > max(RLLIB_PARITY_METRIC_TOL * abs(m0[k]), metric_atol)]
        if len(td0):
            metric_err["td_errors"] = float(np.abs(td0 - td1).max())
            if (np.abs(td0 - td1) > np.maximum(RLLIB_PARITY_METRIC_TOL * np.abs(td0),
                                               metric_atol)).any():
                bad.append("td_errors")
        log(f"[rllib-parity] {name} {devices[0]} vs {devices[1]}, "
            f"{RLLIB_PARITY_STEPS} steps: gradients max rel "
            f"{grad_err:.3e} over {len(g0[0]) - len(zero)} leaves a step "
            f"({len(zero)} unreached, 0 on both; limit "
            f"{RLLIB_PARITY_GRAD_TOL}); params{' and targets' if len(w0) > len(g0[0]) else ''} "
            f"max abs {param_err:.3e} (limit {RLLIB_PARITY_PARAM_TOL}); metrics "
            + ", ".join(f"{k} {m0[k]:.6g} by {metric_err[k]:.2e}" for k in m0)
            + (f", td_errors ({len(td0)}) by {metric_err['td_errors']:.2e}"
               if len(td0) else "")
            + f" (limit {RLLIB_PARITY_METRIC_TOL} relative or "
            f"{metric_atol:.3e} absolute)")
        if (grad_err > RLLIB_PARITY_GRAD_TOL or param_err > RLLIB_PARITY_PARAM_TOL
                or bad):
            fail(f"[rllib-parity] {name}: the update on {devices[0]} and on "
                 f"{devices[1]} differ (gradients {grad_err:.3e}, params "
                 f"{param_err:.3e}, metrics {bad})")
        out[name] = {"grad_max_rel": grad_err, "param_max_abs": param_err,
                     "metric_max_abs": max(metric_err.values())}
    return out


def rllib_phase(card: str, profile: bool = False, device="cuda") -> dict:
    """Every [rllib-*] phase in turn, each phase's seconds printed."""
    out = {}
    for tag, fn in (("rllib-ppo", lambda: rllib_ppo(card, device, profile)),
                    ("rllib-impala", lambda: rllib_impala(card, device)),
                    ("rllib-dqn", lambda: rllib_dqn(card, device, profile)),
                    ("rllib-sac", lambda: rllib_sac(card, device, profile)),
                    ("rllib-bc", lambda: rllib_bc(card, device)),
                    ("rllib-ma", lambda: rllib_ma(device)),
                    ("rllib-parity", lambda: rllib_parity((device, "cpu")))):
        free_device_memory()
        s = time.perf_counter()
        out[tag] = fn()
        log(f"[{tag}] phase took {time.perf_counter() - s:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# [core] and [trainer]: the runtime's in-process mode and Train on the card
# --------------------------------------------------------------------------- #

def core_phase(card: str) -> dict:
    """ray_tpu_torch.init(local_mode=True) on the card: the GPU resources; a
    remote task (num_gpus=1) that takes q, k, v and do as put refs, runs
    flash_attention forward and backward on its own thread and returns o
    and the gradients, held to the same call on this thread (o bitwise,
    the gradients within the backward kernel's limits), one launch of each
    kernel (counts set to 0 just
    before a second call of the task and read just after it; both calls
    timed); put/get of a CUDA tensor by reference; and the serialization
    hook on a 256 MiB CUDA tensor: one
    out-of-band buffer of exactly its bytes, deserialized to an equal CPU
    tensor, timed (host clock, synchronized). Returns the task's launches."""
    import ray_tpu_torch
    from ray_tpu_torch.core.serialization import deserialize, serialize
    from ray_tpu_torch.ops.attention import flash_attention

    ray_tpu_torch.init(local_mode=True)
    try:
        res = ray_tpu_torch.cluster_resources()
        n = torch.cuda.device_count()
        kind = "GPU-" + torch.cuda.get_device_name(0).lower().replace(" ", "-")
        log(f"[core] cluster_resources: {json.dumps(res)}")
        if res.get("GPU") != n or res.get(kind) != n:
            fail(f"cluster_resources {res}: expected GPU and {kind} = {n}")

        def attend(q, k, v, do):
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = flash_attention(*leaves, layout="bhsd")
            return (o.detach(), *torch.autograd.grad(o, leaves, do))

        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(CORE_SHAPE, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        task = ray_tpu_torch.remote(num_gpus=1)(attend)
        refs = [ray_tpu_torch.put(x) for x in (q, k, v, do)]
        task_ms = []
        for _ in range(2):      # the first call also pays the thread's first
            torch.cuda.synchronize()   # CUDA work: both timed, the second counted
            reset_launches()
            t = time.perf_counter()
            out = ray_tpu_torch.get(task.remote(*refs))
            torch.cuda.synchronize()
            task_ms.append((time.perf_counter() - t) * 1e3)
        launches = launches_since_reset()
        ref = attend(q, k, v, do)
        if not all(x.is_cuda for x in out):
            fail("the remote task's results are not on the card")
        o_equal = torch.equal(out[0], ref[0])
        grads = {g: {"rel_err": rel_err(a, b), "mean_rel_err": mean_rel_err(a, b)}
                 for g, a, b in zip(("dq", "dk", "dv"), out[1:], ref[1:])}
        log(f"[core] remote task flash_attention fwd+bwd {list(CORE_SHAPE)} "
            f"bf16: launches {json.dumps(launches)}, o bitwise equal to this "
            f"thread's call: {o_equal}, gradients {json.dumps(grads)}; "
            f"ms from submit to get, first and second call: {task_ms}")
        if launches != {"flash_fwd": 1, "flash_bwd": 1}:
            fail(f"[core] task launched {launches}, expected one of each")
        if not o_equal:
            fail("[core] the remote task's o differs from this thread's")
        for g, e in grads.items():
            if e["rel_err"] > GRAD_REL_TOL or e["mean_rel_err"] > MEAN_REL_TOL:
                fail(f"[core] the remote task's {g} differs from this thread's: {e}")
        if ray_tpu_torch.get(ray_tpu_torch.put(q)) is not q:
            fail("[core] get(put(t)) is not t for a CUDA tensor in local mode")

        big = torch.randn(SERIALIZE_BYTES // 4, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = serialize(big)
        ser_s = time.perf_counter() - t
        t = time.perf_counter()
        back = deserialize(s)
        de_s = time.perf_counter() - t
        sizes = [b.nbytes for b in s.buffers]
        same = (back.device.type == "cpu" and back.dtype == big.dtype
                and torch.equal(back, big.cpu()))
        log("[core] serialize " + json.dumps(dict(
            card=card, bytes=SERIALIZE_BYTES, buffers=sizes,
            payload_bytes=len(s.payload), serialize_ms=ser_s * 1e3,
            serialize_gb_per_s=SERIALIZE_BYTES / ser_s / 1e9,
            deserialize_ms=de_s * 1e3, equal_to_cpu_copy=same)))
        if sizes != [SERIALIZE_BYTES] or not same:
            fail(f"[core] serialize of a CUDA tensor gave buffers {sizes} "
                 f"(expected [{SERIALIZE_BYTES}]), equal to .cpu(): {same}")
        del big, back, s
    finally:
        ray_tpu_torch.shutdown()
    return launches


def trainer_steps_taken(a: int = TRAINER_A, until: int = TRAINER_UNTIL,
                        ckpt: int = TRAINER_D_CKPT,
                        fail_after: int = TRAINER_D_FAIL) -> dict:
    """The training steps each [trainer] run takes: A to `a`; B from A's
    checkpoint to `until`; C, C2 and C3 straight to `until`; D
    `fail_after` steps on its first attempt (the last one not reported),
    then from its checkpoint at `ckpt` to `until`."""
    return {"A": a, "B": until - a, "C": until, "C2": until, "C3": until,
            "D": fail_after + until - ckpt}


def trainer_launches(n_layer: int, taken: dict) -> int:
    """Launches of each flash kernel over the [trainer] runs: one a layer a
    step, forward and backward (no warm-up step outside the runs)."""
    return n_layer * sum(taken.values())


def resume_limit(straight: list, floor: float = LOSS_TOL,
                 factor: float = TRAINER_RESUME_FACTOR) -> float:
    """The limit on B's losses against C's at the same steps, from the
    straight runs' losses there (a list of lists, C's first): `factor`
    times the largest distance between two of them at one step, at least
    `floor` (TRAINER_RESUME_FACTOR's comment)."""
    spread = max(max(at) - min(at) for at in zip(*straight))
    return max(floor, factor * spread)


def train_tree(state: dict) -> dict:
    """What the [trainer] loop checkpoints: the step's params, ClippedAdamW's
    state_dict (bf16 moments, integer-keyed state, param_groups, count) and
    the step."""
    return {"params": state["params"],
            "opt_state": state["opt_state"].state_dict(),
            "step": state["step"]}


def open_sink(where):
    """(sink, flush) of a trainer loop: `where` is the driver's own dict (local
    mode passes objects by reference; flush does nothing) or the path of a
    JSON file, which outlives the worker process of an attempt (the
    multi-process runtime serializes the config): flush writes it."""
    if isinstance(where, dict):
        return where, lambda: None
    path = Path(where)
    sink = json.loads(path.read_text()) if path.exists() else {}
    return sink, lambda: path.write_text(json.dumps(sink))


def wait_for_reports_taken(settle_s: float = 2.0) -> None:
    """Block until the driver has polled every report of this worker's
    session, then `settle_s` more (its poll returns a second after its last
    item at most), so that a process that dies next loses none."""
    from ray_tpu_torch.train.session import _get_session

    q = _get_session().result_queue
    while not q.empty():
        time.sleep(0.05)
    time.sleep(settle_s)


def trainer_loop(config: dict) -> None:
    """The [trainer] and [cluster-trainer] phases' train_loop_per_worker:
    GPT-2's train step at config["cfg"] on config["device"] from a
    generator seeded 0, restored from the session's checkpoint when there
    is one, on one repeated synthetic batch of config["batch"] rows until
    step config["until"]; each step reports loss, grad_norm, step and
    step_ms (host clock around a synchronized step), with a from_torch
    checkpoint at the steps in config["ckpt_at"] and at the last. With
    config["fail_after"], the first attempt raises after that step, before
    reporting it; with config["die_after"], the first attempt's process
    exits (os._exit) once the driver has that step's report. config["sink"]
    (open_sink) gets the number of attempts, each attempt's start, its
    times (the first step's start, each checkpoint's save and restore, the
    end) and, with config["keep_final"], the final state (with
    config["final_path"], torch.save's of train_tree there instead). With
    config["count_launches"], each row also carries the attempt and the
    kernel launches of this process since the attempt began."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.train_step import (
        default_optimizer, make_gpt2_train_step, synthetic_batch,
    )

    sink, flush = open_sink(config["sink"])
    sink["attempts"] = sink.get("attempts", 0) + 1
    flush()
    if config.get("count_launches"):
        reset_launches()
    cfg, device = config["cfg"], config["device"]
    bundle = make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device=device).manual_seed(0), device=device)
    state = bundle.state
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t = time.perf_counter()
        tree = ckpt.to_torch(target=train_tree(state))
        state["opt_state"].load_state_dict(tree["opt_state"])
        state["step"] = tree["step"]
        sync(device)
        sink.setdefault("restore_s", []).append(time.perf_counter() - t)
    sink.setdefault("starts", []).append(state["step"])
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in synthetic_batch(cfg, config["batch"], seed=0).items()}
    sync(device)
    sink.setdefault("t_first", time.perf_counter())
    flush()
    while state["step"] < config["until"]:
        if sink["attempts"] == 1 and state["step"] == config.get("die_after"):
            wait_for_reports_taken()
            os._exit(1)
        t = time.perf_counter()
        state, m = bundle.step_fn(state, batch)
        sync(device)
        ms = (time.perf_counter() - t) * 1e3
        step = state["step"]
        if sink["attempts"] == 1 and step == config.get("fail_after"):
            raise RuntimeError(f"injected failure after step {step}")
        ckpt = None
        if step in config.get("ckpt_at", ()) or step == config["until"]:
            t = time.perf_counter()
            ckpt = train.Checkpoint.from_torch(
                train_tree(state),
                path=os.path.join(config["root"], f"{config['name']}-{step}"))
            sink.setdefault("save_s", []).append(time.perf_counter() - t)
            flush()
        row = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
               "step": step, "step_ms": ms}
        if config.get("count_launches"):
            row.update(attempt=sink["attempts"], **launches_since_reset())
        train.report(row, checkpoint=ckpt)
    if config.get("final_path"):
        torch.save(train_tree(state), config["final_path"])
    elif config.get("keep_final"):
        sink["final"] = {"params": state["params"], "opt": state["opt_state"],
                         "step": state["step"]}
    sink["t_done"] = time.perf_counter()
    flush()


def check_restore(cfg, checkpoint, final: dict, device) -> None:
    """`checkpoint` (run A's) restored by to_torch into a fresh train state
    on `device` against A's final state: every param, both moments (and
    their dtype), the step and the optimizer's count bitwise."""
    from ray_tpu_torch.train.train_step import (
        default_optimizer, make_gpt2_train_step, named_leaves,
    )

    fresh = make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device=device).manual_seed(0), device=device)
    tree = checkpoint.to_torch(target=train_tree(fresh.state))
    opt = fresh.state["opt_state"]
    opt.load_state_dict(tree["opt_state"])
    params = dict(named_leaves(fresh.state["params"]))
    differ = [n for n, p in named_leaves(final["params"])
              if not (params[n].device == p.device and torch.equal(params[n], p))]
    old = final["opt"]
    for i, (p, q) in enumerate(zip(opt.param_groups[0]["params"],
                                   old.param_groups[0]["params"])):
        for k in ("mu", "nu"):
            a, b = opt.state[p][k], old.state[q][k]
            if a.dtype != b.dtype or not torch.equal(a, b):
                differ.append(f"{k}[{i}]")
    if tree["step"] != final["step"] or opt.count != old.count:
        differ.append(f"step {tree['step']} count {opt.count}, expected "
                      f"{final['step']} and {old.count}")
    log(f"[trainer] A's checkpoint restored into a fresh state on {device}: "
        f"{len(params)} params and their moments, step {tree['step']}, count "
        f"{opt.count}; differing: {differ}")
    if differ:
        fail(f"[trainer] to_torch did not restore A's state bitwise: {differ}")


def trainer_phase(card: str, train_step_ms: Optional[float], device="cuda",
                  cfg=None, batch: int = TRAIN_BATCH) -> dict:
    """TorchTrainer(trainer_loop, scaling_config=ScalingConfig(num_workers=1,
    use_gpu=True)).fit() on init(local_mode=True), GPT-2 at `cfg`
    (gpt2_124m(remat=False) by default) and `batch` on `device` (on the CPU
    no kernel launches, so none is expected): runs A, B (resumed from
    A's checkpoint), C, C2 and C3 (straight), D (FailureConfig(
    max_failures=1) over a loop that fails once). Each fit must end without error with one
    metrics row a report and finite losses; C's losses fall; A's checkpoint
    restores A's state bitwise; B's losses sit within resume_limit of C's;
    D retries from its step-2 checkpoint and reports 8 steps; each flash
    kernel launches trainer_launches times (counts set to 0 just before the
    first fit, read just after the last). Prints each fit's seconds (set-up
    to the first step, the first step, teardown after the last report) and
    peak memory, and the median steady step_ms beside [train]'s. Returns
    the launches and that median."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchTrainer,
    )

    cfg = cfg or gpt2.gpt2_124m(remat=False)
    on_card = torch.device(device).type == "cuda"
    taken = trainer_steps_taken()
    runs = {}
    ray_tpu_torch.init(local_mode=True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as root:
            def fit(name, first, resume=None, failures=0, **loop):
                free_device_memory()
                held = torch.cuda.memory_allocated() if on_card else None
                sink = {}
                trainer = TorchTrainer(
                    trainer_loop,
                    train_loop_config={"name": name, "root": root,
                                       "sink": sink, "until": TRAINER_UNTIL,
                                       "cfg": cfg, "device": device,
                                       "batch": batch, **loop},
                    scaling_config=ScalingConfig(num_workers=1,
                                                 use_gpu=on_card),
                    run_config=RunConfig(
                        name=f"chip-smoke-{name}",
                        failure_config=FailureConfig(max_failures=failures)),
                    resume_from_checkpoint=resume)
                t0 = time.perf_counter()
                result = trainer.fit()
                t1 = time.perf_counter()
                if result.error is not None:
                    fail(f"[trainer] fit {name} failed: {result.error!r}")
                rows = result.metrics_dataframe
                steps = [r["step"] for r in rows]
                losses = [r["loss"] for r in rows]
                until = loop.get("until", TRAINER_UNTIL)
                if steps != list(range(first, until + 1)):
                    fail(f"[trainer] fit {name} reported steps {steps}")
                if not all(map(math.isfinite, losses + [r["grad_norm"] for r in rows])):
                    fail(f"[trainer] fit {name}: non-finite loss or grad norm")
                run = dict(result=result, sink=sink, loss=losses, steps=steps,
                           step_ms=[r["step_ms"] for r in rows],
                           fit_s=t1 - t0, setup_s=sink["t_first"] - t0,
                           first_step_ms=rows[0]["step_ms"],
                           teardown_s=t1 - sink["t_done"],
                           peak_memory_bytes=peak_memory(device),
                           held_at_start_bytes=held,
                           attempts=sink["attempts"], starts=sink["starts"],
                           save_s=sink["save_s"],
                           restore_s=sink.get("restore_s", []))
                log(f"[trainer] fit {name}: " + json.dumps(
                    {k: v for k, v in run.items() if k not in ("result", "sink")}))
                return run

            reset_launches()
            runs["A"] = fit("A", 1, until=TRAINER_A, keep_final=True)
            runs["B"] = fit("B", TRAINER_A + 1,
                            resume=runs["A"]["result"].checkpoint)
            runs["C"] = fit("C", 1)
            runs["C2"] = fit("C2", 1)
            runs["C3"] = fit("C3", 1)
            runs["D"] = fit("D", 1, failures=1, ckpt_at=(TRAINER_D_CKPT,),
                            fail_after=TRAINER_D_FAIL)
            launches = launches_since_reset()
            free_device_memory()
            if on_card:     # what the backend still holds of the fits
                log(f"[trainer] held after the fits: "
                    f"{torch.cuda.memory_allocated()} bytes")
            check_restore(cfg, runs["A"]["result"].checkpoint,
                          runs["A"]["sink"]["final"], device)
    finally:
        ray_tpu_torch.shutdown()

    expected = trainer_launches(cfg.n_layer, taken) if on_card else 0
    log(f"[trainer] launches {json.dumps(launches)} (expected {expected} "
        f"each: {cfg.n_layer} a step of the runs' {json.dumps(taken)}"
        f"{'' if on_card else ', none on the CPU'})")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"[trainer] launched {launches}, expected {expected} each")
    c, b = runs["C"]["loss"], runs["B"]["loss"]
    if not c[-1] < c[0]:
        fail(f"[trainer] C's loss did not fall: {c}")
    straight = [runs[n]["loss"][TRAINER_A:] for n in ("C", "C2", "C3")]
    limit = resume_limit(straight)

    def from_c(x):
        return max(abs(p - q) for p, q in zip(x, straight[0]))

    d_tail = runs["D"]["loss"][TRAINER_A:]
    log("[trainer] resume " + json.dumps(dict(
        B=b, C=straight[0], C2=straight[1], C3=straight[2], D=d_tail,
        B_vs_C=from_c(b), C2_vs_C=from_c(straight[1]),
        C3_vs_C=from_c(straight[2]), D_vs_C=from_c(d_tail), limit=limit)))
    distance = from_c(b)
    if distance > limit:
        fail(f"[trainer] B's losses are {distance} from C's, limit {limit}")
    d = runs["D"]
    if d["attempts"] != 2 or d["starts"] != [0, TRAINER_D_CKPT]:
        fail(f"[trainer] D ran {d['attempts']} attempts from steps "
             f"{d['starts']}, expected 2 from [0, {TRAINER_D_CKPT}]")
    steady = sorted(ms for r in runs.values()
                    for step, ms in zip(r["steps"], r["step_ms"])
                    if step - 1 not in r["starts"])  # an attempt's first step
    median = steady[len(steady) // 2]
    log("[trainer] " + json.dumps(dict(
        card=card, n_layer=cfg.n_layer, d_model=cfg.d_model, batch=batch,
        seq_len=cfg.seq_len, steady_step_ms_median=median,
        train_step_ms_median=train_step_ms,
        through_trainer_minus_train_ms=None if train_step_ms is None
        else median - train_step_ms,
        fit_s={n: r["fit_s"] for n, r in runs.items()},
        peak_memory_bytes={n: r["peak_memory_bytes"] for n, r in runs.items()})))
    return {"launches": launches, "step_ms_median": median,
            "straight_loss": c, "resume_limit": limit}


# --------------------------------------------------------------------------- #
# [cluster] and [cluster-trainer]: the multi-process runtime on one node
# --------------------------------------------------------------------------- #

def cluster_attend(q, k, v, do, device):
    """[cluster]'s GPU task: q, k, v and do arrive as CPU tensors (put refs,
    their bytes through the node's shm store); on `device`, flash_attention
    forward and backward, its own launch counts set to 0 just before and
    read just after. Returns o and the gradients (back on the CPU), the
    launches, this process's pid, the jax / ray_tpu modules it holds, the
    kernels it had to build (none: the driver built them) and the seconds
    of its steps (the libraries' load on the card, the forward, the
    backward; a fresh process's first call pays its first CUDA work)."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    times = {}
    t = time.perf_counter()
    leaves = [x.to(device).requires_grad_(True) for x in (q, k, v)]
    do = do.to(device)
    sync(device)
    times["to_device_s"] = time.perf_counter() - t
    if device != "cpu":
        t = time.perf_counter()
        for name in (A.KERNEL, A.BWD_KERNEL):
            _build.load(name)
        times["load_s"] = time.perf_counter() - t
    reset_launches()
    t = time.perf_counter()
    o = A.flash_attention(*leaves, layout="bhsd")
    sync(device)
    times["forward_s"] = time.perf_counter() - t
    t = time.perf_counter()
    grads = torch.autograd.grad(o, leaves, do)
    sync(device)
    times["backward_s"] = time.perf_counter() - t
    launches = launches_since_reset()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
    return (o.detach().cpu(), *(g.cpu() for g in grads), launches,
            os.getpid(), bad, sorted(_build.build_logs), times)


def cluster_stamp(hold_s: float):
    """[cluster]'s lease check: this process's pid and the host clock at
    the task's start and end, `hold_s` apart."""
    t0 = time.time()
    time.sleep(hold_s)
    return os.getpid(), t0, time.time()


def cluster_card(barrier: str, device, timeout_s: float = 120.0):
    """[cluster]'s card check, in a worker: the cards its lease named
    (CUDA_VISIBLE_DEVICES), the UUID of the card it sees as its device
    (None on the CPU), its pid, and whether the other task of the pair was
    running at the same time (each leaves a file in `barrier` and waits up
    to `timeout_s` for the other's)."""
    uuid = None
    if device != "cpu":
        torch.zeros(1, device=device)
        uuid = str(torch.cuda.get_device_properties(
            torch.cuda.current_device()).uuid)
    Path(barrier, str(os.getpid())).touch()
    deadline = time.monotonic() + timeout_s
    while len(os.listdir(barrier)) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), uuid, os.getpid(),
            len(os.listdir(barrier)) >= 2)


def multi_card_leases(device="cuda") -> None:
    """With 2 or more cards on the running cluster: two @remote(num_gpus=1)
    tasks run at the same time (cluster_card) on different cards, their
    leases naming different cards and, on the card, their devices
    different UUIDs. With one card it says that the run did not take
    place."""
    import tempfile

    import ray_tpu_torch

    if ray_tpu_torch.cluster_resources().get("GPU", 0) < 2:
        log("[cluster] two num_gpus=1 tasks on two cards: did not take place "
            "(one card; proved on the CPU with two GPUs as a resource)")
        return
    task = ray_tpu_torch.remote(num_gpus=1)(cluster_card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as barrier:
        out = ray_tpu_torch.get([task.remote(barrier, device)
                                 for _ in range(2)], timeout=300)
    (va, ua, pa, ta), (vb, ub, pb, tb) = out
    log(f"[cluster] two num_gpus=1 tasks: pids {[pa, pb]}, "
        f"CUDA_VISIBLE_DEVICES {[va, vb]}, device UUIDs {[ua, ub]}, both "
        f"running at once {[ta, tb]}")
    if not (ta and tb) or va is None or va == vb or (
            device != "cpu" and ua == ub):
        fail(f"[cluster] two num_gpus=1 tasks did not run at once on "
             f"different cards: {out}")


def cluster_cuda_start(device):
    """A fresh worker's first work on `device`: the seconds its CUDA
    context takes to start (one tiny op, synchronized), and its pid."""
    t = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    return time.perf_counter() - t, os.getpid()


def cluster_die_once(q, k, v, do, device, marker):
    """[cluster]'s retry check: the first attempt writes its pid and the
    host clock to `marker` and exits; the next, in another worker process,
    starts its CUDA context and runs cluster_attend. Returns the host
    clock at its start, its context's seconds and cluster_attend's
    results."""
    if not os.path.exists(marker):
        Path(marker).write_text(json.dumps([os.getpid(), time.time()]))
        os._exit(1)
    start = time.time()
    t = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    return (start, time.perf_counter() - t,
            *cluster_attend(q, k, v, do, device))


def cluster_transfer(refs, device):
    """[cluster]'s transfer, in a worker: get the tensor behind refs[0]
    (put by the driver from its card: the bytes come out of the shm store,
    and the read-only view is copied once into a CPU tensor), move it
    onto `device`, put that CUDA tensor (its one D2H copy, then the shm
    write). Returns the three times in seconds and the new ref."""
    import ray_tpu_torch

    t = time.perf_counter()
    x = ray_tpu_torch.get(refs[0], timeout=300)
    get_s = time.perf_counter() - t
    t = time.perf_counter()
    y = x.to(device)
    sync(device)
    to_s = time.perf_counter() - t
    t = time.perf_counter()
    ref = ray_tpu_torch.put(y)
    put_s = time.perf_counter() - t
    return get_s, to_s, put_s, [ref]


def nvidia_device_files(pid: int) -> list:
    """The /dev/nvidia* files process `pid` holds open: a process with a
    CUDA context holds some; one that only loaded the CUDA libraries (an
    import of torch maps libcuda) holds none."""
    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


def gpu_memory_used_mib() -> Optional[float]:
    """nvidia-smi's memory.used of card 0 (MiB), or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def import_seconds(module: str = "ray_tpu_torch") -> float:
    """A fresh process's import of `module`: ray_tpu_torch is what every
    daemon and worker of the runtime pays once (it imports no torch), torch
    what a worker pays as it starts, before it registers."""
    code = (f"import time; t = time.perf_counter(); import {module}; "
            "print(time.perf_counter() - t)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    return float(out.stdout.strip().splitlines()[-1])


def compute_apps() -> dict:
    """pid → used memory (MiB) of every process with a context on a card,
    as nvidia-smi lists them (empty without nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    apps = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1]) if parts[1].replace(".", "").isdigit() else None
    return apps


def maps_cuda_driver(pid: int) -> bool:
    """Whether process `pid` has the CUDA driver library mapped: a process
    that never asked CUDA for anything has not."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def cluster_processes(*keys: str) -> list:
    """Live processes of the port's runtime (its daemons, workers and
    rt_transfer daemons) that carry one of these keys (node ids, sessions)
    in their command line or environment. An exited process that waits to be
    reaped (a killed raylet's daemon, re-parented) is not live."""
    keys = [k.encode() for k in keys]
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            if b"ray_tpu_torch.core" not in cmd and b"rt_transfer" not in cmd:
                continue
            if Path(f"/proc/{pid}/stat").read_text().split(")")[-1].split()[0] == "Z":
                continue
            env = Path(f"/proc/{pid}/environ").read_bytes()
        except OSError:
            continue
        if any(k in cmd or k in env for k in keys):
            out.append(int(pid))
    return out


def cluster_phase(card: str, device="cuda", init_kwargs=None,
                  shape=CORE_SHAPE, transfer_bytes=SERIALIZE_BYTES) -> dict:
    """[cluster]: ray_tpu_torch.init(**init_kwargs) without local mode, a
    GCS, a raylet and worker processes on this node (left running for
    [cluster-trainer]; cluster_teardown stops them). Checks:
    cluster_resources() reports GPU (and on the card GPU-<kind>) equal to
    the cards; neither the GCS nor the raylet holds a CUDA context (no
    /dev/nvidia* file open; whether each has the CUDA driver library
    mapped, and nvidia-smi's compute apps, are printed beside); a
    @remote(num_gpus=1)
    task in a worker process (cluster_attend) gets q, k, v and do as put
    refs and returns o, dk and dv bitwise equal to this process's own call
    and dq within the backward kernel's limits, one launch of each kernel,
    a pid not this one, no jax and no ray_tpu module and no kernel built;
    two GPU tasks on one card do not overlap (their stamps); a GPU task
    whose first attempt exits is retried in another worker process and
    returns the same o. Prints: a fresh process's import of ray_tpu_torch,
    init() to the first result, a warm no-op GPU task's round trip, a
    fresh worker's CUDA context start and the card memory it takes
    (nvidia-smi's memory.used before and after), and a `transfer_bytes`
    CUDA tensor put here, got in a worker and moved onto its card, put
    there and got and moved back here, in GB/s each step.
    Returns the cluster's identity, its workers and the task's launches."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.api import _global_worker

    on_card = torch.device(device).type == "cuda"
    init_kwargs = dict(init_kwargs or {})
    cards = torch.cuda.device_count() if on_card else init_kwargs.get("num_gpus", 0)
    gpu_task = ray_tpu_torch.remote(num_gpus=1)
    import_s = ({m: import_seconds(m) for m in ("torch", "ray_tpu_torch")}
                if on_card else None)
    mem_before = gpu_memory_used_mib() if on_card else None
    t0 = time.perf_counter()
    ray_tpu_torch.init(**init_kwargs)
    backend = _global_worker().backend
    ctx = {"node_id": backend.core.node_id, "session": backend.core.session,
           "daemons": {n: p.pid for n, p in zip(("gcs", "raylet"),
                                                 backend._procs.procs)},
           "workers": set()}
    res = ray_tpu_torch.cluster_resources()
    log(f"[cluster] cluster_resources: {json.dumps(res)}; daemons "
        f"{json.dumps(ctx['daemons'])}")
    if res.get("GPU", 0) != cards:
        fail(f"[cluster] cluster_resources {res}: expected GPU = {cards}")
    if on_card:
        kind = "GPU-" + torch.cuda.get_device_name(0).lower().replace(" ", "-")
        if res.get(kind) != cards:
            fail(f"[cluster] cluster_resources {res}: expected {kind} = {cards}")

    noop = gpu_task(os.getpid)
    first = ray_tpu_torch.get(noop.remote(), timeout=300)
    init_to_first_s = time.perf_counter() - t0
    warm = []
    for _ in range(10):
        t = time.perf_counter()
        ray_tpu_torch.get(noop.remote(), timeout=60)
        warm.append((time.perf_counter() - t) * 1e3)
    mem_idle = gpu_memory_used_mib() if on_card else None
    start_s, start_pid = ray_tpu_torch.get(
        gpu_task(cluster_cuda_start).remote(device), timeout=300)
    mem_context = gpu_memory_used_mib() if on_card else None
    ctx["workers"].update({first, start_pid})

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    from ray_tpu_torch.ops.attention import flash_attention

    o = flash_attention(*leaves, layout="bhsd")
    ref = (o.detach(), *torch.autograd.grad(o, leaves, do))
    refs = [ray_tpu_torch.put(x) for x in (q, k, v, do)]
    t = time.perf_counter()
    (wo, wdq, wdk, wdv, launches, pid, bad, built, times) = ray_tpu_torch.get(
        gpu_task(cluster_attend).remote(*refs, device), timeout=300)
    task_ms = (time.perf_counter() - t) * 1e3
    ctx["workers"].add(pid)
    out = [x.to(device) for x in (wo, wdq, wdk, wdv)]
    bitwise = {n: torch.equal(a, b) for n, a, b in
               zip(("o", "dk", "dv"), (out[0], out[2], out[3]),
                   (ref[0], ref[2], ref[3]))}
    dq = {"rel_err": rel_err(out[1], ref[1]),
          "mean_rel_err": mean_rel_err(out[1], ref[1])}
    expected = {"flash_fwd": 1, "flash_bwd": 1} if on_card else \
        {"flash_fwd": 0, "flash_bwd": 0}
    log(f"[cluster] num_gpus=1 task in worker pid {pid} (driver {os.getpid()}):"
        f" flash_attention fwd+bwd {list(shape)} bf16 from put refs: launches "
        f"{json.dumps(launches)}, bitwise equal to this process's call "
        f"{json.dumps(bitwise)}, dq {json.dumps(dq)}, jax/ray_tpu modules "
        f"{bad}, kernels built in the worker {built}; ms submit to get "
        f"{task_ms}, the worker's steps {json.dumps(times)}")
    if pid == os.getpid():
        fail(f"[cluster] the GPU task ran in the driver process ({pid})")
    if launches != expected:
        fail(f"[cluster] the worker launched {launches}, expected {expected}")
    if not all(bitwise.values()):
        fail(f"[cluster] the worker's o, dk, dv differ from this process's: "
             f"{bitwise}")
    if dq["rel_err"] > GRAD_REL_TOL or dq["mean_rel_err"] > MEAN_REL_TOL:
        fail(f"[cluster] the worker's dq differs from this process's: {dq}")
    if bad or built:
        fail(f"[cluster] the worker holds {bad} and built {built}")

    hold = 1.0
    stamps = ray_tpu_torch.get(
        [gpu_task(cluster_stamp).options(num_gpus=cards).remote(hold)
         for _ in range(2)], timeout=300)
    (pa, a0, a1), (pb, b0, b1) = sorted(stamps, key=lambda s: s[1])
    ctx["workers"].update({pa, pb})
    log(f"[cluster] two tasks holding all {cards} GPU(s) {hold} s each: "
        f"[{a0:.3f}, {a1:.3f}] and [{b0:.3f}, {b1:.3f}]")
    if b0 < a1:
        fail("[cluster] two GPU tasks ran at once on the same card(s)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as root:
        marker = os.path.join(root, "first-attempt")
        t, submitted = time.perf_counter(), time.time()
        (started, retry_start_s, ro, _, _, _, rlaunches, rpid, _, _,
         rtimes) = ray_tpu_torch.get(gpu_task(cluster_die_once).options(
             max_retries=2).remote(*refs, device, marker), timeout=300)
        retry_s = time.perf_counter() - t
        died, died_at = json.loads(Path(marker).read_text())
    seen = rpid in ctx["workers"]
    ctx["workers"].update({died, rpid})
    same_o = torch.equal(ro.to(device), ref[0])
    log(f"[cluster] retried task: first attempt's pid {died} exited "
        f"{died_at - submitted:.3f} s after the submit, the retry started in "
        f"pid {rpid} {started - died_at:.3f} s after that (CUDA context "
        f"{retry_start_s * 1e3:.1f} ms, a worker that had run a task before: "
        f"{seen}, its steps {json.dumps(rtimes)}), o bitwise equal: {same_o}, "
        f"launches {json.dumps(rlaunches)}; {retry_s:.3f} s submit to get")
    if rpid in (died, os.getpid()) or not same_o or rlaunches != expected:
        fail(f"[cluster] the crashed GPU task was not retried right: pids "
             f"{died} -> {rpid}, o equal {same_o}, launches {rlaunches}")

    big = torch.randn(transfer_bytes // 4, generator=gen, device=device)
    sync(device)
    t = time.perf_counter()
    big_ref = ray_tpu_torch.put(big)
    put_s = time.perf_counter() - t
    get_s, to_card_s, wput_s, (back_ref,) = ray_tpu_torch.get(
        gpu_task(cluster_transfer).remote([big_ref], device), timeout=300)
    t = time.perf_counter()
    back = ray_tpu_torch.get(back_ref, timeout=300)
    back_get_s = time.perf_counter() - t
    t = time.perf_counter()
    back = back.to(device)
    sync(device)
    back_to_s = time.perf_counter() - t
    if not torch.equal(back, big):
        fail("[cluster] the tensor that went to a worker and back differs")
    del big, back, big_ref, back_ref

    def gbps(s):
        return transfer_bytes / s / 1e9

    live = [p for p in sorted(ctx["workers"]) if Path(f"/proc/{p}").exists()]
    dfiles = {n: nvidia_device_files(p) for n, p in ctx["daemons"].items()}
    wfiles = {p: nvidia_device_files(p) for p in live}
    apps = compute_apps()
    log("[cluster] " + json.dumps(dict(
        card=card, fresh_process_import_s=import_s,
        init_to_first_result_s=init_to_first_s,
        warm_noop_gpu_task_ms=warm,
        warm_noop_gpu_task_ms_median=sorted(warm)[len(warm) // 2],
        fresh_worker_cuda_context_s=start_s,
        card_memory_used_mib=dict(before_init=mem_before, idle_workers=mem_idle,
                                  after_one_context=mem_context),
        one_worker_context_mib=None if mem_context is None
        else mem_context - mem_idle,
        retried_worker_cuda_context_s=retry_start_s, retried_task_s=retry_s,
        transfer_bytes=transfer_bytes,
        driver_put_s=put_s, driver_put_gb_per_s=gbps(put_s),
        worker_get_s=get_s, worker_get_gb_per_s=gbps(get_s),
        worker_to_card_s=to_card_s, worker_to_card_gb_per_s=gbps(to_card_s),
        worker_put_s=wput_s, worker_put_gb_per_s=gbps(wput_s),
        driver_get_s=back_get_s, driver_get_gb_per_s=gbps(back_get_s),
        driver_to_card_s=back_to_s, driver_to_card_gb_per_s=gbps(back_to_s),
        daemons_nvidia_files=dfiles, live_workers_nvidia_files=wfiles,
        daemons_libcuda_mapped={n: maps_cuda_driver(p)
                                for n, p in ctx["daemons"].items()},
        compute_apps_mib=apps)))
    # nvidia-smi's compute apps are printed only: in a container of its own
    # PID namespace they show pids of the host's, never this one's
    if any(dfiles.values()):
        fail(f"[cluster] a daemon holds the card's device files: {dfiles}")
    ctx["launches"] = launches
    return ctx


def check_restore_saved(cfg, checkpoint, saved_path: str, device) -> None:
    """A worker's from_torch checkpoint restored by to_torch here into a
    fresh train state on `device` against the train_tree the worker
    torch.save'd at the same step: every param, both moments (and their
    dtype), the step and the optimizer's count bitwise."""
    from ray_tpu_torch.train.train_step import (
        default_optimizer, make_gpt2_train_step, named_leaves,
    )

    fresh = make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device=device).manual_seed(0), device=device)
    tree = checkpoint.to_torch(target=train_tree(fresh.state))
    opt = fresh.state["opt_state"]
    opt.load_state_dict(tree["opt_state"])
    saved = torch.load(saved_path, map_location=device, weights_only=False)
    want = dict(named_leaves(saved["params"]))
    differ = [n for n, p in named_leaves(fresh.state["params"])
              if not (p.device == want[n].device and torch.equal(p, want[n]))]
    mine = opt.state_dict()
    for i, st in saved["opt_state"]["state"].items():
        for key in ("mu", "nu"):
            a, b = mine["state"][i][key], st[key]
            if a.dtype != b.dtype or not torch.equal(a, b):
                differ.append(f"{key}[{i}]")
    count = saved["opt_state"].get("count")
    if tree["step"] != saved["step"] or opt.count != count:
        differ.append(f"step {tree['step']} count {opt.count}, expected "
                      f"{saved['step']} and {count}")
    log(f"[cluster-trainer] the worker's checkpoint restored here into a "
        f"fresh state on {device}: {len(want)} params and their moments, step "
        f"{tree['step']}, count {opt.count}; differing: {differ}")
    if differ:
        fail(f"[cluster-trainer] to_torch did not restore the worker's state "
             f"bitwise: {differ}")


def cluster_trainer_phase(card: str, reference: dict, train_step_ms=None,
                          device="cuda", cfg=None,
                          batch: int = TRAIN_BATCH) -> dict:
    """[cluster-trainer]: TorchTrainer(trainer_loop, ScalingConfig(
    num_workers=1, use_gpu=...)).fit() on the running cluster: GPT-2 at
    `cfg` (gpt2_124m(remat=False)) and `batch` in a worker process. Run E
    trains straight to TRAINER_UNTIL: its losses fall and sit within
    [trainer]'s resume limit of [trainer]'s straight run C (`reference`:
    its losses and limit, same weights and batch); its final from_torch
    checkpoint, written in the worker, restores here bitwise against the
    state the worker saved (check_restore_saved). Run F, under
    FailureConfig(max_failures=1), checkpoints at step TRAINER_D_CKPT and
    its worker process exits right after it (a real process death); the
    retry starts from that checkpoint in a new process and reports to
    TRAINER_UNTIL. Each kernel 12 launches a step (counted in the workers).
    Prints each fit's set-up, first step and teardown seconds and the
    median steady step ms beside [trainer]'s and [train]'s. With 2 or more
    cards, then multi_card_trainer."""
    import tempfile

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchTrainer,
    )

    cfg = cfg or gpt2.gpt2_124m(remat=False)
    on_card = torch.device(device).type == "cuda"
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_trainer_") as root:
        def fit(name, failures=0, **loop):
            sink = os.path.join(root, f"{name}.sink.json")
            trainer = TorchTrainer(
                trainer_loop,
                train_loop_config={"name": name, "root": root, "sink": sink,
                                   "until": TRAINER_UNTIL, "cfg": cfg,
                                   "device": device, "batch": batch,
                                   "count_launches": True, **loop},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
                run_config=RunConfig(
                    name=f"chip-smoke-cluster-{name}",
                    failure_config=FailureConfig(max_failures=failures)))
            t0 = time.perf_counter()
            result = trainer.fit()
            t1 = time.perf_counter()
            if result.error is not None:
                fail(f"[cluster-trainer] fit {name} failed: {result.error!r}")
            rows = result.metrics_dataframe
            sink = json.loads(Path(sink).read_text())
            steps = [r["step"] for r in rows]
            losses = [r["loss"] for r in rows]
            if steps != list(range(1, TRAINER_UNTIL + 1)):
                fail(f"[cluster-trainer] fit {name} reported steps {steps}")
            if not all(map(math.isfinite, losses + [r["grad_norm"] for r in rows])):
                fail(f"[cluster-trainer] fit {name}: non-finite loss or grad norm")
            last = {}
            for r in rows:      # each attempt's count at its last row
                last[r["attempt"]] = {k: r[k] for k in ("flash_fwd", "flash_bwd")}
            launches = {k: sum(c[k] for c in last.values())
                        for k in ("flash_fwd", "flash_bwd")}
            run = dict(result=result, loss=losses, steps=steps,
                       step_ms=[r["step_ms"] for r in rows], fit_s=t1 - t0,
                       setup_s=sink["t_first"] - t0,
                       first_step_ms=rows[0]["step_ms"],
                       teardown_s=t1 - sink["t_done"],
                       attempts=sink["attempts"], starts=sink["starts"],
                       save_s=sink["save_s"],
                       restore_s=sink.get("restore_s", []), launches=launches)
            log(f"[cluster-trainer] fit {name}: " + json.dumps(
                {k: v for k, v in run.items() if k != "result"}))
            return run

        final = os.path.join(root, "E-final.pt")
        runs["E"] = fit("E", final_path=final)
        runs["F"] = fit("F", failures=1, ckpt_at=(TRAINER_D_CKPT,),
                        die_after=TRAINER_D_CKPT)
        check_restore_saved(cfg, runs["E"]["result"].checkpoint, final, device)

    per_step = cfg.n_layer if on_card else 0
    for name, r in runs.items():
        want = per_step * TRAINER_UNTIL
        if r["launches"] != {"flash_fwd": want, "flash_bwd": want}:
            fail(f"[cluster-trainer] fit {name} launched {r['launches']} in "
                 f"its workers, expected {want} each")
    e = runs["E"]["loss"]
    if not e[-1] < e[0]:
        fail(f"[cluster-trainer] E's loss did not fall: {e}")
    straight, limit = reference["straight_loss"], reference["resume_limit"]
    distance = max(abs(a - b) for a, b in zip(e, straight))
    log("[cluster-trainer] E against [trainer]'s straight run C " + json.dumps(
        dict(E=e, C=straight, distance=distance, limit=limit)))
    if distance > limit:
        fail(f"[cluster-trainer] E's losses are {distance} from [trainer]'s "
             f"C, limit {limit}")
    f = runs["F"]
    if f["attempts"] != 2 or f["starts"] != [0, TRAINER_D_CKPT]:
        fail(f"[cluster-trainer] F ran {f['attempts']} attempts from steps "
             f"{f['starts']}, expected 2 from [0, {TRAINER_D_CKPT}]")
    steady = sorted(ms for r in runs.values()
                    for step, ms in zip(r["steps"], r["step_ms"])
                    if step - 1 not in r["starts"])
    median = steady[len(steady) // 2]
    log("[cluster-trainer] " + json.dumps(dict(
        card=card, n_layer=cfg.n_layer, d_model=cfg.d_model, batch=batch,
        seq_len=cfg.seq_len, steady_step_ms_median=median,
        trainer_step_ms_median=reference.get("step_ms_median"),
        train_step_ms_median=train_step_ms,
        setup_s={n: r["setup_s"] for n, r in runs.items()},
        first_step_ms={n: r["first_step_ms"] for n, r in runs.items()},
        teardown_s={n: r["teardown_s"] for n, r in runs.items()},
        fit_s={n: r["fit_s"] for n, r in runs.items()})))
    return {"launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in ("flash_fwd", "flash_bwd")},
            "step_ms_median": median}


def dp_trainer_loop(config: dict) -> None:
    """multi_card_trainer's loop: this rank's share of the plan's model over
    MeshSpec(dp=world) on the group setup_torch_distributed joined, on
    config["device"], as mesh_rank trains (train_run), reported as one
    row."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.train.train_step import make_gpt2_train_step, synthetic_batch

    device, plan = config["device"], config["plan"]
    _, cfg = plan_model(plan)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(dp=dist.get_world_size()), device)
    run = train_run(make_gpt2_train_step, cfg,
                    synthetic_batch(cfg, plan["batch"], seed=0), device,
                    TRAIN_STEPS, mesh)
    on_card = torch.device(device).type == "cuda"
    train.report({**{k: run[k] for k in ("first", "loss", "grad_norm",
                                          "step_ms", "launches", "collectives")},
                  "cp_rank": mesh.get_local_rank("cp"),
                  "pp_rank": mesh.get_local_rank("pp"),
                  "peak_memory_bytes": peak_memory(device),
                  "device": str(torch.cuda.get_device_properties(
                      torch.cuda.current_device()).uuid) if on_card else None,
                  "pid": os.getpid()})


def multi_card_trainer(card: str, ref: dict, device="cuda",
                       config: str = "gpt2_124m",
                       batch: int = TRAIN_BATCH) -> None:
    """With 2 or more cards, on the running cluster: TorchTrainer(
    dp_trainer_loop, ScalingConfig(num_workers=2, use_gpu=True)).fit(), two
    worker processes in a placement group (a card each) in one NCCL group,
    GPT-2-124M over dp 2, held to the world-1 mesh step `ref` as the fsdp
    plan is (hold_to_world_one). With one card it says that the run did not
    take place. On the CPU (device="cpu", a small `config`) the same over
    gloo."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.device_count() < 2:
        log("[cluster-trainer] multi-card run (TorchTrainer num_workers=2 "
            "over NCCL): did not take place (one card; proved on the CPU "
            "over gloo)")
        return
    plan = {"name": "trainer_dp2", "model": "gpt2", "config": config,
            "mesh": {"dp": 2}, "batch": batch}
    result = TorchTrainer(
        dp_trainer_loop, train_loop_config={"plan": plan, "device": device},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=on_card)).fit()
    if result.error is not None:
        fail(f"[cluster-trainer] dp 2 fit failed: {result.error!r}")
    ranks = [result.metrics_dataframe[0]["_all_ranks"][r] for r in range(2)]
    log(f"[cluster-trainer] dp 2 ranks on cards "
        f"{[r['device'] for r in ranks]}, pids {[r['pid'] for r in ranks]}")
    if on_card and len({r["device"] for r in ranks}) != 2:
        fail("[cluster-trainer] the two train workers share a card")
    hold_to_world_one(card, plan, ranks, ref, device)


# --------------------------------------------------------------------------- #
# [data] in the in-process runtime; [data-train], [data-serve] and
# [rllib-remote] on [cluster]'s running cluster
# --------------------------------------------------------------------------- #

# [data]: 1 GiB of f32 rows of DATA_ROW in DATA_BLOCKS blocks, batches of
# DATA_BATCH rows (256 MiB). The overlap loop's device workload a batch:
# DATA_WORK f32 products of the batch with a [4096, 4096] matrix (TF32 off;
# 2.2 TFLOP, some tens of ms on an H100, against about 10 ms for the
# batch's pinned copy at PCIe 5's rate). Then a stack of DATA_STACK_STEPS
# GPT-2-124M steps at TRAIN_BATCH through iter_stacked_batches.
DATA_BYTES, DATA_ROW, DATA_BLOCKS, DATA_BATCH = 2 ** 30, 4096, 16, 16384
DATA_WORK, DATA_STACK_STEPS, DATA_LOOPS = 4, 4, 3
# [data-train]: steps of TRAIN_BATCH rows, one synthetic batch a step
DATA_TRAIN_STEPS = 12
# [rllib-remote]: EnvRunner actors (BASELINE config 2's 16 envs split over
# them) and sampling workers; IMPALA's asynchronous loop at
# tests/test_rllib_impala.py::test_impala_async_workers_smoke's settings
RLLIB_REMOTE_WORKERS = 2
RLLIB_REMOTE_IMPALA = dict(env="Pong-v0", num_envs=4, fragment=32,
                           updates_per_iteration=4, seed=1, iterations=2)
RLLIB_REMOTE_OFFPOLICY_ITERS = 3


def device_ms(fn, device, iters: int = 5) -> float:
    """Mean ms of fn(): CUDA events on the card, the host clock around
    synchronized calls elsewhere."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters=iters, warmup=1)
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e3


def gpt2_bundle(cfg, device):
    """GPT-2's train step as [trainer] builds it: a generator seeded 0 on
    `device`, warm-up 2 of 1000 steps."""
    from ray_tpu_torch.train.train_step import default_optimizer, make_gpt2_train_step

    return make_gpt2_train_step(
        cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
        generator=torch.Generator(device=device).manual_seed(0), device=device)


def direct_losses(cfg, feeds, device) -> list:
    """The losses of gpt2_bundle's step_fn fed the numpy batches `feeds`
    in turn, here."""
    bundle = gpt2_bundle(cfg, device)
    state, losses = bundle.state, []
    for feed in feeds:
        state, m = bundle.step_fn(state, feed)
        losses.append(m["loss"].item())
    del bundle, state, m
    free_device_memory()
    return losses


def batch_rows(feeds) -> list:
    """Batches as a Dataset's rows, in order: {"tokens", "targets"} a row."""
    return [{k: f[k][r] for k in f} for f in feeds
            for r in range(len(f["tokens"]))]


def data_phase(card: str, device="cuda", nbytes: int = DATA_BYTES,
               rows_a_batch: int = DATA_BATCH, cfg=None,
               batch: int = TRAIN_BATCH,
               stack_steps: int = DATA_STACK_STEPS) -> dict:
    """[data] (module docstring), in ray_tpu_torch.init(local_mode=True).
    Returns the stack's launches and the copy's numbers."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data.iterator import iter_stacked_batches
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m(remat=False)
    rows = nbytes // (4 * DATA_ROW)
    t0 = t = time.perf_counter()
    src = np.random.default_rng(0).random((rows, DATA_ROW), dtype=np.float32)
    make_s = time.perf_counter() - t
    n_batches = -(-rows // rows_a_batch)
    ray_tpu_torch.init(local_mode=True)
    try:
        ds = rd.from_numpy(np.array_split(src, DATA_BLOCKS))
        seen = 0
        for i, b in enumerate(ds.iter_batches(batch_size=rows_a_batch, device=device,
                                              prefetch_batches=1)):
            x = b["data"]
            if x.device.type != torch.device(device).type or x.dtype != torch.float32:
                fail(f"[data] batch {i} is {x.dtype} on {x.device}, not f32 on "
                     f"{device}")
            if not np.array_equal(x.cpu().numpy(),
                                  src[i * rows_a_batch:(i + 1) * rows_a_batch]):
                fail(f"[data] batch {i} differs from its numpy source")
            seen += 1
        if seen != n_batches:
            fail(f"[data] {seen} batches, expected {n_batches}")

        # one batch's pieces: staging into a pinned buffer (host clock),
        # the pinned and a pageable copy to the card
        host = src[:rows_a_batch]
        staging = torch.empty(host.shape, dtype=torch.float32, pin_memory=on_card)
        view = staging.numpy()
        np.copyto(view, host)
        t = time.perf_counter()
        for _ in range(5):
            np.copyto(view, host)
        stage_ms = (time.perf_counter() - t) / 5 * 1e3
        pinned_ms = device_ms(lambda: staging.to(device, non_blocking=True), device)
        pageable_ms = device_ms(lambda: torch.as_tensor(host).to(device), device)
        del staging, view

        # the loop with a fixed device workload a batch
        w = torch.randn(DATA_ROW, DATA_ROW, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))

        def work(x):
            for _ in range(DATA_WORK):
                y = x @ w
            return y

        resident = torch.as_tensor(host, device=device)
        work_ms = device_ms(lambda: work(resident), device, iters=3)
        del resident
        loop_ms, next_ms = [], []
        for _ in range(DATA_LOOPS):
            sync(device)
            t = time.perf_counter()
            batches, inside = ds.iter_batches(
                batch_size=rows_a_batch, device=device, prefetch_batches=1), 0.0
            while True:
                t_next = time.perf_counter()
                b = next(batches, None)
                inside += time.perf_counter() - t_next
                if b is None:
                    break
                work(b["data"])
            sync(device)
            loop_ms.append((time.perf_counter() - t) * 1e3)
            next_ms.append(inside * 1e3)
        del w
        free_device_memory()
        numbers = dict(
            batches=n_batches, batch_bytes=host.nbytes, make_s=make_s,
            stage_ms=stage_ms, pinned_h2d_ms=pinned_ms,
            pinned_h2d_gb_s=host.nbytes / pinned_ms / 1e6,
            pageable_h2d_ms=pageable_ms,
            pageable_h2d_gb_s=host.nbytes / pageable_ms / 1e6,
            work_ms=work_ms, loop_ms=loop_ms,
            loop_ms_median=float(np.median(loop_ms)), loop_next_ms=next_ms,
            threads=threading.active_count(),
            sum_copy_and_work_ms=n_batches * (pinned_ms + work_ms),
            sum_stage_copy_and_work_ms=n_batches * (stage_ms + pinned_ms + work_ms))
        log(f"[data] {n_batches} batches of {host.nbytes} bytes equal their "
            f"numpy source in every bit; " + json.dumps(dict(card=card, **numbers)))

        # a stack of GPT-2 steps through multi_step_fn
        feeds = [synthetic_batch(cfg, batch, seed=i) for i in range(stack_steps)]
        want = direct_losses(cfg, feeds, device)
        bundle = gpt2_bundle(cfg, device)
        stacks = list(iter_stacked_batches(
            rd.from_items(batch_rows(feeds)).iter_block_refs(), batch_size=batch,
            steps_per_stack=stack_steps, device=device))
        if len(stacks) != 1 or stacks[0]["tokens"].shape != (stack_steps, batch, cfg.seq_len):
            fail(f"[data] stacks {[s['tokens'].shape for s in stacks]}")
        reset_launches()
        state, m = bundle.multi_step_fn(bundle.state, stacks[0])
        got = m["loss"].tolist()
        launches = launches_since_reset()
        del bundle, state, m, stacks
        free_device_memory()
    finally:
        ray_tpu_torch.shutdown()
    expected = cfg.n_layer * stack_steps if on_card else 0
    log(f"[data] iter_stacked_batches -> multi_step_fn, {stack_steps} steps of "
        f"B {batch}: losses {got}, step_fn on the numpy batches {want}; "
        f"launches {launches} (expected {expected} each); {card}")
    if got != want:
        fail(f"[data] the stacked steps' losses {got} differ from step_fn's {want}")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"[data] the stack launched {launches}, expected {expected} each")
    log(f"[data] took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, **numbers}


def data_train_loop(config: dict) -> None:
    """[data-train]'s train_loop_per_worker: gpt2_bundle(config["cfg"],
    config["device"]), one step a batch of get_dataset_shard("train")
    .iter_batches(batch_size=config["batch"], device=config["device"],
    drop_last=True). Each step reports loss, grad_norm, step, step_ms (host
    clock around a synchronized step), wait_ms (its batch's next()), the
    batch's device, this process's pid, the host clock when the first batch
    was asked for, and the launches of this process since the loop began."""
    from ray_tpu_torch import train

    reset_launches()
    device = config["device"]
    bundle = gpt2_bundle(config["cfg"], device)
    state = bundle.state
    sync(device)
    t_first = time.perf_counter()
    batches = iter(train.get_dataset_shard("train").iter_batches(
        batch_size=config["batch"], device=device, drop_last=True))
    while True:
        t = time.perf_counter()
        b = next(batches, None)
        if b is None:
            break
        wait_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        state, m = bundle.step_fn(state, b)
        sync(device)
        train.report({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                      "step": state["step"],
                      "step_ms": (time.perf_counter() - t) * 1e3,
                      "wait_ms": wait_ms, "device": str(b["tokens"].device),
                      "pid": os.getpid(), "t_first": t_first,
                      **launches_since_reset()})


def data_train_phase(card: str, cluster_step_ms, device="cuda", cfg=None,
                     batch: int = TRAIN_BATCH,
                     steps: int = DATA_TRAIN_STEPS) -> dict:
    """[data-train] (module docstring) on the running cluster. Returns the
    worker's launches and its steady step ms."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.train_step import synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m(remat=False)
    feeds = [synthetic_batch(cfg, batch, seed=i) for i in range(steps)]
    want = direct_losses(cfg, feeds, device)
    ds = rd.from_items(batch_rows(feeds))
    t0 = time.perf_counter()
    result = TorchTrainer(
        data_train_loop,
        train_loop_config={"cfg": cfg, "device": device, "batch": batch},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
        datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        fail(f"[data-train] fit failed: {result.error!r}")
    rows = result.metrics_dataframe
    got = [r["loss"] for r in rows]
    launches = {k: rows[-1][k] for k in ("flash_fwd", "flash_bwd")}
    expected = cfg.n_layer * steps if on_card else 0
    steady = sorted(r["step_ms"] for r in rows[1:])
    median = steady[len(steady) // 2]
    log("[data-train] " + json.dumps(dict(
        card=card, steps=len(rows), batch=batch, seq_len=cfg.seq_len,
        losses=got, direct_losses=want, bitwise_equal=got == want,
        launches=launches, steady_step_ms_median=median,
        cluster_trainer_step_ms_median=cluster_step_ms,
        first_step_ms=rows[0]["step_ms"], wait_ms=[r["wait_ms"] for r in rows],
        setup_s=rows[0]["t_first"] - t0, fit_s=fit_s,
        devices=sorted({r["device"] for r in rows}), pid=rows[0]["pid"])))
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        fail(f"[data-train] reported steps {[r['step'] for r in rows]}")
    if rows[0]["pid"] == os.getpid():
        fail("[data-train] the loop ran in this process")
    if {r["device"].split(":")[0] for r in rows} != {torch.device(device).type}:
        fail(f"[data-train] batches arrived on {sorted({r['device'] for r in rows})}")
    if got != want:
        fail(f"[data-train] the Dataset-fed losses {got} differ from the "
             f"directly fed {want}")
    if launches != {"flash_fwd": expected, "flash_bwd": expected}:
        fail(f"[data-train] the worker launched {launches}, expected {expected} each")
    return {"launches": launches, "step_ms_median": median}


def counting_predictor():
    """A TorchPredictor class that also returns, on each row, this
    process's flash launches since it loaded its checkpoint, its pid, the
    batch's predict ms and the host clock around its load."""
    from ray_tpu_torch.train.batch_predictor import TorchPredictor

    class CountingPredictor(TorchPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            t = time.perf_counter()
            predictor = super().from_checkpoint(checkpoint, **kwargs)
            sync(predictor._device)
            predictor._load = (t, time.perf_counter())
            reset_launches()
            return predictor

        def predict(self, batch):
            t = time.perf_counter()
            out = super().predict(batch)
            stamps = {"predict_ms": (time.perf_counter() - t) * 1e3,
                      "pid": os.getpid(), "load_start": self._load[0],
                      "load_end": self._load[1], **launches_since_reset()}
            n = len(out["next_token"])
            out.update({k: np.full(n, v) for k, v in stamps.items()})
            return out

    return CountingPredictor


def data_serve_phase(card: str, main: dict, device="cuda", cfg=None,
                     n_requests: int = N_REQUESTS,
                     batch: int = REQUEST_BATCH) -> dict:
    """[data-serve] (module docstring) on the running cluster: `main` holds
    [main]'s answers and request ms (serve_path's `keep`). Returns the
    actor's launches."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data.block import block_concat
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import BatchPredictor, Checkpoint
    from ray_tpu_torch.train.train_step import param_leaves, synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    ckpt = Checkpoint.from_dict({"params": params})
    ckpt_bytes = sum(p.numel() * p.element_size() for p in param_leaves(params))
    t = time.perf_counter()
    ref = ray_tpu_torch.put(ckpt)
    put_s = time.perf_counter() - t
    del ref
    tokens = [synthetic_batch(cfg, batch, seed=i)["tokens"] for i in range(n_requests)]
    ds = rd.from_items([{"id": i * batch + r, "tokens": tok[r]}
                        for i, tok in enumerate(tokens) for r in range(batch)],
                       parallelism=n_requests)
    out = BatchPredictor.from_checkpoint(
        ckpt, counting_predictor(), apply_fn=serve_apply_fn(gpt2, cfg),
        device=device,
    ).predict(ds, batch_size=batch, num_workers=1, keep_columns=("id",))
    t0 = time.perf_counter()
    blocks, arrivals = [], []
    for r in out.iter_block_refs():
        blocks.append(ray_tpu_torch.get(r, timeout=600))
        arrivals.append(time.perf_counter())
    del ckpt, params
    free_device_memory()
    rows = block_concat(blocks)
    order = np.argsort(rows["id"])
    rows = {k: v[order] for k, v in rows.items()}
    if rows["id"].tolist() != list(range(n_requests * batch)):
        fail(f"[data-serve] answered ids {rows['id'].tolist()}")
    differ = [i for i, ans in enumerate(main["answers"]) if not all(
        rows[k][i * batch:(i + 1) * batch].dtype == ans[k].dtype
        and np.array_equal(rows[k][i * batch:(i + 1) * batch], ans[k])
        for k in ("next_token", "logit"))]
    launches = {k: int(rows[k].max()) for k in ("flash_fwd", "flash_bwd")}
    expected = cfg.n_layer * n_requests if on_card else 0
    intervals = np.diff(arrivals) * 1e3
    interval_ms = float(np.median(intervals)) if len(intervals) else None
    predict_ms = float(np.median(rows["predict_ms"][::batch]))
    log("[data-serve] " + json.dumps(dict(
        card=card, requests=n_requests, batch=batch, seq_len=cfg.seq_len,
        differing_requests=differ, launches=launches,
        batch_predict_ms_median=predict_ms, batch_interval_ms_median=interval_ms,
        main_request_ms=main["request_ms"],
        rows_per_s=batch / (interval_ms / 1e3) if interval_ms else None,
        checkpoint_bytes=ckpt_bytes, checkpoint_put_s=put_s,
        first_answer_s=arrivals[0] - t0,
        actor_start_to_load_s=float(rows["load_start"][0]) - t0,
        load_to_device_s=float(rows["load_end"][0] - rows["load_start"][0]),
        pids=sorted({int(p) for p in rows["pid"]}))))
    if os.getpid() in {int(p) for p in rows["pid"]}:
        fail("[data-serve] the predictor ran in this process")
    if differ:
        fail(f"[data-serve] requests {differ} differ from [main]'s answers")
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[data-serve] the actor launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    return {"launches": launches}


def timed_updates(group) -> list:
    """Wraps a LearnerGroup's update with a host clock (its result read
    back, so synchronized); returns the list of seconds it fills."""
    seconds, update = [], group.update

    def timed(batch):
        t = time.perf_counter()
        out = update(batch)
        seconds.append(time.perf_counter() - t)
        return out
    group.update = timed
    return seconds


def rllib_remote_phase(card: str, inline: dict, device="cuda") -> dict:
    """[rllib-remote] (module docstring) on the running cluster: `inline`
    is [rllib-ppo]'s result."""
    from ray_tpu_torch.rllib.algorithms import (
        DQNConfig, IMPALAConfig, PPOConfig, SACConfig,
    )
    from ray_tpu_torch.rllib.learner import LearnerGroup, PPOLearner
    from ray_tpu_torch.rllib.models import tree_leaves

    out, want = {}, torch.device(device).type
    s = time.perf_counter()
    config = (PPOConfig()
            .environment("CartPole-v1",
                         num_envs_per_worker=RLLIB_NUM_ENVS // RLLIB_REMOTE_WORKERS)
            .rollouts(num_rollout_workers=RLLIB_REMOTE_WORKERS,
                      rollout_fragment_length=RLLIB_PPO_FRAGMENT)
            .training(**RLLIB_PPO_TRAINING)
            .resources(learner_device=device)
            .debugging(seed=0))
    # the remote learner's actor first: it starts (a worker's torch import,
    # its CUDA context) while PPO trains
    from ray_tpu_torch.rllib.env.vector_env import make_vector_env

    probe = make_vector_env("CartPole-v1", 1)
    kw = dict(obs_dim=probe.obs_dim, num_actions=probe.num_actions,
              hiddens=tuple(config.hiddens), lr=config.lr,
              grad_clip=config.grad_clip, num_epochs=config.num_epochs,
              minibatch_size=config.minibatch_size, seed=config.seed,
              device=device)
    remote = LearnerGroup(PPOLearner, kw, mode="remote")
    algo = config.build()
    try:
        if algo.local_runner is not None or len(algo.workers) != RLLIB_REMOTE_WORKERS:
            fail(f"[rllib-remote] PPO built {len(algo.workers)} runner actors "
                 f"and a local runner {algo.local_runner}")
        where = {t.device.type for t in tree_leaves(algo.learner_group._learner.params)}
        if where != {want}:
            fail(f"[rllib-remote] the learner holds its parameters on {where}")
        result, it, iteration_s = {}, 0, []
        while result.get("timesteps_total", 0) < RLLIB_PPO_MAX_STEPS:
            it += 1
            result = algo.train()
            iteration_s.append(result["time_this_iter_s"])
            log(f"[rllib-remote] ppo iter {it}: reward "
                f"{result['episode_reward_mean']:.2f} "
                f"({result['episodes_this_window']} episodes), timesteps "
                f"{result['timesteps_total']}, env-steps/s "
                f"{result['timesteps_total'] / result['time_total_s']:.1f}")
            if (result["episode_reward_mean"] >= RLLIB_TARGET_REWARD
                    and result["episodes_this_window"] >= RLLIB_MIN_EPISODES):
                break
        else:
            fail(f"[rllib-remote] PPO's episode_reward_mean "
                 f"{result['episode_reward_mean']:.2f} < {RLLIB_TARGET_REWARD} "
                 f"after {result['timesteps_total']} env steps")
        def steady(seconds):
            """env-steps/s after the first iteration (whose time holds the
            runners' start): a fixed train batch an iteration"""
            if not seconds or len(seconds) < 2:
                return None
            return (result["timesteps_total"] / len(iteration_s)
                    * (len(seconds) - 1) / sum(seconds[1:]))

        out["ppo"] = {"iterations": it, "env_steps": result["timesteps_total"],
                      "env_steps_per_s": result["timesteps_total"] / result["time_total_s"],
                      "steady_env_steps_per_s": steady(iteration_s),
                      "first_iteration_s": iteration_s[0]}
        log("[rllib-remote] ppo " + json.dumps(dict(
            card=card, runners=RLLIB_REMOTE_WORKERS, **out["ppo"],
            inline_iterations=inline["iterations"],
            inline_env_steps_per_s=inline.get("env_steps_per_s"),
            inline_steady_env_steps_per_s=steady(inline.get("iteration_s")),
            inline_first_iteration_s=(inline.get("iteration_s") or [None])[0])))
        batch = algo.sample_batch()
    finally:
        algo.stop()

    # learner_mode="remote" (a num_gpus=1 actor on the card): one update on
    # that batch against the same update by a local learner
    def two_updates(group):
        """Two updates on the batch: both metrics, the weights after, and
        the second (warm) update's ms."""
        metrics = [group.update(batch)]
        t = time.perf_counter()
        metrics.append(group.update(batch))
        return metrics, group.get_weights(), (time.perf_counter() - t) * 1e3

    try:
        remote.get_weights()        # started during the PPO run
        got, got_weights, remote_ms = two_updates(remote)
    finally:
        remote.shutdown()
    wanted, want_weights, local_ms = two_updates(LearnerGroup(PPOLearner, kw))
    free_device_memory()
    same = got == wanted and all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(got_weights), tree_leaves(want_weights)))
    out["remote_learner"] = {"update_ms": remote_ms, "local_update_ms": local_ms}
    log("[rllib-remote] learner_mode='remote' " + json.dumps(dict(
        card=card, rows=len(batch), bitwise_equal=same, metrics=got[0],
        **out["remote_learner"])))
    if not same:
        fail(f"[rllib-remote] the remote learner's update {got} differs from "
             f"the local one's {wanted}")

    # IMPALA's asynchronous loop
    imp = RLLIB_REMOTE_IMPALA
    algo = (IMPALAConfig()
            .environment(imp["env"], num_envs_per_worker=imp["num_envs"])
            .rollouts(num_rollout_workers=RLLIB_REMOTE_WORKERS,
                      rollout_fragment_length=imp["fragment"])
            .training(updates_per_iteration=imp["updates_per_iteration"])
            .resources(learner_device=device)
            .debugging(seed=imp["seed"])
            .build())
    try:
        seconds = timed_updates(algo.learner_group)
        results = [algo.train() for _ in range(imp["iterations"])]
    finally:
        algo.stop()
    m2 = results[1]
    out["impala"] = {"env_steps_per_s": [r["env_steps_per_sec"] for r in results],
                     "updates": len(seconds),
                     "updates_per_s": len(seconds) / max(sum(seconds), 1e-9)}
    log("[rllib-remote] impala async " + json.dumps(dict(
        card=card, env=imp["env"], workers=RLLIB_REMOTE_WORKERS,
        timesteps_this_iter=[r["timesteps_this_iter"] for r in results],
        total_loss=[r["total_loss"] for r in results], **out["impala"])))
    if not (m2["timesteps_this_iter"] > 0 and m2["env_steps_per_sec"] > 0
            and "total_loss" in m2 and math.isfinite(m2["total_loss"])):
        fail(f"[rllib-remote] IMPALA's second iteration: {m2}")

    # DQN and SAC with sampling workers
    for tag, config_cls, fragment, training in (
            ("dqn", DQNConfig, RLLIB_DQN_FRAGMENT, RLLIB_DQN_TRAINING),
            ("sac", SACConfig, RLLIB_SAC_FRAGMENT, RLLIB_SAC_TRAINING)):
        round_rows = RLLIB_REMOTE_WORKERS * RLLIB_OFFPOLICY_ENVS * fragment
        algo = (rllib_offpolicy_config(config_cls, fragment,
                                       {**training, "learning_starts": round_rows},
                                       device)
                .rollouts(num_rollout_workers=RLLIB_REMOTE_WORKERS).build())
        try:
            seconds = timed_updates(algo.learner_group)
            results = [algo.train() for _ in range(RLLIB_REMOTE_OFFPOLICY_ITERS)]
        finally:
            algo.stop()
        intensity = algo.algo_config.train_intensity
        out[tag] = {"updates": len(seconds),
                    "updates_per_s": len(seconds) / max(sum(seconds), 1e-9),
                    "update_ms": 1e3 * float(np.median(seconds)) if seconds else None}
        log(f"[rllib-remote] {tag} " + json.dumps(dict(
            card=card, workers=RLLIB_REMOTE_WORKERS,
            timesteps_this_iter=[r["timesteps_this_iter"] for r in results],
            loss=results[-1].get("loss"), **out[tag])))
        if [r["timesteps_this_iter"] for r in results] != \
                [round_rows] * RLLIB_REMOTE_OFFPOLICY_ITERS:
            fail(f"[rllib-remote] {tag} sampled "
                 f"{[r['timesteps_this_iter'] for r in results]}")
        if len(seconds) != intensity * RLLIB_REMOTE_OFFPOLICY_ITERS or not \
                math.isfinite(results[-1]["loss"]):
            fail(f"[rllib-remote] {tag}: {len(seconds)} updates, loss "
                 f"{results[-1].get('loss')}")
    log(f"[rllib-remote] phase took {time.perf_counter() - s:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# [collective], [actor-pool], [stream]: util/ and streaming on the cluster
# --------------------------------------------------------------------------- #

COLLECTIVE_WORLD, COLLECTIVE_STEPS = 2, 3
# Step 1's averaged gradient and mean loss against the single-process loss
# and gradient of the whole B 24 batch, from the same weights on the same
# card: compare_gradients' dense limits (each leaf's max |diff| over its max
# |value|; the loss's absolute difference). In exact arithmetic the two are
# equal (both halves hold 12 x 1023 targets, so the mean of the halves'
# means is the whole batch's); on the card they differ only where bf16
# products are summed over rows (a weight's gradient over 12 x 1024 rows
# twice, against 24 x 1024 once).
COLLECTIVE_GRAD_REL_TOL = GRAD_PATH_REL_TOL
COLLECTIVE_LOSS_TOL = LOSS_TOL
STREAM_FAIL_AT = 3
UTIL_TAGS = ("collective", "actor-pool", "stream")


def flat_leaves(leaves) -> torch.Tensor:
    """The leaves (or their gradients) as one flat f32 vector, in order."""
    return torch.cat([p.detach().reshape(-1) for p in leaves])


def load_flat(leaves, flat, grad: bool = False) -> None:
    """Copy a flat vector into the leaves, or into their gradients."""
    offset = 0
    with torch.no_grad():
        for p in leaves:
            (p.grad if grad else p).copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


class CollectiveRank:
    """A rank of [collective]'s data-parallel GPT-2 (an actor): weights from
    a generator seeded with its rank, ClippedAdamW as gpt2_bundle builds it,
    and a util.collective group of `world` ranks."""

    def __init__(self, rank: int, world: int, cfg, device):
        from ray_tpu_torch.train.train_step import (
            default_optimizer, make_gpt2_train_step, named_leaves,
        )
        from ray_tpu_torch.util import collective as col

        self.rank, self.world, self.cfg, self.device = rank, world, cfg, device
        state = make_gpt2_train_step(
            cfg, optimizer=default_optimizer(warmup=2, total_steps=1000),
            generator=torch.Generator(device=device).manual_seed(rank),
            device=device).state
        self.params, self.opt = state["params"], state["opt_state"]
        self.names = [n for n, _ in named_leaves(self.params)]
        self.leaves = [p for _, p in named_leaves(self.params)]
        self.group = col.init_collective_group(world, rank, "smoke-dp")
        self.reference = None

    def card(self):
        """(pid, CUDA_VISIBLE_DEVICES, the card's uuid or None)."""
        on_card = torch.device(self.device).type == "cuda"
        return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                str(torch.cuda.get_device_properties(0).uuid) if on_card else None)

    def broadcast(self) -> dict:
        """Rank 0's flat f32 parameters to every rank, timed in its parts."""
        t = [time.perf_counter()]
        host = flat_leaves(self.leaves).cpu()
        t.append(time.perf_counter())
        out = self.group.broadcast(host, src_rank=0)
        t.append(time.perf_counter())
        load_flat(self.leaves, torch.from_numpy(out).to(self.device))
        sync(self.device)
        t.append(time.perf_counter())
        return {"bytes": host.numel() * 4, **{k: (b - a) * 1e3 for k, a, b in zip(
            ("d2h_ms", "ring_ms", "h2d_ms"), t, t[1:])}}

    def _loss(self, tokens, targets):
        from ray_tpu_torch.models import gpt2

        self.opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_fn(self.params, torch.as_tensor(tokens, device=self.device),
                            torch.as_tensor(targets, device=self.device), self.cfg)
        loss.backward()
        return loss

    def whole_batch(self, batch) -> float:
        """The single-process loss and gradient of the whole batch from the
        current weights, kept on the host for step 1's check."""
        loss = self._loss(batch["tokens"], batch["targets"]).item()
        self.reference = flat_leaves([p.grad for p in self.leaves]).cpu()
        self.opt.zero_grad(set_to_none=True)
        return loss

    def step(self, batch) -> dict:
        """This rank's rows of the batch: loss and gradients, the flat f32
        gradient to the host, allreduced as "mean" over the ring, back to
        the card, then ClippedAdamW; each part timed."""
        n = len(batch["tokens"]) // self.world
        rows = slice(self.rank * n, (self.rank + 1) * n)
        t = [time.perf_counter()]
        loss = self._loss(batch["tokens"][rows], batch["targets"][rows])
        flat = flat_leaves([p.grad for p in self.leaves])
        sync(self.device)
        t.append(time.perf_counter())
        host = flat.cpu()
        t.append(time.perf_counter())
        mean = self.group.allreduce(host, op="mean")
        t.append(time.perf_counter())
        load_flat(self.leaves, torch.from_numpy(mean).to(self.device), grad=True)
        sync(self.device)
        t.append(time.perf_counter())
        self.opt.step()
        sync(self.device)
        t.append(time.perf_counter())
        out = {"loss": loss.item(), "bytes": host.numel() * 4,
               **{k: (b - a) * 1e3 for k, a, b in zip(
                   ("compute_ms", "d2h_ms", "ring_ms", "h2d_ms", "optimizer_ms"),
                   t, t[1:])}}
        if self.reference is not None:
            ref, offset, errs = self.reference, 0, {}
            got = torch.from_numpy(mean)
            for name, p in zip(self.names, self.leaves):
                errs[name] = rel_err(got[offset:offset + p.numel()],
                                     ref[offset:offset + p.numel()])
                offset += p.numel()
            out["grad_rel_err"], self.reference = errs, None
        return out

    def digest(self) -> str:
        import hashlib

        flat = flat_leaves(self.leaves).cpu().numpy()
        return hashlib.blake2b(flat.view(np.uint8)).hexdigest()

    def reset(self) -> None:
        reset_launches()

    def launches(self) -> dict:
        return launches_since_reset()

    def close(self) -> None:
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group("smoke-dp")


def collective_phase(card: str, device="cuda", cfg=None, batch: int = TRAIN_BATCH,
                     steps: int = COLLECTIVE_STEPS) -> dict:
    """[collective] (module docstring) on the running cluster: two GPU
    actors at num_gpus=0.5, a world-2 util.collective ring, rank 0's
    weights broadcast, then `steps` data-parallel steps of half the batch
    each. Returns both kernels' launches summed over the actors."""
    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m(remat=False)
    W = COLLECTIVE_WORLD
    rank_cls = ray_tpu_torch.remote(num_gpus=1 / W)(CollectiveRank)
    t0 = time.perf_counter()
    ranks = [rank_cls.remote(r, W, cfg, device) for r in range(W)]
    try:
        cards = ray_tpu_torch.get([a.card.remote() for a in ranks], timeout=600)
        start_s = time.perf_counter() - t0
        pids = {c[0] for c in cards}
        if len(pids) != W or os.getpid() in pids:
            fail(f"[collective] the ranks ran in processes {pids}, not {W} "
                 f"workers of their own")
        visible = [c[1] for c in cards]
        if len(set(visible)) != 1 or visible[0] is None or "," in visible[0] \
                or len({c[2] for c in cards}) != 1:
            fail(f"[collective] the ranks do not share one card named once: "
                 f"{cards}")
        bc = ray_tpu_torch.get([a.broadcast.remote() for a in ranks], timeout=600)
        digests = [ray_tpu_torch.get([a.digest.remote() for a in ranks], timeout=600)]
        if len(set(digests[0])) != 1:
            fail("[collective] the ranks' parameters differ after the broadcast")
        feed = synthetic_batch(cfg, batch, seed=0)
        whole_loss = ray_tpu_torch.get(ranks[0].whole_batch.remote(feed), timeout=600)
        ray_tpu_torch.get([a.reset.remote() for a in ranks], timeout=60)
        rows = []
        for s in range(steps):
            rows.append(ray_tpu_torch.get([a.step.remote(feed) for a in ranks],
                                          timeout=600))
            digests.append(ray_tpu_torch.get([a.digest.remote() for a in ranks],
                                             timeout=600))
            if len(set(digests[-1])) != 1:
                fail(f"[collective] the ranks' parameters differ after step {s + 1}")
        launches = ray_tpu_torch.get([a.launches.remote() for a in ranks], timeout=60)
        ray_tpu_torch.get(ranks[0].close.remote(), timeout=60)
    finally:
        for a in ranks:
            ray_tpu_torch.kill(a)
    losses = [[r["loss"] for r in step] for step in rows]
    mean_loss = sum(losses[0]) / W
    errs = rows[0][0]["grad_rel_err"]
    worst = max(errs, key=errs.get)
    nbytes = rows[0][0]["bytes"]
    ring_ms = [max(r["ring_ms"] for r in step) for step in rows]
    bc_ring_ms = max(r["ring_ms"] for r in bc)
    parts = {k: [[round(r[k], 3) for r in step] for step in rows]
             for k in ("compute_ms", "d2h_ms", "ring_ms", "h2d_ms", "optimizer_ms")}
    log("[collective] " + json.dumps(dict(
        card=card, world=W, model=f"L{cfg.n_layer} D{cfg.d_model}",
        batch_per_rank=batch // W, seq_len=cfg.seq_len, steps=steps,
        actor_start_s=start_s, cuda_visible_devices=visible,
        same_card=len({c[2] for c in cards}) == 1, pids=sorted(pids),
        gradient_bytes=nbytes, broadcast={k: [r[k] for r in bc] for k in (
            "d2h_ms", "ring_ms", "h2d_ms")},
        broadcast_gb_s=nbytes / (bc_ring_ms / 1e3) / 1e9,
        allreduce_ms=ring_ms,
        allreduce_bus_gb_s=[2 * (W - 1) / W * nbytes / (ms / 1e3) / 1e9
                            for ms in ring_ms],
        step_parts_ms_by_rank=parts, losses_by_rank=losses,
        digests_equal_after=["broadcast"] + [f"step {i + 1}" for i in range(steps)],
        launches_by_actor=launches)))
    log(f"[collective] step 1: mean loss of the halves {mean_loss} vs the "
        f"whole batch's {whole_loss} (tol {COLLECTIVE_LOSS_TOL}); averaged "
        f"gradient vs the whole batch's: worst {worst} {errs[worst]} (tol "
        f"{COLLECTIVE_GRAD_REL_TOL}), by leaf {json.dumps(errs)}")
    if not all(map(math.isfinite, sum(losses, []))):
        fail(f"[collective] non-finite losses {losses}")
    if not abs(mean_loss - whole_loss) <= COLLECTIVE_LOSS_TOL:
        fail(f"[collective] step 1's mean loss {mean_loss} is off the whole "
             f"batch's {whole_loss}")
    if not errs[worst] <= COLLECTIVE_GRAD_REL_TOL:
        fail(f"[collective] step 1's averaged gradient is off the whole "
             f"batch's: {worst} {errs[worst]}")
    expected = cfg.n_layer * steps if on_card else 0
    if any(n != {"flash_fwd": expected, "flash_bwd": expected} for n in launches):
        fail(f"[collective] the ranks launched {launches}, expected {expected} "
             f"of each kernel each")
    return {"launches": {k: sum(n[k] for n in launches)
                         for k in ("flash_fwd", "flash_bwd")}}


class PoolPredictor:
    """[actor-pool]'s and [stream]'s GPU actor: [main]'s TorchPredictor, its
    weights from the same seeded generator on this actor's card."""

    def __init__(self, cfg, device):
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.batch_predictor import TorchPredictor
        from ray_tpu_torch.train.checkpoint import Checkpoint

        self.device = device
        params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
        self.predictor = TorchPredictor.from_checkpoint(
            Checkpoint.from_dict({"params": params}),
            apply_fn=serve_apply_fn(gpt2, cfg), device=device)
        reset_launches()

    def card(self):
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    def predict(self, tokens):
        t = time.perf_counter()
        out = self.predictor.predict({"tokens": tokens})
        return out, (time.perf_counter() - t) * 1e3, os.getpid()

    def stream(self, requests):
        """Each request's answer, one item each."""
        for tokens in requests:
            yield self.predictor.predict({"tokens": tokens})

    def failing_stream(self, requests, fail_at: int):
        """The requests' answers in turn, over and over, until item
        `fail_at`, which raises."""
        for i in range(fail_at):
            yield self.predictor.predict({"tokens": requests[i % len(requests)]})
        raise RuntimeError(f"the stream's producer raised at item {fail_at}")

    def tensor(self, nbytes: int, seed: int):
        """One item: `nbytes` seeded random bytes on this actor's card."""
        yield seeded_bytes(nbytes, seed, self.device)

    def reset(self) -> None:
        reset_launches()

    def launches(self) -> dict:
        return launches_since_reset()


def seeded_bytes(nbytes: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (nbytes,), generator=gen, dtype=torch.uint8,
                         device=device)


def feed_requests(queue, cfg, n_requests: int, batch: int) -> int:
    """[actor-pool]'s CPU task: [main]'s requests, in order, into a Queue."""
    from ray_tpu_torch.train.train_step import synthetic_batch

    for i in range(n_requests):
        queue.put((i, synthetic_batch(cfg, batch, seed=i)["tokens"]))
    return os.getpid()


def same_answer(a: dict, b: dict) -> bool:
    return all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in ("next_token", "logit"))


def actor_pool_phase(card: str, main: dict, device="cuda", cfg=None,
                     n_requests: int = N_REQUESTS, batch: int = REQUEST_BATCH) -> dict:
    """[actor-pool] (module docstring) on the running cluster. Returns the
    flash launches summed over the pool's two actors, and the actors
    ([stream] streams from the first; the caller kills them)."""
    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util import ActorPool
    from ray_tpu_torch.util.queue import Queue

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    t0 = time.perf_counter()
    actors = [ray_tpu_torch.remote(num_gpus=0.5)(PoolPredictor).remote(cfg, device)
              for _ in range(2)]
    cards = ray_tpu_torch.get([a.card.remote() for a in actors], timeout=600)
    start_s = time.perf_counter() - t0
    queue = Queue()
    feeder = ray_tpu_torch.remote(num_cpus=1)(feed_requests).remote(
        queue, cfg, n_requests, batch)
    items = [queue.get(timeout=600) for _ in range(n_requests)]
    feeder_pid = ray_tpu_torch.get(feeder, timeout=60)
    queue.shutdown()
    if [i for i, _ in items] != list(range(n_requests)):
        fail(f"[actor-pool] the Queue gave requests {[i for i, _ in items]}")
    pool = ActorPool(actors)
    t = time.perf_counter()
    ordered = list(pool.map(lambda a, v: a.predict.remote(v[1]), items))
    map_s = time.perf_counter() - t
    unordered = list(pool.map_unordered(lambda a, v: a.predict.remote(v[1]), items))
    launches = ray_tpu_torch.get([a.launches.remote() for a in actors], timeout=60)
    differ = [i for i, (out, _, _) in enumerate(ordered)
              if not same_answer(out, main["answers"][i])]

    def key(ans):
        return ans["next_token"].tobytes() + ans["logit"].tobytes()

    unordered_same = sorted(key(a) for a, _, _ in unordered) == sorted(
        key(a) for a in main["answers"])
    request_ms = [ms for _, ms, _ in ordered]
    pids = sorted({pid for _, _, pid in ordered + unordered})
    # each actor's first request loads its kernels and warms its process
    seen, steady = set(), []
    for _, ms, pid in ordered + unordered:
        if pid in seen:
            steady.append(ms)
        seen.add(pid)
    median_ms = float(np.median(steady))
    log("[actor-pool] " + json.dumps(dict(
        card=card, requests=n_requests, batch=batch, seq_len=cfg.seq_len,
        differing_requests=differ, map_unordered_same_set=unordered_same,
        request_ms=request_ms, map_unordered_request_ms=[ms for _, ms, _ in unordered],
        steady_request_ms_median=median_ms, main_request_ms=main["request_ms"],
        map_s=map_s, rows_per_s=batch / (median_ms / 1e3),
        launches_by_actor=launches, actor_start_s=start_s,
        cuda_visible_devices=[c[1] for c in cards], pids=pids,
        queue_feeder_pid=feeder_pid)))
    if os.getpid() in pids or feeder_pid == os.getpid():
        fail("[actor-pool] a predictor or the feeder ran in this process")
    if differ:
        fail(f"[actor-pool] requests {differ} differ from [main]'s answers")
    if not unordered_same:
        fail("[actor-pool] map_unordered's answers are not [main]'s")
    expected = cfg.n_layer * 2 * n_requests if on_card else 0
    total = {k: sum(n[k] for n in launches) for k in ("flash_fwd", "flash_bwd")}
    if total != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[actor-pool] the actors launched {launches}, expected flash_fwd "
             f"{expected} in all and flash_bwd 0")
    return {"launches": total, "actors": actors}


def stream_phase(card: str, main: dict, actor, device="cuda", cfg=None,
                 n_requests: int = N_REQUESTS, batch: int = REQUEST_BATCH,
                 nbytes: int = SERIALIZE_BYTES) -> dict:
    """[stream] (module docstring) from `actor`, a PoolPredictor on the
    running cluster. Returns its flash launches."""
    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    requests = [synthetic_batch(cfg, batch, seed=i)["tokens"] for i in range(n_requests)]
    windowed = {"num_returns": "streaming", "generator_backpressure_num_objects": 1}
    ray_tpu_torch.get(actor.reset.remote(), timeout=60)
    t0 = time.perf_counter()
    answers, arrivals = [], []
    for ref in actor.stream.options(**windowed).remote(requests):
        answers.append(ray_tpu_torch.get(ref, timeout=600))
        arrivals.append(time.perf_counter() - t0)
    differ = [i for i, (a, b) in enumerate(zip(answers, main["answers"]))
              if not same_answer(a, b)]

    # a CUDA tensor item travels as its host copy (core/serialization.py,
    # as the reference's jax.Array comes back numpy), so its GB/s is a
    # round trip through pageable host memory; whatever device it arrives
    # on, it is moved onto this process's card and checked equal there to
    # the actor's bytes (drawn on the card: a CPU generator draws others)
    t = time.perf_counter()
    items = actor.tensor.options(**windowed).remote(nbytes, 0)
    ref = next(items)
    ready_s = time.perf_counter() - t
    x = ray_tpu_torch.get(ref, timeout=600)
    got_s = time.perf_counter() - t
    arrived_on = str(x.device) if isinstance(x, torch.Tensor) else type(x).__name__
    x = x.to(device) if isinstance(x, torch.Tensor) else x
    sync(device)
    moved_s = time.perf_counter() - t
    more = list(items)
    want = seeded_bytes(nbytes, 0, device)
    tensor_ok = (isinstance(x, torch.Tensor) and not more
                 and torch.equal(x, want))
    del x, want

    failed, raised = [], None
    for i, ref in enumerate(actor.failing_stream.options(**windowed).remote(
            requests, STREAM_FAIL_AT)):
        try:
            failed.append(ray_tpu_torch.get(ref, timeout=600))
        except RuntimeError as e:
            raised = (i, str(e))
    launches = ray_tpu_torch.get(actor.launches.remote(), timeout=60)
    log("[stream] " + json.dumps(dict(
        card=card, requests=n_requests, batch=batch, items=len(answers),
        differing_items=differ, first_item_s=arrivals[0] if arrivals else None,
        last_item_s=arrivals[-1] if arrivals else None, item_s=arrivals,
        tensor_bytes=nbytes, tensor_arrived_on=arrived_on,
        tensor_equal_on_its_device=tensor_ok,
        tensor_ready_s=ready_s, tensor_got_s=got_s, tensor_on_card_s=moved_s,
        tensor_gb_s=nbytes / got_s / 1e9,
        tensor_to_card_gb_s=nbytes / moved_s / 1e9,
        failing_stream_items=len(failed), failing_stream_raised=raised,
        launches=launches)))
    if len(answers) != n_requests or differ:
        fail(f"[stream] {len(answers)} items of {n_requests}, items {differ} "
             f"differ from [main]'s answers")
    if not tensor_ok:
        fail(f"[stream] the {nbytes}-byte tensor item arrived on {arrived_on} "
             f"not equal to the actor's, or the stream went on after it")
    if raised is None or raised[0] != STREAM_FAIL_AT or "raised at item" not in raised[1] \
            or not all(same_answer(a, main["answers"][i % n_requests])
                       for i, a in enumerate(failed)) \
            or len(failed) != STREAM_FAIL_AT:
        fail(f"[stream] the failing stream gave {len(failed)} items and raised "
             f"{raised}, expected {STREAM_FAIL_AT} of [main]'s answers then the "
             f"producer's error at item {STREAM_FAIL_AT}")
    expected = cfg.n_layer * (n_requests + STREAM_FAIL_AT) if on_card else 0
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[stream] the actor launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    return {"launches": launches}


def util_phases(card: str, data: dict, device="cuda", cfg=None,
                batch: int = TRAIN_BATCH) -> dict:
    """[collective], [actor-pool] and [stream] on the running cluster, each
    one's seconds printed; the pool's actors are killed at the end. `data`
    holds [main]'s kept answers ("serve"), and for a small rehearsal the
    serving config and request shape ("serve_cfg", "requests",
    "request_batch") and [stream]'s tensor bytes ("stream_bytes")."""
    import ray_tpu_torch

    out, actors = {}, []
    serve = dict(cfg=data.get("serve_cfg"), n_requests=data.get("requests", N_REQUESTS),
                 batch=data.get("request_batch", REQUEST_BATCH))
    try:
        for tag in UTIL_TAGS:
            free_device_memory()
            s = time.perf_counter()
            if tag == "collective":
                out[tag] = collective_phase(card, device, cfg, batch)
            elif tag == "actor-pool":
                out[tag] = actor_pool_phase(card, data["serve"], device, **serve)
                actors = out[tag].pop("actors")
            else:
                out[tag] = stream_phase(card, data["serve"], actors[0], device,
                                        nbytes=data.get("stream_bytes", SERIALIZE_BYTES),
                                        **serve)
            log(f"[{tag}] took {time.perf_counter() - s:.1f} s")
    finally:
        for a in actors:
            ray_tpu_torch.kill(a)
    return out


# --------------------------------------------------------------------------- #
# Phases 32 to 34: several nodes
# --------------------------------------------------------------------------- #

MULTI_NODE_TAGS = ("multi-node", "multi-node-lineage", "client")
LINEAGE_BATCH = REQUEST_BATCH
CONFIG_FIELDS = ("vocab_size", "seq_len", "n_layer", "n_head", "d_model")


class NodePredictor:
    """[multi-node]'s GPU actor: [main]'s TorchPredictor over the checkpoint
    it was constructed with (its constructor argument, a ref put on the
    head and pulled to this node by its raylet)."""

    def __init__(self, checkpoint, cfg, device):
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.batch_predictor import TorchPredictor

        self.predictor = TorchPredictor.from_checkpoint(
            checkpoint, apply_fn=serve_apply_fn(gpt2, cfg), device=device)
        reset_launches()

    def where(self):
        return (os.getpid(), os.environ.get("RAY_TPU_NODE_ID"),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    def predict(self, tokens):
        t = time.perf_counter()
        out = self.predictor.predict({"tokens": tokens})
        return out, (time.perf_counter() - t) * 1e3

    def launches(self) -> dict:
        return launches_since_reset()


def node_gradient(cfg, batch: int, device):
    """[multi-node-lineage]'s GPU task: GPT-2's loss and gradients of one
    synthetic batch (weights seeded 0) on both flash kernels, the flat f32
    gradient left on `device`. Returns (node id, pid, launches, loss,
    gradient)."""
    from ray_tpu_torch.train.train_step import synthetic_batch

    reset_launches()
    grad, loss = flat_gradient(cfg, synthetic_batch(cfg, batch, seed=0), device)
    return (os.environ.get("RAY_TPU_NODE_ID"), os.getpid(),
            launches_since_reset(), loss, grad)


def flat_gradient(cfg, batch: dict, device):
    """The flat f32 gradient (on `device`) and the loss of GPT-2 at `cfg`,
    weights from a generator seeded 0, on `batch`."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import param_leaves

    params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = gpt2.loss_fn(params, torch.as_tensor(batch["tokens"], device=device),
                        torch.as_tensor(batch["targets"], device=device), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return flat_leaves(grads), loss.item()


def node_where():
    return os.environ.get("RAY_TPU_NODE_ID"), os.environ.get("CUDA_VISIBLE_DEVICES")


def raylet_stats(node_id: Optional[str] = None) -> dict:
    """scheduler_stats of this driver's raylet, or of `node_id`'s."""
    from ray_tpu_torch.api import _global_worker

    core = _global_worker().backend.core

    async def call():
        if node_id is None:
            return await core.raylet.call("scheduler_stats", timeout=60)
        view = await core.gcs.call("get_resource_view", timeout=30)
        conn = await core._conn_to(view[node_id]["address"], kind="raylet")
        return await conn.call("scheduler_stats", timeout=60)

    return core.io.run(call(), timeout=120)


def pulls_delta(after: dict, before: dict) -> dict:
    return {k: after["pulls"][k] - before["pulls"][k] for k in after["pulls"]}


def alive_nodes() -> list:
    import ray_tpu_torch

    return sorted(n["NodeID"] for n in ray_tpu_torch.nodes() if n["Alive"])


def start_two_nodes(device) -> dict:
    """A cluster of two nodes on this host, each in a shm session of its
    own (so objects cross between them through the pull manager): the head
    (num_cpus 2, num_gpus 0), this process's driver node, and a GPU node
    (num_cpus 2, num_gpus 1, and on the card GPU-<kind>)."""
    import uuid

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    t = time.perf_counter()
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0,
                                      "node_id": "head"})
    kind = {}
    if torch.device(device).type == "cuda":
        kind = {"GPU-" + torch.cuda.get_device_name(0).lower().replace(" ", "-"): 1}
    gpu_node = cluster.add_node(num_cpus=2, num_gpus=1, resources=kind,
                                node_id="gpu-node",
                                session=f"s{uuid.uuid4().hex[:10]}")
    ray_tpu_torch.init(address=cluster.address, _node_name="head")
    cluster.wait_for_nodes(2)
    return {"cluster": cluster, "gpu_node": gpu_node, "kind": kind,
            "start_s": time.perf_counter() - t}


def multi_node_phase(card: str, main: dict, ctx: dict, device="cuda", cfg=None,
                     n_requests: int = N_REQUESTS,
                     batch: int = REQUEST_BATCH) -> dict:
    """[multi-node] (module docstring) on the two nodes of `ctx`. Returns
    the actor's launches."""
    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.train_step import param_leaves, synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    nodes = {n["NodeID"]: n for n in ray_tpu_torch.nodes() if n["Alive"]}
    with_gpu = sorted(n for n, v in nodes.items() if v["Resources"].get("GPU"))
    if sorted(nodes) != ["gpu-node", "head"] or with_gpu != ["gpu-node"]:
        fail(f"[multi-node] nodes {json.dumps(nodes)}: expected head and "
             f"gpu-node, GPU only on gpu-node")
    before = raylet_stats()
    node, visible = ray_tpu_torch.get(
        ray_tpu_torch.remote(num_gpus=1)(node_where).remote(), timeout=300)
    spilled = (raylet_stats()["dispatch"]["spillbacks"]
               - before["dispatch"]["spillbacks"])
    if node != "gpu-node" or spilled < 1:
        fail(f"[multi-node] a num_gpus=1 task ran on {node} (CUDA_VISIBLE_"
             f"DEVICES {visible}) with {spilled} spillbacks from the head")

    params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    ckpt_bytes = sum(p.numel() * p.element_size() for p in param_leaves(params))
    t = time.perf_counter()
    ckpt_ref = ray_tpu_torch.put(Checkpoint.from_dict({"params": params}))
    put_s = time.perf_counter() - t
    del params
    free_device_memory()
    gpu_before = raylet_stats("gpu-node")
    t0 = time.perf_counter()
    actor = ray_tpu_torch.remote(num_gpus=1)(NodePredictor).remote(
        ckpt_ref, cfg, device)
    try:
        pid, actor_node, actor_visible = ray_tpu_torch.get(actor.where.remote(),
                                                           timeout=600)
        ready_s = time.perf_counter() - t0
        gpu_after = raylet_stats("gpu-node")
        answers, request_ms = [], []
        for i in range(n_requests):
            out, ms = ray_tpu_torch.get(actor.predict.remote(
                synthetic_batch(cfg, batch, seed=i)["tokens"]), timeout=600)
            answers.append(out)
            request_ms.append(ms)
            if i == 0:
                first_answer_s = time.perf_counter() - t0
        launches = ray_tpu_torch.get(actor.launches.remote(), timeout=60)
    finally:
        ray_tpu_torch.kill(actor)
    del ckpt_ref
    pulls = pulls_delta(gpu_after, gpu_before)
    differ = [i for i, a in enumerate(answers)
              if not same_answer(a, main["answers"][i])]
    log("[multi-node] " + json.dumps(dict(
        card=card, nodes=sorted(nodes), gpu_task=[node, visible],
        head_spillbacks=spilled, checkpoint_bytes=ckpt_bytes,
        checkpoint_put_s=put_s, actor=[pid, actor_node, actor_visible],
        gpu_node_pulls=pulls,
        pull_s=pulls["transfer_s"],
        pull_gb_s=pulls["bytes_in"] / pulls["transfer_s"] / 1e9
        if pulls["transfer_s"] else None,
        actor_ready_s=ready_s, actor_start_to_first_answer_s=first_answer_s,
        request_ms=request_ms, main_request_ms=main["request_ms"],
        differing_requests=differ, launches=launches)))
    if actor_node != "gpu-node" or pid == os.getpid():
        fail(f"[multi-node] the actor ran on {actor_node}, pid {pid}")
    if pulls["chunked"] < 1 or pulls["bytes_in"] < ckpt_bytes \
            or pulls["native"] or pulls["rpc"]:
        fail(f"[multi-node] the GPU node's raylet pulled {pulls}: expected the "
             f"checkpoint's {ckpt_bytes} bytes by the chunked rung")
    if differ:
        fail(f"[multi-node] requests {differ} differ from [main]'s answers")
    expected = cfg.n_layer * n_requests if on_card else 0
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[multi-node] the actor launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    return {"launches": launches}


def lineage_phase(card: str, ctx: dict, device="cuda", cfg=None,
                  batch: int = LINEAGE_BATCH) -> dict:
    """[multi-node-lineage] (module docstring) on the two nodes of `ctx`;
    the GPU node is replaced by a new one. Returns the launches summed
    over the task's two workers."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.api import _global_worker
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.object_store import native
    from ray_tpu_torch.core.object_store.shm_store import session_dir
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    cluster = ctx["cluster"]
    core = _global_worker().backend.core
    task = ray_tpu_torch.remote(num_gpus=1, max_retries=2)(node_gradient)
    head_before = raylet_stats()
    t = time.perf_counter()
    ref = task.remote(cfg, batch, device)
    node, pid, launches, loss, grad = ray_tpu_torch.get(ref, timeout=600)
    first_get_s = time.perf_counter() - t
    head_pulls = pulls_delta(raylet_stats(), head_before)
    arrived_on = str(grad.device)
    t = time.perf_counter()
    grad = grad.to(device)
    sync(device)
    to_card_s = time.perf_counter() - t
    want, want_loss = flat_gradient(cfg, synthetic_batch(cfg, batch, seed=0), device)
    equal = torch.equal(grad, want) and loss == want_loss
    nbytes = grad.numel() * grad.element_size()
    del grad

    # the same object's bytes straight from the GPU node's sendfile daemon,
    # against the copy the get pulled onto the head
    view = core.io.run(core.gcs.call("get_resource_view", timeout=30), timeout=60)
    port = view["gpu-node"]["transfer_port"]
    oid = ref.id.hex()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as scratch:
        dest = os.path.join(scratch, oid)
        t = time.perf_counter()
        got = native.fetch_to_file("127.0.0.1", port, rpc.get_auth_token() or "none",
                                   oid, dest) if port else None
        native_s = time.perf_counter() - t
        pulled = os.path.join(session_dir(core.session), oid)
        with open(dest, "rb") as a, open(pulled, "rb") as b:
            native_equal = got is not None and a.read() == b.read()

    # the GPU node dies with the only copy: the head drops the copy its get
    # pulled (free_objects on its raylet), the GPU node's raylet is killed
    # and the object's file removed from its session (what its tmpfs loses)
    core.io.run(core.raylet.call("free_objects", oids_hex=[oid], timeout=30),
                timeout=60)
    t = time.perf_counter()
    cluster.kill_node(ctx["gpu_node"])
    while "gpu-node" in alive_nodes():
        if time.perf_counter() - t > 60:
            fail("[multi-node-lineage] the GPU node's death was not seen in 60 s")
        time.sleep(0.05)
    death_seen_s = time.perf_counter() - t
    path = os.path.join(session_dir(cluster.session_of(ctx["gpu_node"])), oid)
    if os.path.exists(path):
        os.unlink(path)
    import uuid

    ctx["gpu_node"] = cluster.add_node(num_cpus=2, num_gpus=1,
                                       resources=ctx["kind"], node_id="gpu-node-2",
                                       session=f"s{uuid.uuid4().hex[:10]}")
    cluster.wait_for_nodes(2)
    t = time.perf_counter()
    node2, pid2, launches2, loss2, grad2 = ray_tpu_torch.get(ref, timeout=600)
    rebuilt_get_s = time.perf_counter() - t
    rebuilt_equal = torch.equal(grad2.to(device), want) and loss2 == want_loss
    del grad2, want
    free_device_memory()
    log("[multi-node-lineage] " + json.dumps(dict(
        card=card, batch=batch, seq_len=cfg.seq_len, gradient_bytes=nbytes,
        first=[node, pid], rebuilt=[node2, pid2], loss=loss,
        gradient_arrived_on=arrived_on, equal_to_this_process=equal,
        rebuilt_equal=rebuilt_equal, native_fetch_equal=native_equal,
        native_fetch_s=native_s,
        native_fetch_gb_s=nbytes / native_s / 1e9 if got else None,
        head_pulls=head_pulls, first_get_s=first_get_s, to_card_s=to_card_s,
        death_seen_s=death_seen_s, rebuilt_get_s=rebuilt_get_s,
        launches=[launches, launches2])))
    if node != "gpu-node" or node2 != "gpu-node-2" or os.getpid() in (pid, pid2):
        fail(f"[multi-node-lineage] the task ran on {node}, then {node2}")
    if head_pulls["chunked"] < 1 or head_pulls["bytes_in"] < nbytes:
        fail(f"[multi-node-lineage] the head pulled {head_pulls}: expected the "
             f"gradient's {nbytes} bytes by the chunked rung")
    if not equal:
        fail("[multi-node-lineage] the gradient differs from this process's")
    if not native_equal:
        fail(f"[multi-node-lineage] the daemon's bytes ({got}) differ from the "
             f"pulled copy's")
    if not rebuilt_equal:
        fail("[multi-node-lineage] the rebuilt gradient differs")
    expected = cfg.n_layer if on_card else 0
    for n in (launches, launches2):
        if n != {"flash_fwd": expected, "flash_bwd": expected}:
            fail(f"[multi-node-lineage] the workers launched {[launches, launches2]}, "
                 f"expected {expected} of each kernel in each")
    return {"launches": {k: launches[k] + launches2[k] for k in launches}}


CLIENT_SCRIPT = '''
import json, sys
import numpy as np
import ray_tpu_torch

ray_tpu_torch.init("ray://" + sys.argv[1])


def request(fields, device, batch, seed):
    import os
    from dataclasses import replace
    import torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.batch_predictor import TorchPredictor
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.train_step import synthetic_batch

    cfg = replace(gpt2.GPT2Config(), **fields)

    def apply_fn(params, batch):
        logits = gpt2.forward(params, batch["tokens"], cfg)[:, -1, :cfg.vocab_size]
        best = logits.float().max(dim=-1)
        return {"next_token": best.indices, "logit": best.values}

    params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    predictor = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), apply_fn=apply_fn, device=device)
    A.mha_forward_kernel.launches = A.mha_backward_kernel.launches = 0
    out = predictor.predict({"tokens": synthetic_batch(cfg, batch, seed=seed)["tokens"]})
    return (out, {"flash_fwd": A.mha_forward_kernel.launches,
                  "flash_bwd": A.mha_backward_kernel.launches},
            os.environ.get("RAY_TPU_NODE_ID"), os.getpid())


fields, device, batch = json.loads(sys.argv[2]), sys.argv[3], int(sys.argv[4])
out, launches, node, pid = ray_tpu_torch.get(
    ray_tpu_torch.remote(num_gpus=1)(request).remote(fields, device, batch, 0),
    timeout=600)
np.savez(sys.argv[5], **out)
joined = [m for m in sys.modules if m.startswith(("jax", "ray_tpu.", "chip_smoke"))
          or m == "ray_tpu" or m == "ray_tpu_torch.core.core_worker"]
print("CLIENT " + json.dumps({"launches": launches, "node": node, "pid": pid,
                              "modules_outside": joined}), flush=True)
ray_tpu_torch.shutdown()
'''


def client_phase(card: str, main: dict, ctx: dict, device="cuda", cfg=None,
                 batch: int = REQUEST_BATCH) -> dict:
    """[client] (module docstring) on the nodes of `ctx`. Returns the
    task's launches."""
    import tempfile

    from ray_tpu_torch.client import ClientServer
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.models import gpt2

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or gpt2.gpt2_124m()
    fields = {k: getattr(cfg, k) for k in CONFIG_FIELDS}
    if replace(gpt2.GPT2Config(), **fields) != cfg:
        fail(f"[client] {cfg} is not GPT2Config() with {fields}")
    server = ClientServer(host="127.0.0.1", port=0)
    server.start()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_client_") as scratch:
            out_path = os.path.join(scratch, "answer.npz")
            env = {**os.environ, "RAY_TPU_TOKEN": rpc.get_auth_token() or "",
                   "PYTHONPATH": str(REPO)}
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CLIENT_SCRIPT, server.address,
                 json.dumps(fields), device, str(batch), out_path],
                capture_output=True, text=True, timeout=600, env=env,
                cwd=scratch)
            client_s = time.perf_counter() - t
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CLIENT ")]
            if proc.returncode != 0 or not lines:
                fail(f"[client] the client driver exited {proc.returncode}: "
                     f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
            report = json.loads(lines[-1][len("CLIENT "):])
            with np.load(out_path) as f:
                answer = {k: f[k] for k in f.files}
    finally:
        server.stop()
    equal = same_answer(answer, main["answers"][0])
    log("[client] " + json.dumps(dict(
        card=card, batch=batch, seq_len=cfg.seq_len, equal_to_main=equal,
        client_process_s=client_s, **report)))
    if report["node"] != ctx["gpu_node"] or report["modules_outside"]:
        fail(f"[client] the task ran on {report['node']}; the client held "
             f"{report['modules_outside']}")
    if not equal:
        fail("[client] the client's answer differs from [main]'s first")
    expected = cfg.n_layer if on_card else 0
    if report["launches"] != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[client] the task launched {report['launches']}, expected "
             f"flash_fwd {expected} and flash_bwd 0")
    return {"launches": report["launches"]}


def multi_node_teardown(ctx: dict) -> None:
    """shutdown(), then nothing the cluster spawned left in /proc: no GCS,
    raylet, worker or rt_transfer daemon, of the live nodes or the killed
    one (waited for up to 15 s)."""
    import ray_tpu_torch

    cluster = ctx["cluster"]
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    # sessions, not node ids: a session name is unique to this cluster, where
    # a node id such as "head" may name another cluster's processes
    sessions = {cluster.session, *cluster._sessions.values()}
    deadline = time.monotonic() + 15
    while True:
        left = cluster_processes(*sessions)
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    log(f"[client] after shutdown: processes left {left}")
    if left:
        fail(f"[client] the cluster left processes {left} after shutdown")


def multi_node_phases(card: str, data: dict, device="cuda", cfg=None,
                      batch: int = LINEAGE_BATCH) -> dict:
    """[multi-node], [multi-node-lineage] and [client] on one cluster of two
    split-session nodes, each phase's seconds printed, then its teardown;
    the cluster stops whatever fails. `data` holds [main]'s kept answers
    ("serve"), and for a small rehearsal the serving config and request
    shape ("serve_cfg", "requests", "request_batch")."""
    import ray_tpu_torch

    serve_cfg = data.get("serve_cfg")
    ctx, out = None, {}
    try:
        ctx = start_two_nodes(device)
        log(f"[multi-node] two nodes up in {ctx['start_s']:.1f} s")
        for tag in MULTI_NODE_TAGS:
            free_device_memory()
            s = time.perf_counter()
            if tag == "multi-node":
                out[tag] = multi_node_phase(
                    card, data["serve"], ctx, device, serve_cfg,
                    data.get("requests", N_REQUESTS),
                    data.get("request_batch", REQUEST_BATCH))
            elif tag == "multi-node-lineage":
                out[tag] = lineage_phase(card, ctx, device, cfg, batch)
            else:
                out[tag] = client_phase(card, data["serve"], ctx, device, serve_cfg,
                                        data.get("request_batch", REQUEST_BATCH))
            log(f"[{tag}] took {time.perf_counter() - s:.1f} s")
    except BaseException:
        ray_tpu_torch.shutdown()
        if ctx is not None:
            ctx["cluster"].shutdown()
        raise
    multi_node_teardown(ctx)
    return out


def cluster_data_phases(card: str, data: dict, cluster_step_ms, device="cuda",
                        cfg=None, batch: int = TRAIN_BATCH) -> dict:
    """[data-train], [data-serve] and [rllib-remote] on the running
    cluster, each one's seconds printed. `data` holds [main]'s kept answers
    ("serve") and [rllib-ppo]'s result ("ppo"), and for a small rehearsal
    the serving config and request shape ("serve_cfg", "requests",
    "request_batch") and the train steps ("steps")."""
    out = {}
    for tag, fn in (
            ("data-train", lambda: data_train_phase(
                card, cluster_step_ms, device, cfg, batch,
                data.get("steps", DATA_TRAIN_STEPS))),
            ("data-serve", lambda: data_serve_phase(
                card, data["serve"], device, data.get("serve_cfg"),
                data.get("requests", N_REQUESTS),
                data.get("request_batch", REQUEST_BATCH))),
            ("rllib-remote", lambda: rllib_remote_phase(card, data["ppo"], device))):
        free_device_memory()
        s = time.perf_counter()
        out[tag] = fn()
        log(f"[{tag}] took {time.perf_counter() - s:.1f} s")
    return out


def cluster_teardown(ctx: dict, device="cuda") -> None:
    """[cluster]'s end: shutdown(), then nothing the cluster spawned left in
    /proc (waited for up to 10 s). nvidia-smi's compute apps are printed
    beside, not checked: in a container of its own PID namespace they list
    the host's pids."""
    import ray_tpu_torch

    ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 10
    while True:
        left = cluster_processes(ctx["node_id"], ctx["session"])
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    log(f"[cluster] after shutdown: processes left {left}; nvidia-smi's "
        f"compute apps {sorted(compute_apps())}")
    if left:
        fail(f"[cluster] the cluster left processes {left} after shutdown")


def cluster_phases(card: str, trainer: dict, train_step_ms=None,
                   world_one_gpt2=None, device="cuda", init_kwargs=None,
                   cfg=None, batch: int = TRAIN_BATCH, shape=CORE_SHAPE,
                   transfer_bytes: int = SERIALIZE_BYTES,
                   data: Optional[dict] = None) -> dict:
    """[cluster], [cluster-trainer] on its cluster, then with `data`
    [data-train], [data-serve] and [rllib-remote] (cluster_data_phases) and
    [collective], [actor-pool] and [stream] (util_phases) on the same
    cluster, then its teardown; the cluster stops whatever fails. Returns
    the phases' launches."""
    import ray_tpu_torch

    ctx = None
    try:
        ctx = cluster_phase(card, device, init_kwargs, shape, transfer_bytes)
        out = cluster_trainer_phase(card, trainer, train_step_ms, device,
                                    cfg, batch)
        multi_card_leases(device)
        multi_card_trainer(card, world_one_gpt2)
        more = {}
        if data is not None:
            more = cluster_data_phases(card, data, out["step_ms_median"],
                                       device, cfg, batch)
            more.update(util_phases(card, data, device, cfg, batch))
    except BaseException:
        ray_tpu_torch.shutdown()
        raise
    cluster_teardown(ctx, device)
    return {"cluster": ctx["launches"], "cluster_trainer": out["launches"],
            "cluster_trainer_step_ms_median": out["step_ms_median"],
            **{k: v["launches"] for k, v in more.items() if "launches" in v}}


# --------------------------------------------------------------------------- #
# Phases 35 and 36: pipelined submission and the observability planes
# --------------------------------------------------------------------------- #

OBSERVE_TAGS = ("pipelined", "observe")
OBSERVE_BURST = 24            # [pipelined]'s requests submitted at once
OBSERVE_STOLEN = 12           # requests submitted behind the blocker
OBSERVE_HOLD_S = 3.0          # the blocker's sleep, holding its run slot
OBSERVE_STOLEN_MAX_S = 1.5    # the stolen requests' bound (the blocker: 3 s)
# pinned far above OBSERVE_HOLD_S: only a steal can move a queued request
OBSERVE_REQUEUE_MS = 5000
OBSERVE_DEADLINE_S = 30.0
OBSERVE_METRICS_MS = 500      # the cluster's metrics flush and sample period
OBSERVE_TIMELINE = REPO / "build" / "observe_timeline.json"
_OBSERVE_PREDICTORS: dict = {}


def observe_request(params_box, cfg, tokens, device, hold_s: float = 0.0,
                    barrier: Optional[str] = None):
    """[pipelined]'s and [observe]'s GPU task. [main]'s TorchPredictor over
    the parameters put once (params_box[0], a ref this worker process gets
    once and keeps), one forward of `tokens` inside profile_span("forward"),
    timed by the host clock and by CUDA events; then `hold_s` seconds of
    time.sleep, holding the run slot (the blocker). With `barrier` (a
    directory), the task first waits there for a second task, so a pair of
    them runs in two worker processes at once. Returns the answer, the host
    and CUDA-event ms, remaining_time_s(), this forward's launches, the
    process's launches so far and its work steals, its pid and its cards."""
    import ray_tpu_torch
    from ray_tpu_torch import tracing

    key = params_box[0].id.hex()
    predictor = _OBSERVE_PREDICTORS.get(key)
    if predictor is None:
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.batch_predictor import TorchPredictor

        params = ray_tpu_torch.get(params_box[0], timeout=600)
        predictor = _OBSERVE_PREDICTORS.setdefault(key, TorchPredictor(
            params, serve_apply_fn(gpt2, cfg), device=device))
        del params
    if barrier is not None:
        Path(barrier, str(os.getpid())).touch()
        deadline = time.monotonic() + 120
        while len(os.listdir(barrier)) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    on_card = torch.device(device).type == "cuda"
    before = launches_since_reset()
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t = time.perf_counter()
    with tracing.profile_span("forward"):
        out = predictor.predict({"tokens": tokens})  # numpy: synced
    host_ms = (time.perf_counter() - t) * 1e3
    cuda_ms = None
    if on_card:
        end.record()
        end.synchronize()
        cuda_ms = start.elapsed_time(end)
    after = launches_since_reset()
    core = ray_tpu_torch.api._global_worker().backend.core
    steals = getattr(getattr(core, "_exec_slot", None), "steals", 0)
    remaining = ray_tpu_torch.remaining_time_s()
    if hold_s:
        time.sleep(hold_s)
    return {"answer": out, "host_ms": host_ms, "cuda_ms": cuda_ms,
            "remaining_s": remaining,
            "launches": {k: after[k] - before[k] for k in after},
            "process_launches": after, "steals": steals, "pid": os.getpid(),
            "cards": os.environ.get("CUDA_VISIBLE_DEVICES")}


@contextmanager
def observe_depth(depth: int):
    """The driver's worker_max_tasks_in_flight for a block."""
    from ray_tpu_torch.core.config import _config

    saved = _config.worker_max_tasks_in_flight
    _config.worker_max_tasks_in_flight = depth
    try:
        yield
    finally:
        _config.worker_max_tasks_in_flight = saved


def observe_check_answers(tag: str, results: list, main: dict, seeds) -> None:
    differ = [i for i, (r, s) in enumerate(zip(results, seeds))
              if not same_answer(r["answer"], main["answers"][s])]
    if differ:
        fail(f"[{tag}] requests {differ} differ from [main]'s answers")


def observe_pair(task, params_box, cfg, tokens: list, device) -> list:
    """Two requests at depth 1 that meet at a barrier: each runs in a
    worker process of its own, which gets the parameters if it has not."""
    import tempfile

    import ray_tpu_torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as barrier, \
            observe_depth(1):
        refs = [task.remote(params_box, cfg, tokens[i % len(tokens)], device,
                            barrier=barrier) for i in range(2)]
        out = ray_tpu_torch.get(refs, timeout=900)
    if len({r["pid"] for r in out}) != 2:
        fail(f"[pipelined] the pair ran in one process {out[0]['pid']}")
    return [(r.task_id.hex(), o) for r, o in zip(refs, out)]


def observe_burst(task, params_box, cfg, tokens: list, device, n: int,
                  depth: int) -> dict:
    """n requests submitted at once at the driver's depth `depth`: their
    results (request i is [main]'s request i mod len(tokens)), the wall
    time to the last answer, each request's submit-to-answer ms on the
    host clock, and the most specs one lease carried at once."""
    import ray_tpu_torch

    core = ray_tpu_torch.api._global_worker().backend.core
    core.lease_stats["max_inflight"] = 0
    with observe_depth(depth):
        t0 = time.perf_counter()
        refs = [task.remote(params_box, cfg, tokens[i % len(tokens)], device)
                for i in range(n)]
        done, pending = {}, list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                                timeout=600)
            if not ready:
                fail(f"[pipelined] {len(pending)} requests unanswered after 600 s")
            for r in ready:
                done[r.task_id.hex()] = (time.perf_counter() - t0) * 1e3
        wall_s = time.perf_counter() - t0
        results = ray_tpu_torch.get(refs, timeout=60)
    return {"results": results, "refs": refs, "wall_s": wall_s,
            "e2e_ms": [done[r.task_id.hex()] for r in refs],
            "max_inflight": core.lease_stats["max_inflight"]}


def pipelined_phase(card: str, main: dict, task, params_box, cfg, tokens: list,
                    device, ledger: list) -> dict:
    """[pipelined] (module docstring) on the running cluster. `ledger`
    gets every executed request's (task id, result)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.config import _config

    n_main = len(tokens)
    on_card = torch.device(device).type == "cuda"
    core = ray_tpu_torch.api._global_worker().backend.core
    t = time.perf_counter()
    warm_pair = observe_pair(task, params_box, cfg, tokens, device)
    warm = [r for _, r in warm_pair]
    warm_s = time.perf_counter() - t
    observe_check_answers("pipelined", warm, main, [0, 1 % n_main])
    seeds = [i % n_main for i in range(OBSERVE_BURST)]

    deep = observe_burst(task, params_box, cfg, tokens, device, OBSERVE_BURST,
                         _config.worker_max_tasks_in_flight)
    observe_check_answers("pipelined", deep["results"], main, seeds)
    one = observe_burst(task, params_box, cfg, tokens, device, OBSERVE_BURST, 1)
    observe_check_answers("pipelined", one["results"], main, seeds)

    # work stealing: a blocker holds its run slot; requests queued behind
    # it must move to the other worker long before it ends
    stolen_before = core.lease_stats["stolen"]
    blocker = task.remote(params_box, cfg, tokens[0], device, hold_s=OBSERVE_HOLD_S)
    blocker_t0 = time.perf_counter()
    time.sleep(0.5)  # its forward is done, it sleeps holding the slot
    t = time.perf_counter()
    refs = [task.remote(params_box, cfg, tokens[i % n_main], device)
            for i in range(OBSERVE_STOLEN)]
    stolen = ray_tpu_torch.get(refs, timeout=600)
    stolen_s = time.perf_counter() - t
    held = ray_tpu_torch.get(blocker, timeout=600)
    blocker_s = time.perf_counter() - blocker_t0
    stolen_by_owner = core.lease_stats["stolen"] - stolen_before
    observe_check_answers("pipelined", stolen + [held], main,
                          [i % n_main for i in range(OBSERVE_STOLEN)] + [0])
    # both workers' steal counts, read after the steal
    count_pair = observe_pair(task, params_box, cfg, tokens, device)
    steals = {r["pid"]: r["steals"] for _, r in count_pair}

    ran = warm + deep["results"] + one["results"] + stolen + [held]
    ledger.extend(zip([tid for tid, _ in warm_pair]
                      + [r.task_id.hex() for r in deep["refs"]]
                      + [r.task_id.hex() for r in one["refs"]]
                      + [r.task_id.hex() for r in refs] + [blocker.task_id.hex()],
                      ran))
    ledger.extend(count_pair)
    ran += [r for _, r in count_pair]
    launches = {k: sum(r["launches"][k] for r in ran)
                for k in ("flash_fwd", "flash_bwd")}
    deep_launches = sum(r["launches"]["flash_fwd"] for r in deep["results"])
    log("[pipelined] " + json.dumps(dict(
        card=card, requests=OBSERVE_BURST, batch=int(tokens[0].shape[0]),
        seq_len=cfg.seq_len, warm_up_s=warm_s,
        depth=_config.worker_max_tasks_in_flight,
        wall_s=deep["wall_s"], requests_per_s=OBSERVE_BURST / deep["wall_s"],
        max_specs_on_one_lease=deep["max_inflight"],
        depth_1_wall_s=one["wall_s"],
        depth_1_requests_per_s=OBSERVE_BURST / one["wall_s"],
        depth_1_max_specs_on_one_lease=one["max_inflight"],
        e2e_ms_median=float(np.median(deep["e2e_ms"])),
        depth_1_e2e_ms_median=float(np.median(one["e2e_ms"])),
        forward_host_ms_median=float(np.median(
            [r["host_ms"] for r in deep["results"]])),
        pids=sorted({r["pid"] for r in ran}),
        cards=sorted({str(r["cards"]) for r in ran}),
        stolen_requests=OBSERVE_STOLEN, stolen_s=stolen_s,
        blocker_hold_s=OBSERVE_HOLD_S, blocker_s=blocker_s,
        stolen_by_owner=stolen_by_owner, steals_by_worker=steals,
        requeue_after_ms=OBSERVE_REQUEUE_MS, launches=launches)))
    log(f"[pipelined] {OBSERVE_BURST} requests: {deep['wall_s']:.3f} s "
        f"({OBSERVE_BURST / deep['wall_s']:.2f} requests/s) pipelined, "
        f"{one['wall_s']:.3f} s ({OBSERVE_BURST / one['wall_s']:.2f} "
        f"requests/s) at worker_max_tasks_in_flight=1; {card}")
    log(f"[pipelined] {OBSERVE_STOLEN} requests behind the blocker answered "
        f"in {stolen_s:.3f} s, the blocker in {blocker_s:.3f} s (it holds "
        f"its slot {OBSERVE_HOLD_S} s); {card}")
    if not 2 <= deep["max_inflight"] <= _config.worker_max_tasks_in_flight:
        fail(f"[pipelined] the most specs on one lease was "
             f"{deep['max_inflight']}, expected 2 to "
             f"{_config.worker_max_tasks_in_flight}")
    if one["max_inflight"] != 1:
        fail(f"[pipelined] at depth 1 a lease carried {one['max_inflight']} specs")
    if len({r["pid"] for r in ran}) != 2:
        fail(f"[pipelined] the requests ran in {sorted({r['pid'] for r in ran})}, "
             f"expected two GPU worker processes")
    if stolen_s >= OBSERVE_STOLEN_MAX_S or stolen_by_owner < 1 \
            or sum(steals.values()) < 1:
        fail(f"[pipelined] the requests behind the blocker took {stolen_s:.3f} s "
             f"(bound {OBSERVE_STOLEN_MAX_S} s), {stolen_by_owner} stolen at "
             f"the owner, workers' steals {steals}")
    expected = cfg.n_layer * len(ran) if on_card else 0
    if launches != {"flash_fwd": expected, "flash_bwd": 0} or \
            deep_launches != (cfg.n_layer * OBSERVE_BURST if on_card else 0):
        fail(f"[pipelined] the requests launched {launches} ({deep_launches} "
             f"in the burst), expected flash_fwd {expected} and flash_bwd 0")
    return {"launches": launches,
            "host_e2e_ms_median": float(np.median(deep["e2e_ms"]))}


def observe_phase(card: str, main: dict, task, params_box, cfg, tokens: list,
                  device, ledger: list, ctx: dict) -> dict:
    """[observe] (module docstring) on the running cluster, after
    [pipelined]: `ledger` holds every request that ran before."""
    import ray_tpu_torch
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch import tracing
    from ray_tpu_torch.analysis import sanitizers as san
    from ray_tpu_torch.util import state

    on_card = torch.device(device).type == "cuda"
    with tracing.deadline_context(time.time() - 0.1):
        shed_ref = task.remote(params_box, cfg, tokens[0], device)
    try:
        ray_tpu_torch.get(shed_ref, timeout=120)
        fail("[observe] a request past its deadline was answered")
    except exc.DeadlineExceededError as e:
        shed_error = str(e)
    with tracing.deadline_context(time.time() + OBSERVE_DEADLINE_S):
        budget_ref = task.remote(params_box, cfg, tokens[0], device)
        budget = ray_tpu_torch.get(budget_ref, timeout=120)
    observe_check_answers("observe", [budget], main, [0])
    # both workers' launch counts: every launch belongs to a request that ran
    probe_pair = observe_pair(task, params_box, cfg, tokens, device)
    probe = [r for _, r in probe_pair]
    ledger.extend([(budget_ref.task_id.hex(), budget), *probe_pair])
    by_pid = {}
    for _, r in ledger:
        by_pid[r["pid"]] = by_pid.get(r["pid"], 0) + r["launches"]["flash_fwd"]
    counted = {r["pid"]: r["process_launches"]["flash_fwd"] for r in probe}
    if counted != by_pid:
        fail(f"[observe] the workers launched {counted} flash_fwd, the "
             f"requests that ran account for {by_pid}")
    rem = budget["remaining_s"]
    if rem is None or not 0 < rem <= OBSERVE_DEADLINE_S:
        fail(f"[observe] remaining_time_s() in a task under a "
             f"{OBSERVE_DEADLINE_S} s deadline was {rem}")

    # task events: owner, raylet and workers flush on ~1 s loops
    ran_ids = [tid for tid, _ in ledger]
    deadline = time.monotonic() + 30
    while True:
        rows = {t["task_id"]: t for t in state.list_tasks(limit=10_000)}
        settled = all(rows.get(tid, {}).get("state") == "FINISHED"
                      for tid in ran_ids)
        shed_row = rows.get(shed_ref.task_id.hex(), {})
        if (settled and shed_row.get("state") == "FAILED"
                and len(state.timeline_events()) > 0) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    time.sleep(1.5)  # the workers' EXECUTED and spans of the last requests
    OBSERVE_TIMELINE.parent.mkdir(parents=True, exist_ok=True)
    trace = ray_tpu_torch.timeline(str(OBSERVE_TIMELINE))
    name = observe_request.__name__
    finished = [e for e in trace if e["name"] == f"{name}:FINISHED"]
    finished_ids = [e["args"].get("task_id") for e in finished]
    runs = {e["args"]["task_id"]: e for e in trace
            if e["ph"] == "X" and e["name"] == name}
    spans = {}
    for e in trace:
        if e["ph"] == "X" and e["name"] == "forward":
            spans[e["args"].get("task_id")] = e
    missing_rows = [t for t in ran_ids if finished_ids.count(t) != 1]
    outside = []
    span_ms, cuda_ms = [], []
    for tid, r in ledger:
        run, span = runs.get(tid), spans.get(tid)
        if run is None or span is None or (run["pid"], run["tid"]) != (
                span["pid"], span["tid"]) or not (
                run["ts"] <= span["ts"]
                and span["ts"] + span["dur"] <= run["ts"] + run["dur"]):
            outside.append(tid)
            continue
        span_ms.append(span["dur"] / 1e3)
        if r["cuda_ms"] is not None:
            cuda_ms.append(r["cuda_ms"])
    summary = state.summarize_tasks()
    counts = summary["tasks"].get(name, {})
    submitted = len(ledger) + 1  # and the shed request
    shed_events = [e["state"] for e in (state.get_task(
        shed_ref.task_id.hex()) or {}).get("events", [])]

    # metrics: the GCS derives task_e2e_ms from the task events
    deadline = time.monotonic() + 20
    while True:
        samples = state.get_metrics_timeseries(names=["task_e2e_ms"], limit=1)
        pts = {}
        if samples:
            hist = next((s for s in samples[-1]["series"]
                         if s["name"] == "task_e2e_ms"), None)
            pts = hist["points"] if hist else {}
        e2e_count = pts.get((("name", name),), [0])[-1]
        if e2e_count >= submitted or time.monotonic() > deadline:
            break
        time.sleep(0.25)
    p50 = state.metric_percentile("task_e2e_ms", 0.5, {"name": name})
    summary_metrics = state.summarize_metrics()

    # sanitizers: this driver's own, and the daemons' and workers' counter
    # (the merge less this driver's registry)
    from ray_tpu_torch.util.metrics import get_registry

    def by_kind(series_list):
        vio = next((s for s in series_list
                    if s["name"] == "sanitizer_violations_total"), None)
        return {dict(k).get("kind"): v
                for k, v in (vio["points"].items() if vio else ())}

    time.sleep(2 * OBSERVE_METRICS_MS / 1e3)  # one more flush of every process
    merged = by_kind(state._gcs_call("collect_metrics"))
    mine = by_kind(get_registry().collect())
    daemons = {k: merged.get(k, 0) - mine.get(k, 0) for k in merged}
    driver = {k: v - ctx["violations"].get(k, 0)
              for k, v in san.violation_counts().items()}
    launches = {k: budget["launches"][k] + sum(r["launches"][k] for r in probe)
                for k in ("flash_fwd", "flash_bwd")}
    log("[observe] " + json.dumps(dict(
        card=card, shed_error=shed_error, shed_task_events=shed_events,
        remaining_time_s=rem, deadline_s=OBSERVE_DEADLINE_S,
        launches_by_worker=counted, timeline=str(OBSERVE_TIMELINE.relative_to(REPO)),
        timeline_events=len(trace), requests_run=len(ran_ids),
        finished_rows=len(finished), spans_outside_running=outside,
        summarize_tasks=counts, submitted=submitted,
        task_e2e_ms_count=e2e_count, task_e2e_ms_p50=p50,
        host_e2e_ms_median=ctx.get("host_e2e_ms_median"),
        forward_span_ms_median=float(np.median(span_ms)) if span_ms else None,
        forward_cuda_ms_median=float(np.median(cuda_ms)) if cuda_ms else None,
        tasks_finished=summary_metrics.get("tasks_finished"),
        driver_violations=driver, daemon_violations=daemons,
        sanitizers=san.report().splitlines()[0], launches=launches)))
    log(f"[observe] task_e2e_ms p50 {p50} ms (the GCS's series) beside the "
        f"host clock's median {ctx.get('host_e2e_ms_median')} ms of the "
        f"pipelined burst; the forward's span "
        f"{float(np.median(span_ms)) if span_ms else None} ms beside its "
        f"CUDA-event time {float(np.median(cuda_ms)) if cuda_ms else None} ms; "
        f"{card}")
    if "RUNNING" in shed_events or "DISPATCHED" in shed_events:
        fail(f"[observe] the shed request reached a worker: {shed_events}")
    if missing_rows or outside:
        fail(f"[observe] the timeline lacks one FINISHED row for requests "
             f"{missing_rows}, or their forward span lies outside their RUNNING "
             f"span: {outside}")
    if counts != {"FINISHED": len(ledger), "FAILED": 1}:
        fail(f"[observe] summarize_tasks counts {counts} for {name}, expected "
             f"{len(ledger)} FINISHED and the shed one FAILED")
    if e2e_count < submitted:
        fail(f"[observe] task_e2e_ms counts {e2e_count} of {name}, "
             f"{submitted} submitted")
    if p50 is None or p50 <= 0:
        fail(f"[observe] metric_percentile('task_e2e_ms', 0.5) gave {p50}")
    for where, got in (("this driver", driver), ("the daemons", daemons)):
        if got.get("lock_order") or got.get("affinity"):
            fail(f"[observe] sanitizer violations in {where}: {got}; "
                 f"{san.report()}")
    expected = cfg.n_layer * 3 if on_card else 0
    if launches != {"flash_fwd": expected, "flash_bwd": 0}:
        fail(f"[observe] the requests launched {launches}, expected flash_fwd "
             f"{expected} and flash_bwd 0")
    return {"launches": launches}


def observe_phases(card: str, data: dict, device="cuda", cfg=None) -> dict:
    """[pipelined] and [observe] on one cluster of their own, started with
    RAY_TPU_SANITIZE=1 (every daemon and worker sanitized, and this
    driver's locks made from then on), worker_requeue_after_ms pinned at
    OBSERVE_REQUEUE_MS and the metrics period at OBSERVE_METRICS_MS; each
    phase's seconds printed, then shutdown() and no process of the cluster
    left. `data` holds [main]'s kept answers ("serve"), and for a small
    rehearsal the serving config and request shape ("serve_cfg",
    "requests", "request_batch")."""
    import ray_tpu_torch
    from ray_tpu_torch.analysis import sanitizers as san
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.train_step import synthetic_batch

    cfg = data.get("serve_cfg") or cfg or gpt2.gpt2_124m()
    n_main = data.get("requests", N_REQUESTS)
    batch = data.get("request_batch", REQUEST_BATCH)
    tokens = [synthetic_batch(cfg, batch, seed=i)["tokens"] for i in range(n_main)]
    env = {"RAY_TPU_SANITIZE": "1",
           "RAY_TPU_WORKER_REQUEUE_AFTER_MS": str(OBSERVE_REQUEUE_MS),
           "RAY_TPU_METRICS_REPORT_INTERVAL_MS": str(OBSERVE_METRICS_MS)}
    saved_env = {k: os.environ.get(k) for k in env}
    saved_gate = san.enabled()
    os.environ.update(env)
    san.enable(True)
    ctx, out, ledger = {"violations": san.violation_counts()}, {}, []
    try:
        t0 = time.perf_counter()
        ray_tpu_torch.init(num_cpus=2, num_gpus=None if device != "cpu" else 1)
        core = ray_tpu_torch.api._global_worker().backend.core
        ctx.update(node_id=core.node_id, session=core.session)
        params = gpt2.init(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
        params_box = [ray_tpu_torch.put(params)]
        del params
        free_device_memory()
        log(f"[pipelined] cluster up and the parameters put in "
            f"{time.perf_counter() - t0:.1f} s")
        task = ray_tpu_torch.remote(num_gpus=0.5)(observe_request)
        for tag in OBSERVE_TAGS:
            s = time.perf_counter()
            if tag == "pipelined":
                out[tag] = pipelined_phase(card, data["serve"], task, params_box,
                                           cfg, tokens, device, ledger)
                ctx["host_e2e_ms_median"] = out[tag].pop("host_e2e_ms_median", None)
            else:
                out[tag] = observe_phase(card, data["serve"], task, params_box,
                                         cfg, tokens, device, ledger, ctx)
            log(f"[{tag}] took {time.perf_counter() - s:.1f} s")
    finally:
        ray_tpu_torch.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        san.enable(saved_gate)
    if "node_id" in ctx:
        deadline = time.monotonic() + 10
        while True:
            left = cluster_processes(ctx["session"])
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        log(f"[observe] after shutdown: processes left {left}")
        if left:
            fail(f"[observe] the cluster left processes {left} after shutdown")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compare-fwd", metavar="SRC",
                        help="also time flash_fwd built from SRC (same C "
                             "entry point) against the current one")
    parser.add_argument("--compare-bwd", metavar="SRC",
                        help="also time flash_bwd built from SRC (same C "
                             "entry point) against the current one")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")

    card = nvidia_smi()
    log(f"[env] {card}")
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd = attention_cases(gen)
    if args.compare_fwd:
        compare_forward(args.compare_fwd, gen)
    bwd = backward_cases(gen)
    if args.compare_bwd:
        compare_backward(args.compare_bwd, gen)

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.train.train_step import (
        make_gpt2_train_step, make_llama_train_step,
    )

    free_device_memory()
    main_answers = {}
    serve = serve_path(card, args.profile, "main", "gpt2_124m", gpt2,
                       gpt2.gpt2_124m(), N_REQUESTS, REQUEST_BATCH,
                       (LOGITS_MAX_TOL, LOGITS_MEAN_TOL), keep=main_answers)
    free_device_memory()
    train = train_path(card, args.profile, "train", "gpt2_124m", gpt2,
                       make_gpt2_train_step, gpt2.gpt2_124m(remat=False),
                       TRAIN_BATCH, COMPARE_BATCH, GRAD_PATH_REL_TOL)
    free_device_memory()
    llama_serve = serve_path(card, args.profile, "llama-serve", "llama_7b",
                             llama, llama.llama_7b(), LLAMA_REQUESTS,
                             LLAMA_REQUEST_BATCH,
                             (LLAMA_LOGITS_MAX_TOL, LLAMA_LOGITS_MEAN_TOL))
    free_device_memory()
    llama_train = train_path(card, args.profile, "llama-train", "llama_1b",
                             llama, make_llama_train_step,
                             llama.llama_1b(remat=False), LLAMA_TRAIN_BATCH,
                             LLAMA_COMPARE_BATCH, LLAMA_GRAD_PATH_REL_TOL)
    free_device_memory()
    llama_hd128_gradients()

    free_device_memory()
    moe_layer_cases(gen)
    free_device_memory()
    moe_cfg = gpt2.gpt2_124m(moe_experts=MOE_EXPERTS)
    moe_serve = serve_path(card, args.profile, "moe-serve", "gpt2_124m_moe8",
                           gpt2, moe_cfg, N_REQUESTS, REQUEST_BATCH,
                           (MOE_LOGITS_MAX_TOL, MOE_LOGITS_MEAN_TOL))
    free_device_memory()
    moe_train = train_path(card, args.profile, "moe-train", "gpt2_124m_moe8",
                           gpt2, make_gpt2_train_step,
                           replace(moe_cfg, remat=False), TRAIN_BATCH,
                           COMPARE_BATCH, MOE_GRAD_PATH_REL_TOL, MOE_LOSS_TOL)

    par = parallel_phase(card, args.profile)
    # after the model paths: their step times stay comparable with runs
    # that had no [ring] before them (the mesh step is host-bound)
    ring = ring_phase(card, gen)
    gathered = gathered_phase(card, gen)
    # a multi-card gathered plan's rank: the last chunk's offset at its shape
    for plan in multi_card_plans(torch.cuda.device_count()):
        if gathered_plan(plan):
            (_, _, Sc, _), _ = rank_attention_shape(plan)
            cp = plan["mesh"]["cp"]
            rows = gathered[f"{plan['config']}_cp{cp}"]["rows"]
            ring[f"fwd_rank_{plan['name']}"] = rows[f"fwd_q@{(cp - 1) * Sc}"]
            ring[f"rank_{plan['name']}"] = rows[f"q@{(cp - 1) * Sc}"]

    def numbers(row, launches):
        """One path's numbers for a kernel: its launches on that path beside
        the case run at that path's shape."""
        return {"launches": launches, "shape": row["shape"],
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "bound_share",
                                       "library_ms")}}

    def multi_card_paths(rows, prefix, runs, kernel):
        """The multi-card runs' rank 0 launches, beside the case at that
        rank's shape (a ring chunk's diagonal under cp)."""
        rows = {**rows, **ring}
        return {f"multi_card_{n}": numbers(rows[f"{prefix}rank_{n}"], run[kernel])
                for n, run in runs.items()}

    def ring_paths(prefix, kernel):
        """[ring]'s launches beside its diagonal chunk's case, and the
        cases at the other chunks' offsets."""
        return {f"ring_{n}_cp{RING_CP}": {
            **numbers(ring[n]["rows"][f"{prefix}diagonal"],
                      ring[n]["launches"][kernel]),
            "chunks": {w: {k: ring[n]["rows"][f"{prefix}{w}"][k] for k in (
                "q_off", "kv_off", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for w in ("past", "diagonal", "future")}}
            for n in ("gpt2_124m", "llama_1b")}

    def gathered_paths(prefix, kernel):
        """[gathered]'s launches beside its last chunk's case, and the
        cases at every chunk's offset."""
        out = {}
        for n, case in gathered.items():
            rows = {k[len(prefix) + 2:]: r for k, r in case["rows"].items()
                    if k.startswith(prefix + "q@")}
            last = max(rows, key=int)
            out[f"gathered_{n}"] = {
                **numbers(rows[last], case["launches"][kernel]),
                "chunks": {f"q@{off}": {k: rows[off][k] for k in (
                    "shape", "skv", "q_off", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "library")}
                    for off in sorted(rows, key=int)}}
        return out

    rllib = rllib_phase(card, args.profile)
    # the runtime and Train on it, after the model paths (their step times
    # stay comparable with earlier runs)
    free_device_memory()
    core = core_phase(card)
    free_device_memory()
    trainer = trainer_phase(card, train["step_ms_median"])
    # the multi-process runtime: worker processes of a one-node cluster
    # the Data layer in the in-process runtime
    free_device_memory()
    data = data_phase(card)
    free_device_memory()
    cluster = cluster_phases(card, trainer, train["step_ms_median"],
                             par["world_one_gpt2"],
                             data={"serve": main_answers,
                                   "ppo": rllib["rllib-ppo"]})
    # the runtime on several nodes: two split-session nodes on this host
    free_device_memory()
    multi = multi_node_phases(card, {"serve": main_answers})
    # pipelined submission and the observability planes: a sanitized
    # one-node cluster of their own
    free_device_memory()
    observe = observe_phases(card, {"serve": main_answers})

    # top level: GPT-2's training path at its own shape; by_path: each main
    # path at its own shape with its own launches
    fwd_paths = {
        "train": numbers(bwd["fwd_main"], train["launches"]["flash_fwd"]),
        "serve": numbers(fwd["main"], serve),
        "llama_serve": numbers(fwd["llama_serve"], llama_serve),
        "llama_train": numbers(bwd["fwd_llama_train"], llama_train["launches"]["flash_fwd"]),
        "moe_serve": numbers(fwd["main"], moe_serve),
        "moe_train": numbers(bwd["fwd_main"], moe_train["launches"]["flash_fwd"]),
        "parallel_train": numbers(bwd["fwd_main"], par["parallel"]["flash_fwd"]),
        "parallel_moe_train": numbers(bwd["fwd_main"],
                                      par["parallel-moe"]["flash_fwd"]),
        "pipeline": numbers(bwd["fwd_pipeline"], par["pipeline"]["flash_fwd"]),
        "parallel_tp_llama_train": numbers(bwd["fwd_llama_train"],
                                           par["parallel-tp"]["flash_fwd"]),
        "parallel_tp_llama_train_remat": numbers(
            bwd["fwd_llama_train"], par["parallel-tp-remat"]["flash_fwd"]),
        "parallel_cp_train": numbers(bwd["fwd_main"],
                                     par["parallel-cp"]["flash_fwd"]),
        "parallel_moe_cp_train": numbers(bwd["fwd_main"],
                                         par["parallel-moe-cp"]["flash_fwd"]),
        "parallel_gathered_train": numbers(bwd["fwd_main"],
                                           par["parallel-gathered"]["flash_fwd"]),
        **ring_paths("fwd_", "flash_fwd"),
        **gathered_paths("fwd_", "flash_fwd"),
        **multi_card_paths(bwd, "fwd_", par["multi_card"], "flash_fwd"),
        "core": numbers(fwd["main"], core["flash_fwd"]),
        "trainer": numbers(bwd["fwd_main"], trainer["launches"]["flash_fwd"]),
        "cluster": numbers(fwd["main"], cluster["cluster"]["flash_fwd"]),
        "cluster_trainer": numbers(bwd["fwd_main"],
                                   cluster["cluster_trainer"]["flash_fwd"]),
        "data_train": numbers(bwd["fwd_main"], cluster["data-train"]["flash_fwd"]),
        "data_serve": numbers(fwd["main"], cluster["data-serve"]["flash_fwd"]),
        "collective": numbers(bwd["fwd_collective"],
                              cluster["collective"]["flash_fwd"]),
        "actor_pool": numbers(fwd["main"], cluster["actor-pool"]["flash_fwd"]),
        "stream": numbers(fwd["main"], cluster["stream"]["flash_fwd"]),
        "multi_node": numbers(fwd["main"],
                              multi["multi-node"]["launches"]["flash_fwd"]),
        "multi_node_lineage": numbers(
            fwd["main"], multi["multi-node-lineage"]["launches"]["flash_fwd"]),
        "client": numbers(fwd["main"], multi["client"]["launches"]["flash_fwd"]),
        "pipelined": numbers(fwd["main"],
                             observe["pipelined"]["launches"]["flash_fwd"]),
        "observe": numbers(fwd["main"], observe["observe"]["launches"]["flash_fwd"]),
    }
    bwd_paths = {
        "train": numbers(bwd["main"], train["launches"]["flash_bwd"]),
        "llama_train": numbers(bwd["llama_train"], llama_train["launches"]["flash_bwd"]),
        "moe_train": numbers(bwd["main"], moe_train["launches"]["flash_bwd"]),
        "parallel_train": numbers(bwd["main"], par["parallel"]["flash_bwd"]),
        "parallel_moe_train": numbers(bwd["main"],
                                      par["parallel-moe"]["flash_bwd"]),
        "pipeline": numbers(bwd["pipeline"], par["pipeline"]["flash_bwd"]),
        "parallel_tp_llama_train": numbers(bwd["llama_train"],
                                           par["parallel-tp"]["flash_bwd"]),
        "parallel_tp_llama_train_remat": numbers(
            bwd["llama_train"], par["parallel-tp-remat"]["flash_bwd"]),
        "parallel_cp_train": numbers(bwd["main"], par["parallel-cp"]["flash_bwd"]),
        "parallel_moe_cp_train": numbers(bwd["main"],
                                         par["parallel-moe-cp"]["flash_bwd"]),
        "parallel_gathered_train": numbers(bwd["main"],
                                           par["parallel-gathered"]["flash_bwd"]),
        **ring_paths("", "flash_bwd"),
        **gathered_paths("", "flash_bwd"),
        **multi_card_paths(bwd, "", par["multi_card"], "flash_bwd"),
        "core": numbers(bwd["core"], core["flash_bwd"]),
        "trainer": numbers(bwd["main"], trainer["launches"]["flash_bwd"]),
        "cluster": numbers(bwd["core"], cluster["cluster"]["flash_bwd"]),
        "cluster_trainer": numbers(bwd["main"],
                                   cluster["cluster_trainer"]["flash_bwd"]),
        "data_train": numbers(bwd["main"], cluster["data-train"]["flash_bwd"]),
        "collective": numbers(bwd["collective"], cluster["collective"]["flash_bwd"]),
        "multi_node_lineage": numbers(
            bwd["core"], multi["multi-node-lineage"]["launches"]["flash_bwd"]),
    }
    log(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:64",
        "status": "ported", **fwd_paths["train"], "by_path": fwd_paths,
    }, {
        "name": "flash_bwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/attention.py:220",
        "status": "ported", **bwd_paths["train"], "by_path": bwd_paths,
    }], "to_port": []}))
    log(f"[smoke] the whole smoke took {time.perf_counter() - t_start:.1f} s; "
        f"{card}")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
