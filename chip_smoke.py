#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`accelerate_tpu_torch`) on one NVIDIA H100.

Phases run in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and its compute
   capability, which must be 9.0;
2. build: nvcc compiles the kernel libraries from accelerate_tpu_torch/ops/csrc/
   (one nvcc per source, all started together); ptxas's registers, spills
   and static shared memory of each flash forward kernel, of each bf16
   dQ and dK/dV kernel, of each bf16 fused-CE dH and dW kernel (with the
   dH and dW launches at e 768: CTAs a cluster, ring stages, shared memory
   and how many clusters the card runs at once) and of the bf16 fused-CE
   forward (with its launch at each split count), of every paged-decode
   kernel (register and general bodies) and of every nf4 kernel, and none
   of them may spill;
3. kernel: `paged_decode_attention` (the CUDA kernel) against
   `paged_decode_attention_reference` on the card at GPT-2-small shapes
   (ragged lengths up to 1024, block boundaries, a zero-length row and a
   sentinel-parked row), a GQA case, an int8 pool with scale planes, and the
   shapes the general body takes: head_dim 96 and 256, 3 and 6 query heads
   per kv head, beside an int8 pool at head_dim 128 with 4; one JSON line
   per case with its error, its times (SDPA over the gathered view as the
   library yardstick), its bound and the share of the bound it reaches;
4. fp32 slice: GPT-2 small at full width, seeded fp32 weights, TF32 off:
   the same greedy requests through the paged gather engine, through the
   slot-pool engine (the default) and through the paged fused engine, both
   at ``pipeline_depth`` 2 with ``tokens_per_sync`` 1 and 4 (each decode
   step one CUDA graph replay) give exactly the streams `generate` (over
   the slot cache, its decode step replayed from a graph of its own) gives
   for each request alone; the slot engine's
   graph holds no kernel; the paged kernel ran n_layer times per decode
   forward, counted through the replays, and a profiler window around one
   replay holds n_layer x tokens_per_sync paged-decode kernels;
5. bf16 slice: the same model in bf16 serves 48 seeded requests (greedy and
   sampled) through the fused engine at (depth, tokens_per_sync) (1, 1),
   (2, 1) and (2, 4): identical token streams, sampled ones included; the
   first decode step's logits agree with the gather path; one serving line
   each (tokens/s, TTFT and ITL p50/p99, the host's blocked time per fetch,
   decode replays, the kernel's launches through the replays, peak
   memory). Then the slot-pool engine at (2, 1) over the same requests: one
   serving line (``bf16_serving_slot``: no paged kernel launched, its
   streams beside the fused engine's). Then a torch.profiler window over the
   decode steps of an engine at each of the three, and of the slot engine:
   host and device ms per step and per decode iteration, the device's idle
   share, and the kernels that take the device time;
6. flash kernels: the forward, dQ and dK/dV kernels
   (`flash_attention_fwd`/`_dq`/`_dkv`) against their plain versions on the
   card at GPT-2-small training shapes (b 8, h 12, s 1024, d 64, bf16,
   causal), in fp32, non-causal, at d 128, at a ragged s 1000, at d 192
   and d 256 (4 and 3 heads, the scalar bodies) and at d 320 and d 384 (2
   heads, the run-time head_dim body that takes every head_dim above 256);
   each
   output held to FLASH_TOL and lse to LSE_ATOL; one JSON line per case and
   kernel with its error, its times, its bound, its achieved TFLOP/s and
   the share of the bound it reaches;
7. fp32 train-step parity: GPT-2 small at full width and depth, seeded fp32
   weights, TF32 off, batch 2 x 1024: one `make_train_step` step with
   ``attention_impl="flash"`` against one with ``"xla"`` (the plain path):
   loss and global gradient norm agree, and each flash kernel ran n_layer
   times;
8. bf16 training: GPT-2 small, batch 8 x 1024, ``mixed_precision="bf16"``,
   AdamW(lr 1e-4, weight decay 1e-4), bench.py's seeded batch repeated: 2
   warm-up steps and 10 timed steps; the loss falls and each flash kernel
   ran n_layer times per step; step ms, tokens/s, MFU by bench.py's FLOP
   count, peak memory. Then a torch.profiler window over 3 steps: host and
   device ms per step, the device's idle share, the top kernels, the
   device time by kind of kernel (fp32 head GEMMs, flash, bf16 GEMMs, ...)
   and by flash kernel (forward, dQ, dK/dV);
9. fused-CE kernels: the forward, dH and dW kernels (`fused_ce_fwd`/`_dh`/
   `_dw`) against their plain versions on the card at the fused loss's
   shapes (N 8192 = 8 x 1024 rows, V 50257, e 768, bf16, 1/16 of the rows
   ignored), in fp32, at a ragged N 1000, at e 1024 (GPT-2 medium's width),
   at Mistral-7B's untied head (N 8192, V 32000, e 4096) and with every row
   ignored; one JSON line per case and kernel with its error, its times (the
   library yardstick is the unfused PyTorch head and cross-entropy), its
   bound, its achieved TFLOP/s and the share of the bound it reaches; the
   bf16 forward's lines also give its plan (vocab splits, the cluster, ring
   stages);
10. fp32 fused-CE parity: GPT-2 small, fp32, TF32 off, batch 2 x 1024: one
   `make_train_step` step with `lm_loss_fn_pallas` against one with
   `lm_loss_fn`: loss and global gradient norm agree, and each fused-CE
   kernel ran once;
11. bf16 training with the fused loss: phase 8 with `lm_loss_fn_pallas`
   (bench.py's ``BENCH_FUSED_CE=2``): the loss falls, each flash kernel ran
   n_layer times and each fused-CE kernel once per step, and the peak
   memory stays below phase 8's; then its profiler window, which also splits
   the fused-CE kernels' device time into forward, dH and dW;
12. band flash kernels: the forward, dQ and dK/dV band kernels
   (`flash_band_fwd`/`_dq`/`_dkv`) against their plain versions on the card
   at the Mistral training shapes (b 1, 32 query heads over 8 kv heads,
   s 8192, d 128, window 4096, bf16; the plain versions one kv head's group
   at a time), at GPT-2 small's causal shapes through ``triangle_block``
   (beside the rectangular kernels' times on the same function), at a
   ragged fp32 s 1000 with window 100 and 4 query heads per kv head, at
   window 1, at a window past the sequence (held to the rectangular
   kernels' causal output too), and at d 192, d 256, d 320 and d 384 (16
   query heads over 4, s 8192, window 4096: the scalar bodies, and the
   run-time head_dim body above 256); each output held to FLASH_TOL, lse to
   LSE_ATOL, and at the Mistral shapes each output also to a bar
   scaled by its own size (BAND_MAIN_RMS_TOL); one JSON line per case and
   kernel with its error, its times (the library yardstick is SDPA over an
   explicit boolean band mask with ``enable_gqa``), its bound, its achieved
   TFLOP/s and the share of the bound it reaches;
13. fp32 Llama parity: a narrow Mistral shape (hidden 1024, 8 heads over 2
   kv heads, 2 layers, vocab 32000, batch 1 x 2048, window 512), fp32, TF32
   off: one `make_train_step(llama_loss_fn)` step with
   ``attention_impl="flash"`` against one with ``"xla"``: loss and global
   gradient norm agree, and each band kernel ran once per layer;
14. bf16 Mistral training, this slice's path: the Mistral-7B-width model
   (hidden 4096, 32 heads over 8 kv heads, intermediate 14336, vocab 32000,
   window 4096) cut to 4 layers, fp32 masters, ``mixed_precision="bf16"``,
   AdamW(lr 1e-4, weight decay 1e-4), one seeded 1 x 8192 batch repeated:
   2 warm-up and 10 timed steps; the loss falls, each band kernel ran 4
   times per step and the rectangular ones never; step ms, tokens/s, MFU,
   peak memory; then its profiler window;
15. nf4 kernel: `nf4_matmul` (the CUDA dequant-matmul) against
   `nf4_matmul_reference` on the card at the Llama-7B decode shapes of the
   reference's kernel bench (M 1 and 16, bf16), at GPT-2 small's four
   projections (M 16, a decode step, and M 512, a prefill), in fp32, with
   leading dims, and on a weight the kernel does not take (N 192: the
   dequantize route, no launch); each routed call is one launch (a
   profiler window around one call holds one runtime launch and no device
   kernel but the nf4 one); one JSON line per case with its error, its
   times, its bound, the share of the bound it reaches and the dense bf16
   cuBLAS product as a yardstick of another function;
16. fp32 quantized-serving parity: GPT-2 small at full width and depth,
   seeded fp32 weights, TF32 off, engines at depth 2: the nf4 engine's
   greedy streams equal a dense engine's over the dequantized copy of the
   same packed weights, with 4 x n_layer nf4 launches per forward (decode
   step, counted through the replays, or admission prefill) and as many nf4
   kernels in a profiler window around one replay; an int8-KV engine's
   fused streams equal its gather streams;
17. bf16 quantized serving: phase 5's 48 requests through the nf4 engine
   over an int8 KV pool, then through the int8-weights engine, at depth 2;
   one serving-metrics line each with `quant_stats()` and the memory held
   after load against the dense engine's; the plane-pack cache's bytes; a
   profiler window over 16 nf4 decode steps with the nf4 kernel's share;
   then KV bytes per token (fp32, bf16, int8) and the peak concurrent
   streams of an fp32 and an int8 pool of equal bytes over one trace;
18. fp32 Llama decode parity: Llama-2-7B's width (hidden 4096, 32 heads,
   intermediate 11008, vocab 32000) cut to 2 layers, 512 positions, seeded
   fp32 weights, TF32 off: `generate` over the slot cache gives the no-cache
   forward's argmax at every step and the eager step's tokens (batch 2, a
   64-token prompt, 16 tokens), and the nf4 model (its projections on the
   nf4 kernel, 7 launches a layer each forward, counted through the
   replays of `generate`'s graph, 7 a layer in a profiler window around one
   replay) gives the tokens of the dense model over its dequantized
   weights;
19. big-model inference, the reference tool's flow
   (``tools/bench_inference.py`` at its defaults): Llama-2-7B's width cut
   to ``BIG_MODEL_LAYERS`` (4) of its 32 layers, 512 positions, a synthetic fp16 safetensors
   checkpoint written to a temporary directory (removed after), a 64-token
   prompt and 20 new tokens through `generate` (a second call, its decode
   step replayed from the CUDA graph the first captured, its nf4 launches
   counted through the replays, and once more eagerly: equal tokens); one
   line per row, fp16 -> bf16, nf4, int8 and nf4 over an int8 KV cache,
   each built alone and freed before the next: ``load_s``, ``s_per_token``
   and ``s_per_token_eager``, the bytes bound of a token, ``packed_gb``,
   peak memory, the host and device ms of a replayed decode step (and the
   nf4 kernels in one replay: 7 a layer for nf4, none otherwise) and of an
   eager one; then an HF-named checkpoint (seeded non-zero fp16 weights at
   Llama-2-7B width, 2 layers, under Hugging Face's names and ``[out, in]``
   layout) loaded through `params_from_hf_llama` gives the weights and
   logits of the same values saved under the reference's names, bit for
   bit (`big_model_hf_checkpoint`);
20. prefix-cached serving: GPT-2 small, 16 slots, depth 2, buckets (32,
   128, 512), 48 requests of a shared seeded 384-token system prompt and a
   unique 16-96-token suffix, 64 new tokens, every second sampled, through
   the slot engine and the paged fused engine, each with the prefix cache
   off and on: at least 32 hits of 384 tokens each, the paged kernel's
   launches counted through the replays; in fp32 (TF32 off) the streams
   are equal with the cache on and off, sampled ones too
   (`fp32_prefix_serving`); in bf16 the same runs give tokens/s, TTFT with
   hits and misses apart, ITL, the admissions' host share of the wall, the
   tokens prefilled, the prefix counters and the streams equal to the
   cache-off run's, with the position and top-2 margin where any part
   (`bf16_prefix_serving`); then the bf16 nf4 engine with the cache on
   (`bf16_prefix_serving_nf4`: the nf4 and paged kernels both launched);
21. speculative serving: the same model, 32 greedy requests whose prompts
   repeat a seeded 32-token pattern, 64 new tokens, ``speculation=4`` (the
   n-gram drafter) against off, in the slot and paged fused engines: in
   fp32 (TF32 off) the streams are equal and the verify step replays from
   its graph (`float32_spec_serving`); in bf16 the same runs report
   tokens/s, ITL, accepted tokens per forward and the streams equal to
   spec-off's, with where any part (`bfloat16_spec_serving`), and a profiler window over each
   spec engine (`bf16_spec_decode_profile`);
22. the Llama fused loss: one fp32 step (TF32 off) of the Mistral-7B-width
   model at 2 layers, batch 1 x 2048, `llama_loss_fn_fused` against
   `llama_loss_fn` (`fp32_llama_fused_ce_parity`: loss and gradient norm
   agree, each fused-CE kernel ran once); then phase 14's bf16 run with
   `llama_loss_fn_fused` (`bf16_train_mistral_fused_ce` and its profile:
   the fused-CE forward, dH and dW at e 4096 against phase 14's fp32 head
   GEMMs) and `mistral_loss_comparison`;
23. crash-exact serving, GPT-2 small at full width and depth, 16 slots,
   depth 2, phase 5's 48 requests, in the paged fused engine (kernel #1)
   and the slot engine, every decode step a graph replay; in fp32 (TF32
   off): (a) a child process serving them with a journal in both engines
   is killed with SIGKILL mid-run and fresh engines resume from the
   journals (`fp32_reliability_sigkill`), (b) an in-process snapshot is
   restored in a fresh engine (`fp32_reliability_snapshot`): completed plus
   resumed streams equal an uninterrupted run's, token for token, sampled
   ones too; (c) a `FaultInjector` poisons one request once (its stream is
   equal) and another twice (``error``; the other 46 streams equal,
   `fp32_reliability_poison`); (d) deadline expiry and drain
   (`fp32_reliability_deadline_drain`). Then bf16, phase 5's fused engine
   at (2, 1): tokens/s, TTFT and ITL with the journal off, fsync
   ``never`` and fsync ``accept``, in turns (off, never, accept, accept,
   never, off), and the journal's share of the wall
   (`bf16_reliability_journal`, `bf16_reliability_journal_summary`); a
   profiler window over the journaled
   engine's decode steps beside phase 5's (2, 1) window, with the health
   flag's kernels alone at the decode shape
   (`bf16_reliability_decode_profile`);
24. observable, self-healing serving, GPT-2 small at full width and depth,
   16 slots, depth 2, phase 5's 48 requests, in the paged fused engine
   (kernel #1) and the slot engine; in fp32 (TF32 off): (a) a traced
   engine's streams equal an untraced one's, its trace validates with
   nothing dropped, every request runs from submit to one terminal event,
   dispatches and fetches pair by seq, and the exported file reloads
   (`fp32_observability_trace`); (b) `EngineSupervisor` with a journal
   under one `FaultInjector` (a hang past the stall timeout, a device
   error, a poison storm) restarts with ``stall``, ``device_error`` and
   ``nan_storm``, the streams equal the uninterrupted run's, the first
   step is no stall, with each restart's seconds and the allocated memory
   after the restarts (`fp32_observability_supervisor`); a spent budget
   rejects every request with ``unhealthy`` and `step` raises
   (`fp32_observability_unhealthy`). Then bf16, the fused engine at
   (2, 1): (c) a brownout over three waves of priorities 0-3, level,
   sheds and clamps a step (`bf16_observability_brownout`); (d) the hooks'
   costs in turns, off, traced, traced + telemetry + anomaly
   (`bf16_observability_cost` and its summary), and a profiler window with
   ``annotate=True`` whose ``step`` ranges enclose the decode graph's
   launches (`bf16_observability_profile`);
25. the training loop through the `Accelerator` facade: (a) the port's
   `examples/nlp_example.py` at BERT-base width (hidden 768, 12 layers,
   vocab 30522, length 64, batch 16), 3 epochs in bf16 and in fp16, each
   with ``--gradient_accumulation_steps 2 --with_tracking --checkpointing``:
   each epoch's loss and accuracy, samples/s, the device ms of one step,
   peak memory, the tracker's lines, the checkpoint's bytes and its save
   and load seconds; ``load_state`` must restore the saved eval logits bit
   for bit (`bf16_nlp_example`, `fp16_nlp_example` and their profiles);
   (b) GPT-2 small, flash attention, 8 x 1024, bf16, accumulation 4,
   clipping at 1.0, `lm_loss_fn_pallas`, through a `DataLoaderShard`
   (``prefetch="auto"``) and an `AcceleratedScheduler`: the imperative loop
   and ``make_train_step`` give equal losses over 8 microbatches, the loop
   launches each flash kernel 12 times and each fused-CE kernel once a
   microbatch, and a run saved after 4 microbatches and loaded into a fresh
   `Accelerator` gives the last 4 losses of the run that never stopped
   (`bf16_facade_gpt2`: both forms' tokens/s);
26. the serving fleet and its front door, GPT-2 small at full width and
   depth, every replica a supervised paged fused engine (kernel #1) at
   depth 2 with 16 slots and the prefix cache, all over one model; fp32
   (TF32 off), phase 5's 48 requests: (a) a 2-replica `ServingCluster`
   under ``prefix`` and ``round_robin`` gives a lone engine's streams
   (`fp32_cluster_parity`: placements, router stats, kernel #1's launches
   per replica); (b) a `FaultInjector` device error kills replica 0 with
   its restart budget spent, its backlog migrates off the journal,
   `replace_replica` spawns a successor, and the replica the streams moved
   to is killed too: no request lost, no emitted token decoded twice,
   streams equal (`fp32_cluster_migration`); (c) a `ServingFrontend` over
   a journaled 2-replica cluster of `FairScheduler` engines, two tenants,
   two classes, every request streamed and replica 0 killed mid-stream:
   each stream's events concatenate to its output
   (`fp32_frontend_streams`, stream lag p50/p99). bf16: (d) the reference
   benchmark's 5-tenant shared-prefix trace (256-token prefix), 1 replica,
   then 2 under ``prefix`` and ``round_robin``: tokens/s, TTFT, trie hit
   rate and peak memory, and in the 2-replica ``prefix`` run the device's
   idle share, reported only (`bf16_cluster_routing`); (e) a surge then
   idle under
   `FleetAutoscaler(min_replicas=1, max_replicas=3)`, a spawn while
   replica 0 has dispatches in flight, the scale events in order, then three
   spawn-and-retire cycles that must leave ``memory_allocated()`` within
   1 MiB (`bf16_autoscale`);
27. the host-RAM KV tier behind the paged pool, GPT-2 small at full width
   and depth, paged fused engines at depth 2 with the prefix cache over a
   pool of about half the admitted requests' decode extents: fp32 (TF32
   off), 16 requests sharing a 64-token prefix, 16 slots, ``wake_policy``
   ``"upload"`` and ``"prefill"``, then the trie spilled and 4 prompts
   served again: streams equal tier-off's and a lone `generate`'s, page
   outs, page ins, hibernations and wakes all above 0, allocated memory
   back to the byte after the drain and after `_release_device`
   (`fp32_kv_tier_parity`); bf16 weights over an int8 pool, phase 5's 48
   requests, 16 slots, tier off and each wake policy: page-out and page-in
   bytes/s beside the PCIe peak, wake latency by path, what ``"auto"``
   chose, peak admitted streams against the pool alone's, tokens/s
   (`bf16_kv_tier`, reported); the five port tools exit 0 on the upload
   run's trace, telemetry and journal (`kv_tier_tools`);
28. ResNet-50 image classification and the rest of the one-process
   facade (TF32 off throughout, as in every phase): (a) the port's
   `examples/cv_example.py` at the reference's defaults (224 x 224, 1000
   classes, batch 16, 3 epochs of 8 batches, SGD momentum 0.9 at lr 0.02)
   in bf16 and in ``"no"`` with fp32 convolutions: each epoch's loss and
   accuracy, images/s, peak memory, and a profiler window over 3 steps
   with host against device ms, the idle share and device ms by kind
   (convolutions, GroupNorm, layout copies, casts, elementwise, SGD), then
   10 timed bf16 steps at batch 128 (images/s, MFU) and a probe of
   `F.group_norm` on a channels_last input (`bf16_cv_example`,
   `no_cv_example`, `bf16_resnet50_b128`, `group_norm_layout_probe`); (b)
   one fp32 ResNet-50 step on the card equals the CPU's from the same
   weights and batch (`fp32_resnet50_card_vs_cpu`); (c)
   `examples/complete_cv_example.py` with ``--checkpointing
   --with_tracking``, resumed from ``epoch_0``, retraces the unbroken run's
   later losses bit for bit, cuDNN held deterministic
   (`complete_cv_example_resume`: checkpoint bytes, save and load
   seconds); (d) `find_executable_batch_size` from 4096 images recovers
   from the card's real out-of-memory errors and leaves allocated memory
   within 1 MiB (`bf16_resnet50_find_executable_batch_size`); (e) the
   by_feature examples on the card at their own defaults, the
   sliding-window Llama's band launches counted and the profiler's trace
   naming CUDA kernels, and a ResNet-50 child stopped by SIGTERM through
   `install_preemption_handler`, whose checkpoint loads to its weights
   (`by_feature_examples`, `vision_facade_phase_s`);
29. precision on one card, at GPT-2 small and bench.py's shape (batch 8 x
   1024, flash attention, the fused loss): (a) five training variants, each
   7 steps (2 untimed) from one seed over two fixed batches in turn, with
   step ms, tokens/s, MFU against the bf16 dense rate (the fp8 runs also
   against the fp8 rate), peak memory, optimizer state bytes and launches:
   bf16; ``BENCH_FP8=model`` (`DelayedScalingRecipe(backend="native")`
   under ``mixed_precision="fp8"``); ``BENCH_FP8=all`` (also
   ``adamw_fp8(1e-4, opt_level="O2")``); the same with ``remat_policy=
   "dots"``; fp16 with loss scaling on the fp16 instances of kernels #2-#4
   and #8-#10 (`precision_train`); (b) the fp8 curves within
   ``FP8_LOSS_TOL`` of bf16's at every step and falling, O2 with remat
   against without within ``REMAT_LOSS_ATOL``, beside a repeat of the O2
   run (`fp8_loss_parity`); (c) the
   fp8 GEMM (``torch._scaled_mm``) at the four projection shapes, M 8192:
   error against the fp32 product of the dequantized operands, ms, bf16
   ``F.linear``'s ms, bound (`fp8_gemm`); a profiler window over 3 steps of
   the bf16, fp8 model, remat and fp16 variants (`precision_train_*_profile`:
   host against device ms, device ms by kind); (d) the fp16 instances against
   their plain versions at phase 6's and phase 9's main shapes, with SDPA
   and the unfused head as the library yardsticks (`precision_phase_s`);
30. big models on one card: first the flash kernels #2-#4 (bf16, b 1,
   32 heads, s 4096, d 128, causal) and the fused-CE kernels #8-#10 (bf16,
   N 4096, e 4096, V 32000) against their plain versions at the Mixtral
   train step's shapes; (a) fp32 (TF32 off) Llama-2-7B width and
   Mixtral-8x7B width at 2 layers through their blockwise decompositions,
   embed on the device, layer_0 in pinned host memory, layer_1 on disk,
   the head on the device, give the resident model's logits on a 1 x 512
   prompt in two calls (`fp32_blockwise_parity_*`, max |err| <=
   BIG_MODEL_ATOL, expected 0); (b) bf16 Mixtral-8x7B at full width and 4
   layers, a seeded 12.1 GB checkpoint in a temporary directory, loaded by
   ``load_checkpoint_and_dispatch(device_map="auto", max_memory={"device":
   4 GiB, "cpu": 6 GiB})``: the map uses all three tiers, the logits equal
   the resident model's bit for bit, the peak memory stays within its
   bound; bytes, seconds and GB/s per tier beside PCIe 5.0 x16, the copy
   time hidden under compute, peak memory (`bf16_big_mixtral_streaming`);
   `cpu_offload_with_hook` over two such models
   (`bf16_big_mixtral_offload_with_hook`); the 32-layer model's bytes and
   predicted seconds per forward (`big_mixtral_full_model_prediction`:
   exposed copy time plus compute);
   (c) one fp32 step of Mixtral-8x7B width at 1 layer, flash against plain
   attention and the fused loss against the plain one, aux included
   (`fp32_mixtral_train_parity`), then 12 bf16 steps at 2 layers,
   batch 1 x 4096, `mixtral_loss_fn_fused`: the loss falls, 2 launches of
   each flash kernel and 1 of each fused-CE kernel a step, step ms,
   tokens/s, MFU on active and on executed FLOPs, peak memory
   (`bf16_train_mixtral`), and its device ms by kind
   (`bf16_train_mixtral_profile`: expert GEMMs, dispatch/combine einsums,
   flash, fused CE, the rest); `big_models_phase_s`;
31. T5-v1.1-base and ViT-B/16: (a) the fused-CE kernels #8-#10 against
   their plain versions at T5-v1.1-base's head (bf16, N 2048 = 16 x 128
   target rows, e 768, V 32128, every sixteenth label ignored), with the
   unfused head as the library yardstick; (b) one fp32 step (TF32 off) of
   T5-v1.1-base's width at 2 + 2 layers, batch 2, source 512, target 128,
   padded labels, `seq2seq_loss_fn_fused` against `seq2seq_loss_fn`, untied
   and tied: loss and gradient norm within phase 10's bars, each fused-CE
   kernel once (`fp32_t5_fused_ce_parity_*`); (c) T5-v1.1-base uncut (12 +
   12 layers), batch 16 x (512 + 128), bf16, AdamW,
   ``make_train_step(seq2seq_loss_fn_fused)``: 2 warm-up and 10 timed
   steps, the loss falls, one launch of each fused-CE kernel a step; step
   ms, source and target tokens/s, MFU by `t5_train_flops`, peak memory
   (`bf16_train_t5_base`) and a profiler window by kind: GEMMs, plain
   attention, norms, fused CE, AdamW, copies and casts
   (`bf16_train_t5_base_profile`); (d) ViT-B/16 at 224 and 1000 labels:
   one fp32 forward of 4 images on the card against the CPU's from the same
   weights (`fp32_vit_b16_card_vs_cpu`), then 10 timed bf16 AdamW steps at
   batch 128 (`bf16_vit_b16_b128`: images/s, MFU, peak memory); (e) the
   port's `examples/inference/distributed/image_classification.py` and
   `batch_text_generation.py` at their defaults, exit 0 with 10
   predictions and 5 generated rows (`inference_examples`); `t5_vit_phase_s`;
32. data-parallel training across processes through ``python -m
   accelerate_tpu_torch.commands.launch``: (a) one NCCL rank runs phase
   29's bf16 variant (GPT-2 small, 8 x 1024, flash, `lm_loss_fn_pallas`, 2
   untimed and 10 timed steps): backend, world, step ms beside phase 29's,
   tokens/s, the launches of #2-#4 and #8-#10 (`data_parallel_nccl_world1`);
   (b) two ranks sharing the card over gloo (CUDA tensors staged through
   host memory), GPT-2 small fp32 (TF32 off), one global batch 8 x 512 split
   4 + 4: 3 AdamW steps plainly and with the bf16 hook against one process
   on the whole batch within `DP_LOSS_RTOL` / `DP_BF16_LOSS_RTOL` and their
   parameter bars, 6 with PowerSGD (rank 1, warm-up 2) whose loss falls;
   the ranks bit for bit equal; all-reduce bytes, ms and calls a step beside
   the step ms (`data_parallel_gloo_{plain,bf16,power_sgd}`); (c) the
   reference's multi-process collective checks on CUDA tensors at 2 ranks
   (`data_parallel_collectives`) and `examples/by_feature/
   multi_process_metrics.py` at 2 ranks, its 151 eval samples counted once
   (`data_parallel_multi_process_metrics`); `data_parallel_phase_s`;
33. the script's seconds (`chip_smoke_s`, the build included), the
   kernels line (its flash and fused-CE launches add phase 25 (b)'s
   loop, phase 29's variants, phase 30's runs, phase 31's T5 steps and
   phase 32 (a)'s rank to phases 8 and 11; kernel #1's add phases 26's
   replicas and 27's engines to phases 5 and 24; the band kernels' add
   phase 28 (e)'s sliding-window example to phase 14), the card line, and
   the final ``{"ok": true, ...}`` line.

Every phase ends with a ``*_phase_s`` line of its seconds (phases 1-22
through `phase_done`).

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUCKETS = (64, 128, 256, 512, 768)
# stated tolerances of the kernel against its plain version, by query dtype:
# fp32 differs only in summation order; bf16/fp16 outputs are rounded once by
# the kernel but twice (softmax weights, then the product) by the plain path
KERNEL_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
# first decode step of GPT-2 small in bf16, fused vs gather logits: both run
# the same bf16 model and differ only in the attention rounding above
BF16_LOGIT_ATOL = 0.1
# flash kernels against their plain versions, |err| <= atol + rtol * |ref|:
# fp32 differs in summation order over up to 1024 terms; bf16 rounds p and dS
# to bf16 before products (a value near a rounding boundary may round the
# other way) and rounds each output once more; fp16 (the scalar bodies) the
# same at fp16's 11 bits, so bf16's bar over 4
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2), "float16": (5e-3, 5e-3)}
# the forward kernels' lse, rect and band, every dtype: |err| <= LSE_ATOL
# (both sides sum the same fp32 scores in another order, the bf16 kernel in
# base 2 with the hardware's ex2; the backward kernels recompute p from this
# lse, so FLASH_TOL's 2e-2 would be far too loose for it). At the Mistral
# shape FLASH_TOL's atol is about a typical value of o, dq and dk in the
# rows that attend thousands of keys (|o| ~ 0.02 at W 4096), so there each
# output is also held to rtol |plain| + BAND_MAIN_RMS_TOL rms(plain), rtol
# FLASH_TOL's: set at about 2.5x the largest reading (0.0213 for o, 0.0052
# for dq and dk/dv, seed 0), where bf16 rounding of p and dS at other
# running maxima leaves a small excess on elements that cancel. Not for
# window 1: there dq and dk are 0 up to rounding and have no size to scale by
LSE_ATOL = 1e-4
BAND_MAIN_RMS_TOL = {"flash_band_fwd": 0.05, "flash_band_dq": 0.015, "flash_band_dkv": 0.015}
# fp32 GPT-2 small, one train step, flash vs plain attention: the same fp32
# arithmetic in another summation order, through 12 layers and the head
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
# fused-CE kernels against their plain versions: both take the same fp32
# logits from the same operands in another summation order. lse and ll (fp32
# rows): |err| <= 1e-4 + 1e-5 |plain|. dH and dW: |err| <= rtol |plain| +
# atol max|plain|; fp32 differs in order only; bf16 rounds dlogits to bf16
# before the products (a value near a rounding boundary may round the other
# way) and each output once more (2^-8 relative); fp16 the same at 2^-11,
# bf16's bar over 4
FUSED_CE_ROW_TOL = (1e-4, 1e-5)
FUSED_CE_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3), "float16": (2.5e-3, 2.5e-4)}
# device kernels of the bf16 train steps by kind, first match wins, case
# ignored. The only fp32 products of those steps are the heads' (logits,
# d hidden, d head weight); casts run as copy kernels, so they match before
# the other elementwise kernels (GELU, residual adds, masks, AdamW's
# scalars); SiLU (the Llama steps) before all elementwise. PyTorch runs
# `F.rms_norm` (the Llama steps) through its layer-norm kernels, so one
# category holds both norms.
TRAIN_KERNEL_CATEGORIES = (
    ("band flash kernels", r"flash_band_(fwd|dq|dkv)_kernel"),
    ("fp8 GEMMs", r"e4m3|e5m2|f8f8|fp8"),
    ("fused-CE kernels", r"fused_ce_(fwd|bwd)_kernel"),
    ("fp32 head GEMMs", r"f32f32|sgemm"),
    ("flash kernels", r"flash_(fwd|dq|dkv)_kernel"),
    ("bf16 GEMMs", r"nvjet|bf16bf16|gemm.*bf16|bf16.*gemm"),
    ("AdamW", r"multi_tensor_apply"),
    ("LayerNorm and RMSNorm", r"layer_norm|rms_norm"),
    ("SiLU", r"silu"),
    ("softmax and cross-entropy", r"softmax|nll_loss|gather"),
    ("copies and casts", r"copy"),
    ("other elementwise and reductions", r"elementwise|reduce"),
)
FLASH_REPLACES = {
    "flash_attention_fwd": "accelerate_tpu/ops/flash_attention.py:50",
    "flash_attention_dq": "accelerate_tpu/ops/flash_attention.py:130",
    "flash_attention_dkv": "accelerate_tpu/ops/flash_attention.py:165",
}
BAND_REPLACES = {
    "flash_band_fwd": "accelerate_tpu/ops/flash_attention.py:340",
    "flash_band_dq": "accelerate_tpu/ops/flash_attention.py:372",
    "flash_band_dkv": "accelerate_tpu/ops/flash_attention.py:399",
}
FUSED_CE_REPLACES = {
    "fused_ce_fwd": "accelerate_tpu/ops/fused_ce.py:47",
    "fused_ce_dh": "accelerate_tpu/ops/fused_ce.py:79",
    "fused_ce_dw": "accelerate_tpu/ops/fused_ce.py:103",
}
NF4_REPLACES = "accelerate_tpu/ops/nf4_matmul.py:43"
# phase 29's training variants at bench.py's shape (BENCH_FP8, BENCH_REMAT):
# (name, mixed_precision, config keywords, O2 optimizer); "fp8" computes in
# bf16 around the fp8 projections, as BENCH_FP8's bf16 accelerator does
PRECISION_RUNS = (
    ("bf16", "bf16", {}, False),
    ("fp8_model", "fp8", {"fp8": True}, False),
    ("fp8_all", "fp8", {"fp8": True}, True),
    ("fp8_all_remat_dots", "fp8", {"fp8": True, "remat": True, "remat_policy": "dots"}, True),
    ("fp16", "fp16", {}, False),
)
# the variants whose steps a profiler window splits into host and device
# time by kind of kernel (after the timed steps)
PRECISION_PROFILED = ("bf16", "fp8_model", "fp8_all_remat_dots", "fp16")
# fp8 against bf16, every step of 12 from one seed: the reference's
# loss-parity bar (benchmarks/fp8/loss_parity.py, loss units)
FP8_LOSS_TOL = 0.15
# fp8 O2 with and without remat "dots", 7 steps: the recompute runs on the
# forward's compute-dtype weights and replays its fp8 scales, so the two
# runs do the same arithmetic and are expected equal; the bar allows a
# last-bit difference that fp8 rounding flips would amplify. The phase also
# repeats the O2 run without remat, to show the run-to-run noise beside it
REMAT_LOSS_ATOL = 1e-3
# the fp8 GEMM against the fp32 product of its dequantized operands: the
# tensor cores' fp8 products accumulate at reduced precision between
# promotions to fp32, and the bf16 output rounds once (2^-8 relative)
FP8_GEMM_RTOL = 2 ** -7 + 1e-3
# nf4 kernel against its plain version, |err| <= atol + rtol |plain|: both sum
# the same fp32 products of the same dequantized weights, in another order
# (split-K and warp partials against one fp32 GEMM); a bf16 output is then
# rounded once (2^-8 relative), a sum near a rounding boundary possibly the
# other way
NF4_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# the Llama-7B decode shapes of the reference's kernel bench
# (tools/bench_nf4_kernel.py:30), and GPT-2 small's projections (qkv, proj,
# up, down), all [in, out]
LLAMA_NF4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
GPT2_NF4_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log: str, pattern: str):
    """(the regex match, ptxas's resources) of each kernel whose mangled
    name matches ``pattern`` in a build log: registers at entry, spill
    bytes and static shared memory (the sm_90a kernels' tiles are dynamic
    shared memory, set at launch)."""
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(pattern, block.split("'", 1)[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        yield m, {"registers": int(regs.group(1)) if regs else None,
                  "spill_store_bytes": int(spill.group(1)) if spill else None,
                  "spill_load_bytes": int(spill.group(2)) if spill else None,
                  "static_smem_bytes": int(smem.group(1)) if smem else 0}


def kernel_resources(log: str, pattern: str, fields: tuple[str, ...]) -> list[dict]:
    """`ptxas_entries` of each kernel whose name matches the regex
    ``pattern`` (no capturing groups): its name, its element type
    (``dtype``) and each further template argument, an int or a bool, under
    the next name of ``fields`` (fewer arguments, fewer keys)."""
    out = []
    mangled = rf"({pattern})I(13__nv_bfloat16|6__half|f)((?:L[bi]\d+E)*?(?:L[bi]\d+)?)EEEv"
    for m, res in ptxas_entries(log, mangled):
        values = [bool(int(x)) if kind == "b" else int(x)
                  for kind, x in re.findall(r"L([bi])(\d+)", m.group(3))]
        out.append({"kernel": m.group(1), "dtype": _MANGLED_DTYPES[m.group(2)],
                    **dict(zip(fields, values)), **res})
    return out


_MANGLED_DTYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "6__half": "float16"}
# any kernel of the four libraries, and its first template type
_KERNEL_NAME = (r"((?:flash_(?:band_)?(?:fwd|dq|dkv)|fused_ce_(?:fwd|bwd)|paged_decode|nf4_matmul)"
                r"_kernel)I(f|13__nv_bfloat16|6__half)")


def fp16_resources(log: str) -> list[dict]:
    """`kernel_resources` of every fp16 instance of the flash and fused-CE
    kernels (the scalar bodies), which the build phase holds to zero
    spills."""
    pattern = r"(flash_(?:band_)?(?:fwd|dq|dkv)_kernel|fused_ce_(?:fwd|bwd)_kernel)I6__half"
    return entry_resources(log, pattern, ("kernel",))


# the flash kernels' template arguments after the type (d 0: the run-time
# head_dim body, every head_dim above 256)
FLASH_FIELDS = ("d", "causal")


def forward_resources(log: str) -> list[dict]:
    """`kernel_resources` of the flash forward kernels (``flash_fwd_kernel``
    and ``flash_band_fwd_kernel``)."""
    return kernel_resources(log, r"flash_(?:band_)?fwd_kernel", FLASH_FIELDS)


def dq_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 dQ kernels (``flash_dq_kernel``,
    ``flash_band_dq_kernel``), the ones built on wgmma and TMA."""
    return [k for k in kernel_resources(log, r"flash_(?:band_)?dq_kernel", FLASH_FIELDS)
            if k["dtype"] == "bfloat16"]


def dkv_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 dK/dV kernels (``flash_dkv_kernel``,
    ``flash_band_dkv_kernel``), the ones built on wgmma and TMA."""
    return [k for k in kernel_resources(log, r"flash_(?:band_)?dkv_kernel", FLASH_FIELDS)
            if k["dtype"] == "bfloat16"]


def fused_ce_bwd_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 fused-CE dH and dW kernels
    (``fused_ce_bwd_kernel<bf16, DW, NH>``: ``dw`` and the output chunks a
    warpgroup holds), the ones built on wgmma, TMA and clusters."""
    return [k for k in kernel_resources(log, r"fused_ce_bwd_kernel", ("dw", "chunks_per_warpgroup"))
            if k["dtype"] == "bfloat16"]


def fused_ce_fwd_resources(log: str) -> list[dict]:
    """`kernel_resources` of the bf16 fused-CE forward kernel
    (``fused_ce_fwd_kernel<bf16, BN>``: ``vocab_tile`` BN), the one built on
    wgmma, TMA and a cluster split of the vocab."""
    return [k for k in kernel_resources(log, r"fused_ce_fwd_kernel", ("vocab_tile",))
            if k["dtype"] == "bfloat16"]


def entry_resources(log: str, pattern: str, fields: tuple[str, ...]) -> list[dict]:
    """`ptxas_entries` of each kernel whose mangled name matches the regex
    ``pattern``, whose groups name the kernel's template arguments under
    ``fields`` (a type as its mangled name, a number as an int)."""
    return [{**{k: int(v) if v.isdigit() else v for k, v in zip(fields, m.groups())}, **res}
            for m, res in ptxas_entries(log, pattern)]


_MANGLED_TYPES = r"(f|13__nv_bfloat16|6__half)"


def paged_decode_resources(log: str) -> list[dict]:
    """`entry_resources` of the paged-decode kernels
    (``paged_decode_kernel<TQ, TKV, QUANT, D, G, PB>``: D and G 0 for the
    general body; pool ``S1_`` is q's type, ``a`` int8)."""
    pattern = rf"paged_decode_kernelI{_MANGLED_TYPES}(f|S1_|a)Lb([01])ELi(\d+)ELi(\d+)ELi(\d+)E"
    return entry_resources(log, pattern, ("q", "pool", "quant", "d", "groups", "piece_bytes"))


def nf4_resources(log: str) -> list[dict]:
    """`entry_resources` of the nf4 kernels (``nf4_matmul_kernel<T, ROWS>``)."""
    return entry_resources(log, rf"nf4_matmul_kernelI{_MANGLED_TYPES}Li(\d+)E", ("dtype", "rows"))


def device_work(torch, fn) -> tuple[int, list[str]]:
    """What one call of ``fn`` puts on the device, from a torch.profiler
    window around it: (the runtime calls that launch a kernel, set or copy
    memory, the device kernels by name, one per launch). The call sits
    between two spin kernels of PyTorch's own of about a millisecond each,
    left out of both: the profiler can drop device kernels near a short
    window's edges (and then the runtime calls still count them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        fn()
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    events = prof.events()
    calls = sum(ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy")) for ev in events)
    kernels = [ev.name for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation
               and "spin_kernel" not in ev.name]
    return calls - 2, kernels


def peak_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 non-tensor-core flop/s, label) from the SKU in the
    device name, NVIDIA data sheet figures at full power."""
    if "H200" in name:
        return 4.8e12, 67e12, "H200 SXM: 4.8 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16 dense"
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe: 2.0 TB/s, 51 TFLOP/s fp32, 756 TFLOP/s bf16 dense"
    if "NVL" in name:
        return 3.9e12, 60e12, "H100 NVL: 3.9 TB/s, 60 TFLOP/s fp32, 835 TFLOP/s bf16 dense"
    return 3.35e12, 67e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16 dense"


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core flop/s of the SKU in the device name (NVIDIA
    data sheets, full power)."""
    if "PCIe" in name:
        return 756e12
    if "NVL" in name:
        return 835e12
    return 989e12


def fp8_peak(name: str) -> float:
    """Dense fp8 tensor-core flop/s of the SKU in the device name (NVIDIA
    data sheets, full power)."""
    if "PCIe" in name:
        return 1513e12
    if "NVL" in name:
        return 1671e12
    return 1979e12


def timed_steps(torch, step, data, warmup: int, steps: int) -> tuple[list[float], float]:
    """``warmup`` train steps, then ``steps`` timed ones with the launch
    counts set to 0 and the peak-memory counter reset just before them:
    (the loss of every step, the timed steps' host wall in s, ending in a
    synchronize). Earlier phases' objects that sit in reference cycles (a
    serving engine and its KV pool) are collected first, so the peak counts
    what the training holds."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    losses = [step(data).item() for _ in range(warmup)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    timed = [step(data) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return losses + [t.item() for t in timed], wall


def device_ms(torch, fn, flush, samples: int = 30) -> float:
    """Median device time of ``fn`` in ms over ``samples`` runs, CUDA events
    around each. L2 is flushed before each run (as a decode step finds the
    pool cold) and the stream is held busy meanwhile, so the events time the
    device work and not the host's launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_case(torch, name, *, b, hq, kvh, d, bt, lengths, dtype, quant, seed, flush,
                parked=()):
    """One kernel-vs-plain comparison and its timings; returns the case record."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.flash_attention import (
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    span = 1024
    bps = span // bt
    num_blocks = b * bps + 8
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
    shape = (num_blocks, bt, kvh, d)
    scales = {}
    if quant:
        k_pool = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        v_pool = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        scales = dict(
            k_scale_pool=torch.rand(shape[:3], generator=g, device=dev) * 0.02 + 1e-3,
            v_scale_pool=torch.rand(shape[:3], generator=g, device=dev) * 0.02 + 1e-3)
    else:
        k_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
        v_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
    tables = torch.randperm(num_blocks, generator=g, device=dev)[: b * bps].reshape(b, bps)
    tables = tables.to(torch.int32)
    for i, n in enumerate(lengths):  # unreserved entries hold the sentinel, as in the engine
        tables[i, -(-max(n, 0) // bt):] = num_blocks
    for i in parked:
        tables[i] = num_blocks
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, tables, lens)

    out = paged_decode_attention(*args, **scales)
    ref = paged_decode_attention_reference(*args, **scales)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = KERNEL_ATOL[str(dtype).removeprefix("torch.")]
    if not (math.isfinite(err) and err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"kernel case {name}: max_abs_err {err} > atol {tol}")

    # yardstick: one library call of the same function over the gathered view
    n_live = [min(max(n, 0), span) for n in lengths]
    kg = ref_view(torch, k_pool, tables, scales.get("k_scale_pool"), dtype, num_blocks)
    vg = ref_view(torch, v_pool, tables, scales.get("v_scale_pool"), dtype, num_blocks)
    if hq != kvh:
        kg, vg = kg.repeat_interleave(hq // kvh, dim=1), vg.repeat_interleave(hq // kvh, dim=1)
    mask = (torch.arange(span, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    kernel_ms = device_ms(torch, lambda: paged_decode_attention(*args, **scales), flush)
    plain_ms = device_ms(torch, lambda: paged_decode_attention_reference(*args, **scales), flush)
    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask),
                           flush)

    # least time for the same work: every live K/V byte (and scale) read once,
    # q, tables, lengths read once, the output written once; flops of QK^T and PV
    bw, flops_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    elt = k_pool.element_size()
    kv_bytes = sum(n_live) * kvh * d * elt * 2
    scale_bytes = sum(n_live) * kvh * 4 * 2 if quant else 0
    table_bytes = sum(-(-n // bt) for n in n_live) * 4 + lens.numel() * 4
    io_bytes = q.numel() * q.element_size() * 2
    n_bytes = kv_bytes + scale_bytes + table_bytes + io_bytes
    n_flops = 4 * sum(n_live) * hq * d
    bound_ms = max(n_bytes / bw, n_flops / flops_peak) * 1e3
    rec = dict(case=name, b=b, hq=hq, kvh=kvh, d=d, bt=bt, pool=str(k_pool.dtype).removeprefix("torch."),
               q=str(dtype).removeprefix("torch."), max_abs_err=err, atol=tol, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_share=bound_ms / kernel_ms,
               bound_by="bytes" if n_bytes / bw >= n_flops / flops_peak else "operations",
               bytes=n_bytes, flops=n_flops)
    print(json.dumps(rec), flush=True)
    return rec


def ref_view(torch, pool, tables, scale, dtype, num_blocks):
    """The gathered ``[b, kv_heads, span, d]`` view (dequantized for int8)."""
    b, bps = tables.shape
    t = tables.long().clamp(max=num_blocks - 1)
    view = pool[t].reshape(b, bps * pool.shape[1], *pool.shape[2:])
    if scale is not None:
        sv = scale[t].reshape(b, bps * pool.shape[1], pool.shape[2])
        view = (view.float() * sv[..., None]).to(dtype)
    return view.transpose(1, 2).contiguous()


def first_step_logits(torch, model, prompts, attention):
    """Prefill ``prompts`` one by one into a fresh paged cache, then run one
    batched decode step with ``attention`` ("fused" or "gather"); returns the
    step's logits ``[b, vocab]``."""
    from accelerate_tpu_torch.models.kv_cache import make_block_pool, scatter_rows_to_blocks

    cfg, dev, bt = model.config, model.device, 16
    b, bps = len(prompts), cfg.n_positions // bt
    cache = make_block_pool(cfg.n_layer, b, b * bps, bt, cfg.n_head, cfg.head_dim, cfg.dtype,
                            dev, attention=attention)
    tables = torch.arange(b * bps, dtype=torch.int32, device=dev).reshape(b, bps)
    first = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            kv: list = []
            logits = model(torch.tensor([p], device=dev), kv_out=kv)
            scatter_rows_to_blocks(cache, kv, torch.tensor([i], device=dev),
                                   tables[i:i + 1, : -(-len(p) // bt)],
                                   torch.tensor([len(p)], dtype=torch.int32, device=dev))
            first.append(logits[0, -1].argmax())
        pos = torch.tensor([len(p) for p in prompts], device=dev)
        return model(torch.stack(first)[:, None], pos, cache=cache, block_tables=tables)[:, -1]


def profile_steps(torch, run_step, steps: int) -> tuple[float, dict[str, float]]:
    """``steps`` calls of ``run_step`` under torch.profiler: the host wall in
    us (ending in a synchronize) and the device us of each kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        # device kernels and copies; not the user annotations the profiler
        # mirrors onto the device timeline (they overlap the kernels)
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return wall_us, by_name


def profile_record(phase: str, steps: int, wall_us: float, by_name: dict[str, float],
                   top: int = 6, **extra) -> dict:
    """Host and device ms per step, the device's idle share (1 - busy/wall,
    the kernels run on one stream) and the ``top`` kernels by device time."""
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"phase": phase, "steps": steps, **extra,
            "host_ms_per_step": wall_us / steps / 1e3, "device_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "top_kernels_ms_per_step": {n[:80]: us / steps / 1e3 for n, us in ranked}}


def profile_decode(torch, engine, requests, steps: int = 16,
                   phase: str = "bf16_decode_profile") -> dict:
    """Admit ``requests`` (first step, unprofiled), then profile ``steps``
    `step` calls, each one decode dispatch of ``tokens_per_sync``
    iterations: host wall per step and per decode iteration, device busy
    per step and per iteration (the sum of kernel times on the one stream),
    the six kernels with the most device time and the share of device time
    in the nf4 kernels."""
    for r in requests:
        engine.submit(r)
    engine.step()
    wall_us, by_name = profile_steps(torch, engine.step, steps)
    nf4_us = sum(us for n, us in by_name.items() if "nf4_" in n)
    rec = profile_record(phase, steps, wall_us, by_name, slots=engine.active_slots,
                         pipeline_depth=engine.pipeline_depth,
                         tokens_per_sync=engine.tokens_per_sync,
                         nf4_share_of_device=nf4_us / max(sum(by_name.values()), 1e-9))
    rec["host_ms_per_iteration"] = rec["host_ms_per_step"] / engine.tokens_per_sync
    rec["device_ms_per_iteration"] = rec["device_ms_per_step"] / engine.tokens_per_sync
    return rec


def replay_launches(engine, name: str, eager: int) -> int:
    """Launches of the kernel behind wrapper ``name`` (``paged_decode_attention``,
    ``nf4_matmul``) in a serving run: ``eager``, the wrapper's own count over
    the run (the admission prefills it launched), plus what one decode
    replay launches (counted by the wrapper while the engine captured its
    graph) times the decode replays."""
    return eager + engine.graph_launches.get(name, 0) * engine.metrics.decode_dispatches.value


def graph_kernels(torch, engine, pattern: str) -> int:
    """Device kernels whose name holds ``pattern`` in a profiler window
    around one replay of ``engine``'s decode graph (every slot frozen, so
    the replay changes nothing that is read)."""
    if engine.active_slots:
        raise AssertionError("graph_kernels replays a decode step: every slot must be free")
    _, kernels = device_work(torch, engine._graph.replay)
    return sum(pattern in k for k in kernels)


def serving_line(engine, outs, wall_s: float, launches: int, peak_mem_bytes: int, card: str,
                 phase: str = "bf16_serving", **extra) -> dict:
    """One serving run's line: the engine's depth and iterations per
    dispatch, tokens/s over the run's host wall, TTFT and ITL p50/p99, the
    host's blocked time per fetch p50, decode replays and the forwards they
    ran, the paged kernel's launches counted through the replays, and the
    peak memory."""
    m = engine.metrics
    return {"phase": phase, "pipeline_depth": engine.pipeline_depth,
            "tokens_per_sync": engine.tokens_per_sync, "requests": len(outs),
            "generated_tokens": m.tokens_generated.value, "wall_s": wall_s,
            "tokens_per_s": m.tokens_generated.value / wall_s,
            "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
            "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
            "host_blocked_p50_s": m.host_blocked_s.quantile(0.5),
            "decode_replays": m.decode_dispatches.value, "decode_steps": m.decode_steps.value,
            "kernel_launches": launches, "peak_mem_bytes": peak_mem_bytes, **extra, "card": card}


def flash_counts(fa) -> dict[str, int]:
    return {n: getattr(fa, n).launches for n in FLASH_REPLACES}


def band_counts(fa) -> dict[str, int]:
    return {n: getattr(fa, n).launches for n in BAND_REPLACES}


def fused_ce_counts() -> dict[str, int]:
    from accelerate_tpu_torch.ops import fused_ce

    return {n: getattr(fused_ce, n).launches for n in FUSED_CE_REPLACES}


def reset_counts(fa) -> None:
    """Every kernel wrapper's launch count to 0."""
    from accelerate_tpu_torch.ops import fused_ce

    from accelerate_tpu_torch.ops import nf4_matmul

    fa.paged_decode_attention.launches = 0
    nf4_matmul.nf4_matmul.launches = 0
    for n in (*FLASH_REPLACES, *BAND_REPLACES):
        getattr(fa, n).launches = 0
    for n in FUSED_CE_REPLACES:
        getattr(fused_ce, n).launches = 0


def flash_case(torch, name, *, b, h, s, d, dtype, causal, seed, flush) -> dict:
    """The three flash kernels against their plain versions on one input
    (q pre-scaled, ``[b, h, s, d]``), with their times, SDPA's times and the
    bounds; prints one JSON line per kernel and returns them by kernel."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, s, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
    k, v, dout = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype) for _ in range(3))
    o_ref, lse_ref = fa.flash_attention_forward_reference(q, k, v, causal)
    delta = (dout.float() * o_ref.float()).sum(-1)
    bwd = (q, k, v, dout, lse_ref, delta, causal)
    plain = {"flash_attention_fwd": lambda: fa.flash_attention_forward_reference(q, k, v, causal),
             "flash_attention_dq": lambda: fa.flash_attention_dq_reference(*bwd),
             "flash_attention_dkv": lambda: fa.flash_attention_dkv_reference(*bwd)}
    kernel = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v, causal),
              "flash_attention_dq": lambda: fa.flash_attention_dq(*bwd),
              "flash_attention_dkv": lambda: fa.flash_attention_dkv(*bwd)}

    def outputs(fn) -> tuple:
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    got = {kname: outputs(fn) for kname, fn in kernel.items()}
    want = {kname: outputs(fn) for kname, fn in plain.items()}
    torch.cuda.synchronize()
    lse_err = (got["flash_attention_fwd"][1] - lse_ref).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"flash case {name}: lse max_abs_err {lse_err} > {LSE_ATOL}")

    # yardstick: SDPA forward, and SDPA's backward (dq, dk and dv together)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, scale=1.0)
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                       scale=1.0), flush)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,
                                                           retain_graph=True), flush)
    library = {"flash_attention_fwd": lib_fwd, "flash_attention_dq": lib_bwd,
               "flash_attention_dkv": lib_bwd}

    # least time: each input read once, each output written once; the
    # products over the (query, key) pairs this mask keeps, 2 d flops each
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elt = q.element_size()
    tensor_bytes = b * h * s * d * elt
    row_bytes = b * h * s * 4  # one fp32 [b, h, s] vector (lse or delta)
    io = {"flash_attention_fwd": (4 * tensor_bytes + row_bytes, 2),
          "flash_attention_dq": (5 * tensor_bytes + 2 * row_bytes, 3),
          "flash_attention_dkv": (6 * tensor_bytes + 2 * row_bytes, 4)}
    dev_name = torch.cuda.get_device_name(0)
    bw, fp32_peak, _ = peak_rates(dev_name)
    # fp16 work's least time is on the tensor cores, at bf16's rate
    peak = bf16_peak(dev_name) if dtype in (torch.bfloat16, torch.float16) else fp32_peak
    atol, rtol = FLASH_TOL[str(dtype).removeprefix("torch.")]
    recs = {}
    for kname in FLASH_REPLACES:
        err, bad = 0.0, 0.0
        for a, w in zip(got[kname], want[kname]):
            diff = (a.float() - w.float()).abs()
            err = max(err, diff.max().item())
            bad = max(bad, (diff - atol - rtol * w.float().abs()).max().item())
        if not (math.isfinite(err) and bad <= 0):
            raise AssertionError(f"flash case {name}, {kname}: max_abs_err {err} exceeds "
                                 f"atol {atol} + rtol {rtol} * |plain|")
        n_bytes, products = io[kname]
        n_flops = products * 2 * d * pairs
        kernel_ms = device_ms(torch, kernel[kname], flush)
        bound_ms = max(n_bytes / bw, n_flops / peak) * 1e3
        rec = dict(case=name, kernel=kname, b=b, h=h, s=s, d=d, dtype=str(dtype).removeprefix("torch."),
                   causal=causal, max_abs_err=err, atol=atol, rtol=rtol,
                   **({"lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL}
                      if kname == "flash_attention_fwd" else {}),
                   kernel_ms=kernel_ms,
                   plain_ms=device_ms(torch, plain[kname], flush, samples=10),
                   library_ms=library[kname], bound_ms=bound_ms,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops, tflops=n_flops / kernel_ms * 1e-9,
                   bound_share=bound_ms / kernel_ms)
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    return recs


def fused_ce_case(torch, name, *, n, v, e, dtype, ignore_every, seed, flush) -> dict:
    """The three fused-CE kernels against their plain versions on one input
    (h ``[n, e]``, w ``[v, e]`` at GPT-2's init scale, every
    ``ignore_every``-th row ignored, 1 for all of them), with the gradients
    of the mean loss (g_lse = mask / count, g_ll = -g_lse); their times, the
    unfused PyTorch head + cross-entropy's times, and the bounds. Prints one
    JSON line per kernel and returns them by kernel."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import fused_ce as fc

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, e, generator=g, device=dev).to(dtype)
    w = (torch.randn(v, e, generator=g, device=dev) * 0.02).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    labels[torch.arange(n, device=dev) % ignore_every == ignore_every - 1] = -100
    mask = labels != -100
    safe = torch.where(mask, labels, 0).to(torch.int32)
    g_lse = mask.float() / mask.sum().clamp(min=1)
    g_ll = -g_lse
    lse, _ = fc.fused_ce_forward_reference(h, w, safe)
    bwd = (h, w, safe, lse, g_lse, g_ll)
    plain = {"fused_ce_fwd": lambda: fc.fused_ce_forward_reference(h, w, safe),
             "fused_ce_dh": lambda: fc.fused_ce_dh_reference(*bwd),
             "fused_ce_dw": lambda: fc.fused_ce_dw_reference(*bwd)}
    kernel = {"fused_ce_fwd": lambda: fc.fused_ce_fwd(h, w, safe),
              "fused_ce_dh": lambda: fc.fused_ce_dh(*bwd),
              "fused_ce_dw": lambda: fc.fused_ce_dw(*bwd)}

    # yardstick: the unfused head and cross-entropy, forward, and its
    # backward (dH and dW together)
    hl, wl = (t.detach().clone().requires_grad_() for t in (h, w))
    lib_loss = F.cross_entropy(F.linear(hl, wl).float(), labels)
    lib_fwd = device_ms(torch, lambda: F.cross_entropy(F.linear(h, w).float(), labels), flush,
                        samples=10)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(lib_loss, (hl, wl), retain_graph=True),
                        flush, samples=10)
    del lib_loss, hl, wl
    library = {"fused_ce_fwd": lib_fwd, "fused_ce_dh": lib_bwd, "fused_ce_dw": lib_bwd}

    # least time: each input read once and each output written once; the
    # forward is one [n, e] x [e, v] product, dH and dW two each (the logits
    # are recomputed from lse)
    elt = h.element_size()
    inputs = (n + v) * e * elt + n * 4
    io = {"fused_ce_fwd": (inputs + 2 * n * 4, 1),
          "fused_ce_dh": (inputs + 3 * n * 4 + n * e * elt, 2),
          "fused_ce_dw": (inputs + 3 * n * 4 + v * e * elt, 2)}
    dev_name = torch.cuda.get_device_name(0)
    bw, fp32_peak, _ = peak_rates(dev_name)
    peak = bf16_peak(dev_name) if dtype in (torch.bfloat16, torch.float16) else fp32_peak
    dtype_name = str(dtype).removeprefix("torch.")
    rtol, atol = FUSED_CE_TOL[dtype_name]
    samples = 30 if dtype == torch.bfloat16 else 5
    recs = {}
    for kname in FUSED_CE_REPLACES:
        got, want = kernel[kname](), plain[kname]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, bad, share = 0.0, 0.0, 0.0
        for a, b in zip(got, want):
            diff = (a.float() - b.float()).abs()
            ref = b.float().abs()
            bar = (FUSED_CE_ROW_TOL[0] + FUSED_CE_ROW_TOL[1] * ref if kname == "fused_ce_fwd"
                   else rtol * ref + atol * ref.max())
            err = max(err, diff.max().item())
            bad = max(bad, (diff - bar).max().item())
            share = max(share, (diff / bar.clamp(min=1e-30)).max().item())
        del got, want
        if not (math.isfinite(err) and bad <= 0):
            raise AssertionError(f"fused-CE case {name}, {kname}: max_abs_err {err} exceeds its bar")
        if ignore_every == 1 and kname != "fused_ce_fwd" and err != 0.0:
            raise AssertionError(f"fused-CE case {name}, {kname}: nonzero gradient, all rows ignored")
        n_bytes, products = io[kname]
        n_flops = products * 2 * n * v * e
        rec = dict(phase="fused_ce_kernels", case=name, kernel=kname, n=n, v=v, e=e, dtype=dtype_name,
                   ignored_rows=int((~mask).sum().item()), max_abs_err=err, err_over_bar=share,
                   tol=FUSED_CE_ROW_TOL if kname == "fused_ce_fwd" else (rtol, atol),
                   kernel_ms=device_ms(torch, kernel[kname], flush, samples=samples),
                   plain_ms=device_ms(torch, plain[kname], flush, samples=5),
                   library_ms=library[kname],
                   bound_ms=max(n_bytes / bw, n_flops / peak) * 1e3,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops)
        rec.update(tflops=n_flops / rec["kernel_ms"] * 1e-9, bound_share=rec["bound_ms"] / rec["kernel_ms"])
        if kname == "fused_ce_fwd" and dtype == torch.bfloat16:  # the cluster split of the vocab
            plan = fc.fwd_plan(n, v, fc.card_limits(torch.cuda.current_device()))
            rec.update(plan=plan, cluster_ctas=plan["splits"],
                       ring_stages=fc.fwd_launch(plan["splits"])["ring_stages"])
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    torch.cuda.empty_cache()
    return recs


def fused_ce_part(kname: str) -> str | None:
    """Which fused-CE kernel a profiled kernel name is: ``forward``, ``dH`` or
    ``dW`` (the bool after the type in ``fused_ce_bwd_kernel<T, DW, ...>``),
    else None."""
    if "fused_ce_fwd_kernel" in kname:
        return "forward"
    m = re.search(r"fused_ce_bwd_kernel<[^,>]+, (false|true)\b", kname)
    return ("dW" if m.group(1) == "true" else "dH") if m else None


def profile_train(torch, run_step, phase: str, steps: int = 3, **extra) -> dict:
    """A profiler window over ``steps`` train steps: host and device ms per
    step, the idle share, the top kernels, the device ms per step of each
    kind of kernel (TRAIN_KERNEL_CATEGORIES), of each flash kernel (the
    forward, dQ and dK/dV split of the flash categories) and of each fused-CE
    kernel (forward, dH, dW); prints and returns the record."""
    wall_us, by_name = profile_steps(torch, run_step, steps)
    categories: dict[str, float] = {}
    flash: dict[str, float] = {}
    fused: dict[str, float] = {}
    for kname, us in by_name.items():
        cat = next((c for c, pattern in TRAIN_KERNEL_CATEGORIES
                    if re.search(pattern, kname, re.IGNORECASE)), "other")
        categories[cat] = categories.get(cat, 0.0) + us / steps / 1e3
        m = re.search(r"flash_(?:band_)?(?:fwd|dq|dkv)_kernel", kname)
        if m:
            flash[m.group(0)] = flash.get(m.group(0), 0.0) + us / steps / 1e3
        part = fused_ce_part(kname)
        if part:
            fused[part] = fused.get(part, 0.0) + us / steps / 1e3
    prof = profile_record(phase, steps, wall_us, by_name, top=8, **extra,
                          categories_ms_per_step=categories, flash_kernels_ms_per_step=flash,
                          fused_ce_kernels_ms_per_step=fused)
    print(json.dumps(prof), flush=True)
    return prof


def band_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs one head attends on the band: sum over i of
    min(i + 1, window)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def band_case(torch, name, *, b, hq, hkv, s, d, window, dtype, seed, flush, card,
              by_group=False, rect=False, rms_tol=None, samples=30, pad_to=None) -> dict:
    """The three band kernels against their plain versions on one input (q
    pre-scaled ``[b, hq, s, d]``, K/V ``[b, hkv, s, d]``), with their times,
    the times of SDPA over an explicit boolean band mask with
    ``enable_gqa=True`` (forward, and its backward: dq, dk and dv together),
    and the bounds; prints one JSON line per kernel and returns them by
    kernel. Each output is held to FLASH_TOL, lse to LSE_ATOL, and with
    ``rms_tol`` (by kernel) each output also to rtol |plain| + rms_tol
    rms(plain). ``by_group`` evaluates the plain versions one kv head's group at
    a time, to bound their memory. ``rect`` also times the rectangular
    kernels on the same (causal) function, with K/V repeated to the query
    heads, and holds the band forward's output to theirs. ``samples`` is the
    kernels' timed runs (fewer for the slow wide-head bodies). ``pad_to``
    zero-pads q, K, V and the output's gradient from head_dim ``d`` to
    ``pad_to``, as `flash_attention` pads a head_dim that is not a multiple
    of 64: the kernels, the plain versions and the bounds see the padded
    width."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, hq, s, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=g, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn(b, hq, s, d, generator=g, device=dev).to(dtype)
    if pad_to is not None:
        q, k, v, dout = (F.pad(t, (0, pad_to - d)) for t in (q, k, v, dout))
        d = pad_to
    groups = hq // hkv
    spans = [(j, j + 1) for j in range(hkv)] if by_group else [(0, hkv)]

    def plain_fwd():
        outs = [fa.flash_band_forward_reference(q[:, lo * groups:hi * groups], k[:, lo:hi],
                                                v[:, lo:hi], window) for lo, hi in spans]
        return torch.cat([o for o, _ in outs], 1), torch.cat([m for _, m in outs], 1)

    o_ref, lse_ref = plain_fwd()
    delta = (dout.float() * o_ref.float()).sum(-1)

    def split(lo, hi):
        r = slice(lo * groups, hi * groups)
        return (q[:, r], k[:, lo:hi], v[:, lo:hi], dout[:, r], lse_ref[:, r], delta[:, r], window)

    def plain_dq():
        return torch.cat([fa.flash_band_dq_reference(*split(lo, hi)) for lo, hi in spans], 1)

    def plain_dkv():
        outs = [fa.flash_band_dkv_reference(*split(lo, hi)) for lo, hi in spans]
        return torch.cat([a for a, _ in outs], 1), torch.cat([c for _, c in outs], 1)

    bwd = (q, k, v, dout, lse_ref, delta, window)
    plain = {"flash_band_fwd": plain_fwd, "flash_band_dq": plain_dq, "flash_band_dkv": plain_dkv}
    kernel = {"flash_band_fwd": lambda: fa.flash_band_fwd(q, k, v, window),
              "flash_band_dq": lambda: fa.flash_band_dq(*bwd),
              "flash_band_dkv": lambda: fa.flash_band_dkv(*bwd)}
    dtype_name = str(dtype).removeprefix("torch.")
    atol, rtol = FLASH_TOL[dtype_name]

    def check(what, got, want, over_rms_tol=math.inf):
        """(max |err|, max (|err| - rtol |plain|) / rms(plain), rms(plain))
        over the outputs; raises past FLASH_TOL or ``over_rms_tol``."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, bad, over_rms, rms_seen = 0.0, 0.0, 0.0, []
        for a, w in zip(got, want):
            if a.shape != w.shape:
                raise AssertionError(f"band case {name}, {what}: shape {tuple(a.shape)} "
                                     f"!= {tuple(w.shape)}")
            w = w.float()
            diff = (a.float() - w).abs()
            err = max(err, diff.max().item())
            bad = max(bad, (diff - atol - rtol * w.abs()).max().item())
            rms = w.square().mean().sqrt().item()
            rms_seen.append(rms)
            over_rms = max(over_rms, (diff - rtol * w.abs()).max().item() / max(rms, 1e-30))
        if not (math.isfinite(err) and bad <= 0 and over_rms <= over_rms_tol):
            raise AssertionError(f"band case {name}, {what}: max_abs_err {err}, "
                                 f"(|err| - {rtol} |plain|) / rms(plain) up to {over_rms}: "
                                 f"exceeds atol {atol} + rtol {rtol} * |plain| or "
                                 f"{rtol} * |plain| + {over_rms_tol} * rms(plain)")
        return err, over_rms, rms_seen

    rms_tol = rms_tol or {}
    errs, over, rms = {}, {}, {}
    o, lse = kernel["flash_band_fwd"]()
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"band case {name}: lse max_abs_err {lse_err} > {LSE_ATOL}")
    errs["flash_band_fwd"], over["flash_band_fwd"], rms["flash_band_fwd"] = check(
        "flash_band_fwd", o, o_ref, rms_tol.get("flash_band_fwd", math.inf))
    errs["flash_band_fwd"] = max(errs["flash_band_fwd"], lse_err)
    del o, lse
    for kname in ("flash_band_dq", "flash_band_dkv"):
        got = kernel[kname]()
        torch.cuda.synchronize()
        errs[kname], over[kname], rms[kname] = check(kname, got, plain[kname](),
                                                     rms_tol.get(kname, math.inf))
        del got
    rect_rec = {}
    if rect:
        kr, vr = (t.repeat_interleave(groups, dim=1) for t in (k, v))
        rbwd = (q, kr, vr, dout, lse_ref, delta, True)
        rect_fns = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, kr, vr, True),
                    "flash_attention_dq": lambda: fa.flash_attention_dq(*rbwd),
                    "flash_attention_dkv": lambda: fa.flash_attention_dkv(*rbwd)}
        rect_rec["rect_o_max_abs_err"] = check("rect forward", rect_fns["flash_attention_fwd"]()[0],
                                               o_ref)[0]
        rect_rec["rect_ms"] = {n: device_ms(torch, fn, flush) for n, fn in rect_fns.items()}
        del kr, vr, rbwd, rect_fns

    # yardstick: SDPA over the explicit band mask (it does the full s^2
    # work), forward and backward
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    mask = (j <= i) & ((j > i - window) if window is not None else True)
    sdpa = dict(attn_mask=mask, scale=1.0, enable_gqa=groups > 1)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), flush,
                        samples=10)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,
                                                           retain_graph=True), flush, samples=10)
    del sdpa_out, qs, ks, vs, mask
    library = {"flash_band_fwd": lib_fwd, "flash_band_dq": lib_bwd, "flash_band_dkv": lib_bwd}

    # least time: each input read once, each output written once; 2 d flops
    # per attended (query, key) pair and product
    pairs = b * hq * band_pairs(s, window)
    elt = q.element_size()
    q_bytes, kv_bytes, rows = b * hq * s * d * elt, b * hkv * s * d * elt, b * hq * s * 4
    io = {"flash_band_fwd": (2 * q_bytes + 2 * kv_bytes + rows, 2),
          "flash_band_dq": (3 * q_bytes + 2 * kv_bytes + 2 * rows, 3),
          "flash_band_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * rows, 4)}
    bw, fp32_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    peak = bf16_peak(torch.cuda.get_device_name(0)) if dtype == torch.bfloat16 else fp32_peak
    recs = {}
    for kname in BAND_REPLACES:
        n_bytes, products = io[kname]
        n_flops = products * 2 * d * pairs
        kernel_ms = device_ms(torch, kernel[kname], flush, samples=samples)
        bound_ms = max(n_bytes / bw, n_flops / peak) * 1e3
        rec = dict(phase="flash_band_kernels", case=name, kernel=kname, b=b, hq=hq, hkv=hkv, s=s,
                   d=d, window=window, dtype=dtype_name, max_abs_err=errs[kname], atol=atol,
                   rtol=rtol, err_over_rms=over[kname], plain_rms=rms[kname],
                   rms_tol=rms_tol.get(kname),
                   **({"lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL}
                      if kname == "flash_band_fwd" else {}),
                   kernel_ms=kernel_ms,
                   plain_ms=device_ms(torch, plain[kname], flush, samples=5),
                   library_ms=library[kname], bound_ms=bound_ms,
                   bound_by="bytes" if n_bytes / bw >= n_flops / peak else "operations",
                   bytes=n_bytes, flops=n_flops, tflops=n_flops / kernel_ms * 1e-9,
                   bound_share=bound_ms / kernel_ms, **rect_rec, card=card)
        print(json.dumps(rec), flush=True)
        recs[kname] = rec
    del q, k, v, dout, o_ref, lse_ref, delta
    torch.cuda.empty_cache()
    return recs


def mistral_config(torch, **kw):
    """Mistral-7B's published width (mistralai/Mistral-7B-v0.1 config.json;
    arXiv 2310.06825, Table 1) as a `LlamaConfig`, depth cut to 4 layers:
    7.24 B parameters at 16 bytes of training state each exceed the card."""
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=4,
        num_heads=32, num_kv_heads=8, rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=8192, sliding_window=4096, attention_impl="flash",
        dtype=torch.bfloat16), **kw})


def llama_band_parity(torch, np, seed: int, card: str) -> dict:
    """One fp32 train step (TF32 off) of a narrow Mistral shape (hidden 1024,
    8 heads, 2 kv heads, intermediate 3584, 2 layers, vocab 32000, batch
    1 x 2048, window 512) with ``attention_impl="flash"`` (the band kernels)
    and one with ``"xla"`` (the plain path), from the same weights and
    batch: loss and global gradient norm agree; each band kernel ran once
    per layer in the flash step and never in the other."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    shape = dict(hidden_size=1024, num_heads=8, num_kv_heads=2, intermediate_size=3584,
                 num_layers=2, max_position_embeddings=2048, sliding_window=512,
                 dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 32000, (1, 2048))).to("cuda")
    out = {}
    for impl in ("xla", "flash"):
        model = LlamaForCausalLM(mistral_config(torch, attention_impl=impl, **shape), seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(llama_loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[impl] = (loss, step.grad_norm.item(), {**band_counts(fa), **flash_counts(fa)})
        del model, acc, step
        torch.cuda.empty_cache()
    (loss_x, norm_x, counts_x), (loss_f, norm_f, counts) = out["xla"], out["flash"]
    rec = {"phase": "fp32_llama_band_parity", "batch": 1, "seq": 2048, "window": 512,
           "loss_plain": loss_x, "loss_flash": loss_f, "loss_abs_diff": abs(loss_f - loss_x),
           "loss_atol": TRAIN_LOSS_ATOL, "grad_norm_plain": norm_x, "grad_norm_flash": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x,
           "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL, "launches": counts, "launches_plain": counts_x,
           "card": card}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_x) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 Llama step: band loss {loss_f} vs plain {loss_x}")
    if not abs(norm_f - norm_x) <= TRAIN_GRAD_NORM_RTOL * norm_x:
        raise AssertionError(f"fp32 Llama step: band grad norm {norm_f} vs plain {norm_x}")
    expected = {**{n: shape["num_layers"] for n in BAND_REPLACES}, **{n: 0 for n in FLASH_REPLACES}}
    if counts != expected or any(counts_x.values()):
        raise AssertionError(f"fp32 Llama launches {counts} (plain step {counts_x}), "
                             f"expected {expected} (none)")
    return rec


def train_mistral(torch, np, seed: int, card: str, warmup: int = 2, steps: int = 10,
                  fused_ce: bool = False) -> dict:
    """The slice's path: the Mistral-7B-width model (4 layers, window 4096),
    fp32 masters, ``Accelerator(mixed_precision="bf16")``, AdamW (lr 1e-4,
    weight decay 1e-4), ``make_train_step(llama_loss_fn)`` on one seeded
    batch of 1 x 8192 ids, repeated; ``warmup`` then ``steps`` timed steps
    with the launch counts set to 0 just before them. The loss falls over
    the ``warmup + steps`` steps, and each band kernel ran once per layer per
    timed step, the rectangular flash kernels never. MFU counts 6 N per
    token for the N matmul parameters plus 12 L e w per token for
    attention, w the mean number of keys a query sees. Then a profiler
    window over 3 steps. With ``fused_ce`` the loss is `llama_loss_fn_fused`
    (the untied head on the fused-CE kernels at e 4096; each ran once a
    step) and the phase ``bf16_train_mistral_fused_ce``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn, llama_loss_fn_fused
    from accelerate_tpu_torch.ops import flash_attention as fa

    batch, seq = 1, 8192
    cfg = mistral_config(torch)
    model = LlamaForCausalLM(cfg, seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(llama_loss_fn_fused if fused_ce else llama_loss_fn)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    data = {"input_ids": torch.from_numpy(ids).to("cuda")}

    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = {**band_counts(fa), **flash_counts(fa), **fused_ce_counts()}
    phase = "bf16_train_mistral_fused_ce" if fused_ce else "bf16_train_mistral"
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = sum(p.numel() for p in model.parameters() if p.ndim == 2) - model.embed_tokens.numel()
    mean_keys = band_pairs(seq, cfg.sliding_window) / seq
    flops_per_token = 6 * n_matmul + 12 * cfg.num_layers * cfg.hidden_size * mean_keys
    tokens_per_s = batch * seq * steps / wall
    mfu = tokens_per_s * flops_per_token / bf16_peak(torch.cuda.get_device_name(0))
    rec = {"phase": phase, "model": "mistral-7b-width, 4 layers", "batch": batch,
           "seq": seq, "window": cfg.sliding_window, "params": n_params,
           "matmul_params": n_matmul, "mean_keys_per_query": mean_keys,
           "warmup_steps": warmup, "steps": steps, "step_ms": wall / steps * 1e3,
           "tokens_per_s": tokens_per_s, "mfu": mfu, "flops_per_token": flops_per_token,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "launches": counts, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mistral training: the loss did not fall: {losses}")
    expected = {**{n: cfg.num_layers * steps for n in BAND_REPLACES},
                **{n: 0 for n in FLASH_REPLACES},
                **{n: steps if fused_ce else 0 for n in FUSED_CE_REPLACES}}
    if counts != expected:
        raise AssertionError(f"{phase} launches {counts}, expected {expected}")
    rec["profile"] = profile_train(torch, lambda: step(data), f"{phase}_profile", card=card)
    del model, acc, step
    torch.cuda.empty_cache()
    return rec


def train_flops_per_token(model, seq: int) -> int:
    """bench.py's count: 6 N for the forward and backward of N parameters,
    plus 12 s e per layer per token for attention."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    return 6 * n_params + cfg.n_layer * 12 * seq * cfg.n_embd


def train_parity(torch, np, seed: int) -> dict:
    """One fp32 train step of GPT-2 small (TF32 off) with flash attention and
    one with the plain path, from the same weights and batch: loss and global
    gradient norm (before the optimizer) agree; each flash kernel ran n_layer
    times in the flash step."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 50257, (2, 1024))).to("cuda")
    out = {}
    for impl in ("xla", "flash"):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl=impl),
                           device="cuda", seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        # a clip threshold no norm reaches: the step records the norm, scales by 1
        step = acc.make_train_step(lm_loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[impl] = (loss, step.grad_norm.item(), flash_counts(fa))
        del model, acc, step
        torch.cuda.empty_cache()
    n_layer = GPT2Config.small().n_layer
    (loss_x, norm_x, _), (loss_f, norm_f, counts) = out["xla"], out["flash"]
    rec = {"phase": "fp32_train_parity", "batch": 2, "seq": 1024, "loss_plain": loss_x,
           "loss_flash": loss_f, "loss_abs_diff": abs(loss_f - loss_x), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_norm_plain": norm_x, "grad_norm_flash": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
           "launches": counts}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_x) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 train step: flash loss {loss_f} vs plain {loss_x}")
    if not abs(norm_f - norm_x) <= TRAIN_GRAD_NORM_RTOL * norm_x:
        raise AssertionError(f"fp32 train step: flash grad norm {norm_f} vs plain {norm_x}")
    if any(n != n_layer for n in counts.values()):
        raise AssertionError(f"fp32 flash step launches {counts}, expected {n_layer} each")
    return rec


def fused_ce_parity(torch, np, seed: int) -> dict:
    """One fp32 train step of GPT-2 small (TF32 off, flash attention) with
    `lm_loss_fn_pallas` and one with `lm_loss_fn`, from the same weights and
    batch: loss and global gradient norm (before the optimizer) agree; each
    fused-CE kernel ran once in the fused step and never in the other."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
        lm_loss_fn,
        lm_loss_fn_pallas,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 50257, (2, 1024))).to("cuda")
    out = {}
    for loss_fn in (lm_loss_fn, lm_loss_fn_pallas):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl="flash"),
                           device="cuda", seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[loss_fn.__name__] = (loss, step.grad_norm.item(), fused_ce_counts())
        del model, acc, step
        torch.cuda.empty_cache()
    (loss_p, norm_p, plain_counts), (loss_f, norm_f, counts) = (out["lm_loss_fn"],
                                                                out["lm_loss_fn_pallas"])
    rec = {"phase": "fp32_fused_ce_parity", "batch": 2, "seq": 1024, "loss_plain": loss_p,
           "loss_fused": loss_f, "loss_abs_diff": abs(loss_f - loss_p), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_norm_plain": norm_p, "grad_norm_fused": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_p) / norm_p, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
           "launches": counts, "launches_plain_loss": plain_counts}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_p) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 train step: fused-CE loss {loss_f} vs plain {loss_p}")
    if not abs(norm_f - norm_p) <= TRAIN_GRAD_NORM_RTOL * norm_p:
        raise AssertionError(f"fp32 train step: fused-CE grad norm {norm_f} vs plain {norm_p}")
    if any(n != 1 for n in counts.values()) or any(plain_counts.values()):
        raise AssertionError(f"fp32 fused-CE launches {counts} (plain loss {plain_counts}), "
                             "expected 1 each (0 each)")
    return rec


def train_bf16(torch, np, seed: int, card: str, fused_ce: bool = False, warmup: int = 2,
               steps: int = 10) -> tuple[dict, dict]:
    """bench.py's training path on GPT-2 small: bf16 mixed precision, AdamW
    (lr 1e-4, weight decay 1e-4, optax's default), batch 8 x 1024 of seeded
    ids repeated; ``warmup`` then ``steps`` timed steps with the launch counts
    set to 0 just before them. Then a profiler window over 3 steps. The loss
    is `lm_loss_fn`, or with ``fused_ce`` `lm_loss_fn_pallas`
    (``BENCH_FUSED_CE=2``)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn, lm_loss_fn_pallas
    from accelerate_tpu_torch.ops import flash_attention as fa

    batch, seq = 8, 1024
    cfg = GPT2Config.small(dtype=torch.bfloat16, attention_impl="flash")
    model = GPT2LMHead(cfg, device="cuda", seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn_pallas if fused_ce else lm_loss_fn)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    data = {"input_ids": torch.from_numpy(ids).to("cuda")}

    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = {**flash_counts(fa), **fused_ce_counts()}
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_per_token = train_flops_per_token(model, seq)
    mfu = tokens_per_s * flops_per_token / bf16_peak(torch.cuda.get_device_name(0))
    phase = "bf16_train_fused_ce" if fused_ce else "bf16_train"
    rec = {"phase": phase, "model": "gpt2-small", "batch": batch, "seq": seq,
           "warmup_steps": warmup, "steps": steps, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
           "mfu": mfu, "flops_per_token": flops_per_token,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "launches": counts, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 training: the loss did not fall: {losses}")
    expected = {**{n: cfg.n_layer * steps for n in FLASH_REPLACES},
                **{n: steps if fused_ce else 0 for n in FUSED_CE_REPLACES}}
    if counts != expected:
        raise AssertionError(f"{phase} launches {counts}, expected {expected}")

    prof = profile_train(torch, lambda: step(data), f"{phase}_profile")
    del model, acc, step
    torch.cuda.empty_cache()
    return rec, prof


def nf4_case(torch, name, *, M, K, N, dtype, seed, flush, lead=()) -> dict:
    """`nf4_matmul` against its plain version on one seeded nf4 weight ``[K,
    N]`` and x ``[M, K]`` (``lead`` splits M into leading dims), with its
    time, the plain version's, the bound and the library yardstick: ``x @ W``
    through cuBLAS over a dense bf16 copy of the weight, the dense route that
    nf4 serving replaces (not the same function; the port never calls it). A
    weight the kernel does not take must launch nothing and match the
    dequantize route. Prints one JSON line and returns it."""
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, dequantize, quantize

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quantize(torch.randn(K, N, generator=g, device=dev) / math.sqrt(K),
                  QuantizationConfig(load_in_4bit=True, quant_type="nf4",
                                     compute_dtype=torch.float32))
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    xin = x.reshape(*lead, M // math.prod(lead), K) if lead else x
    routed = nm.routes_to_kernel(qt)
    before = nm.nf4_matmul.launches
    out = nm.nf4_matmul(xin, qt).reshape(M, N)
    launched = nm.nf4_matmul.launches - before
    if routed:
        packed, scales2 = nm.plane_pack(qt)

        def plain():
            return nm.nf4_matmul_reference(x, packed, scales2)
    else:
        def plain():
            return x @ dequantize(qt, dtype)
    ref = plain()
    torch.cuda.synchronize()
    dtype_name = str(dtype).removeprefix("torch.")
    atol, rtol = NF4_TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff - atol - rtol * ref.float().abs()).max().item()
    if launched != int(routed) or not (math.isfinite(err) and bad <= 0):
        raise AssertionError(f"nf4 case {name}: {launched} launches (routed {routed}), "
                             f"max_abs_err {err} exceeds atol {atol} + rtol {rtol} |plain|")
    calls, on_device = device_work(torch, lambda: nm.nf4_matmul(xin, qt)) if routed else (0, [])
    if routed and (calls != 1 or len(on_device) > 1
                   or any("nf4_matmul_kernel" not in k for k in on_device)):
        raise AssertionError(f"nf4 case {name}: one call made {calls} launches and ran {on_device} "
                             "on the device, not the one nf4 kernel")
    dense = dequantize(qt, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    kernel_ms = device_ms(torch, lambda: nm.nf4_matmul(x, qt), flush)
    plain_ms = device_ms(torch, plain, flush, samples=10)
    library_ms = device_ms(torch, lambda: xb @ dense, flush)
    # least time: payload and scales, x read once, the output written once;
    # 2 M K N fp32 flops on the CUDA cores (the weight stays fp32)
    elt = x.element_size()
    n_bytes = qt.nbytes + M * K * elt + M * N * elt
    n_flops = 2 * M * K * N
    bw, fp32_peak, _ = peak_rates(torch.cuda.get_device_name(0))
    rec = dict(phase="nf4_kernels", case=name, M=M, K=K, N=N, lead=list(lead), dtype=dtype_name,
               routed=routed, launches=launched, max_abs_err=err, tol=(atol, rtol),
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               library="x_bf16 @ dense bf16 W, cuBLAS: the dense route, a different function",
               splits=nm.split_k(M, K, N)[0] if routed else None,
               device_launches_per_call=calls, device_kernels_seen=len(on_device),
               bound_ms=max(n_bytes / bw, n_flops / fp32_peak) * 1e3,
               bound_share=max(n_bytes / bw, n_flops / fp32_peak) * 1e3 / kernel_ms,
               bound_by="bytes" if n_bytes / bw >= n_flops / fp32_peak else "operations",
               bytes=n_bytes, flops=n_flops, gb_per_s=n_bytes / kernel_ms / 1e6)
    print(json.dumps(rec), flush=True)
    del qt, dense, x, xb, out, ref
    return rec


def count_admissions(engine) -> list:
    """Wrap ``engine``'s admission (plain or prefix-cached) so each group that
    is seated (one prefill forward) adds one to the returned counter's first
    entry, and the host wall of every admission call (the eager prefill's
    launches, and at depth 1 its fetch) to its second."""
    counter = [0, 0.0]
    admit = engine._admit_group

    def counted(group, finished, *matches):
        t0 = time.perf_counter()
        seated = admit(group, finished, *matches)
        counter[1] += time.perf_counter() - t0
        counter[0] += int(seated)
        return seated

    engine._admit_group = counted
    return counter


def quant_parity(torch, seed: int, prompts: list[list[int]]) -> dict:
    """fp32 GPT-2 small, TF32 off. (a) The nf4 engine against a dense engine
    over the dequantized copy of the same packed weights: equal greedy
    streams, and 4 x n_layer nf4 launches per forward (decode step or
    admission prefill; a decode step's counted through the replays, and
    seen in a profiler window around one replay), none in the dense run. (b)
    An int8-KV model: the fused engine against the gather engine, equal
    streams, the paged kernel n_layer times per decode step."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention
    from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine
    from accelerate_tpu_torch.utils.quantization import dequantize_module

    kw = dict(max_concurrency=8, prompt_buckets=BUCKETS, paged_kv=True)

    def run(engine):
        admissions = count_admissions(engine)
        outs = engine.run([Request(prompt=p, params=SamplingParams(max_new_tokens=32))
                           for p in prompts])
        return [o.tokens for o in outs], engine.metrics.decode_steps.value, admissions[0]

    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
    per_forward = 4 * model.config.n_layer
    nf4 = ServingEngine(model, weight_quant="nf4", paged_attention="fused", **kw)
    del model
    nm.nf4_matmul.launches = 0
    nf4_out, steps, admissions = run(nf4)
    launches = replay_launches(nf4, "nf4_matmul", nm.nf4_matmul.launches)
    nf4_in_replay = graph_kernels(torch, nf4, "nf4_matmul_kernel")
    dense = ServingEngine(dequantize_module(nf4.model), paged_attention="fused", **kw)
    nm.nf4_matmul.launches = 0
    dense_out, _, _ = run(dense)
    dense_launches = replay_launches(dense, "nf4_matmul", nm.nf4_matmul.launches)
    del nf4, dense
    model8 = GPT2LMHead(GPT2Config.small(dtype=torch.float32, kv_cache_dtype=torch.int8),
                        device="cuda", seed=seed)
    gather_out, _, _ = run(ServingEngine(model8, paged_attention="gather", **kw))
    fused = ServingEngine(model8, paged_attention="fused", **kw)
    paged_decode_attention.launches = 0
    fused_out, fused_steps, _ = run(fused)
    paged = replay_launches(fused, "paged_decode_attention", paged_decode_attention.launches)
    del fused
    rec = {"phase": "fp32_quant_parity", "requests": len(prompts), "pipeline_depth": 2,
           "nf4_tokens_equal_dense_dequantized": nf4_out == dense_out,
           "nf4_decode_steps": steps, "nf4_admission_forwards": admissions,
           "nf4_launches": launches, "nf4_launches_expected": per_forward * (steps + admissions),
           "nf4_launches_per_forward": per_forward, "nf4_kernels_in_one_replay": nf4_in_replay,
           "dense_run_nf4_launches": dense_launches,
           "int8_kv_fused_tokens_equal_gather": fused_out == gather_out,
           "int8_kv_decode_steps": fused_steps, "int8_kv_paged_launches": paged,
           "int8_kv_paged_launches_expected": model8.config.n_layer * fused_steps}
    print(json.dumps(rec), flush=True)
    if nf4_in_replay != per_forward:
        raise AssertionError(f"one nf4 replay ran {nf4_in_replay} nf4 kernels, not {per_forward}")
    if nf4_out != dense_out or fused_out != gather_out:
        raise AssertionError("fp32 quantized streams differ: nf4 vs dense-dequantized, or int8-KV "
                             "fused vs gather")
    if any(len(t) != 32 for t in nf4_out + fused_out):
        raise AssertionError("an fp32 quantized request did not emit its 32 tokens")
    if launches != rec["nf4_launches_expected"] or steps == 0 or dense_launches != 0:
        raise AssertionError(f"nf4 launches {launches} != {per_forward} x (decode steps {steps} + "
                             f"admissions {admissions}), or the dense run launched {dense_launches}")
    if paged != rec["int8_kv_paged_launches_expected"] or fused_steps == 0:
        raise AssertionError(f"int8-KV paged launches {paged} != n_layer x decode steps")
    del model8
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def quant_serving(torch, seed: int, requests, long_requests, card: str) -> dict:
    """bf16 GPT-2 small served with quantized weights (this slice's path):
    the nf4 engine over an int8 KV pool, then the int8-weights engine over a
    bf16 pool, each over phase 5's 48 requests after a 4-request warm-up;
    one serving-metrics line each with `quant_stats()`, the launches, and the
    memory allocated after load with the dense model freed, beside the dense
    engine's; the plane-pack cache's bytes on a line of their own; then a
    profiler window over 16 nf4 decode steps. Returns the nf4 line."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.serving import FINISH_LENGTH, PagedKVConfig, ServingEngine
    from accelerate_tpu_torch.utils.quantization import QuantizedLinear

    def build(weight_quant, kv_dtype):
        """An engine and the device bytes it holds (model and pool) once the
        dense model it was built from is freed."""
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                            kv_cache_dtype=kv_dtype), device="cuda", seed=seed)
        engine = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                               paged_attention="fused", max_concurrency=16,
                               prompt_buckets=BUCKETS, weight_quant=weight_quant)
        del model
        gc.collect()
        return engine, torch.cuda.memory_allocated() - base

    dense, dense_bytes = build(None, None)
    del dense
    n_layer = GPT2Config.small().n_layer
    lines = {}
    for mode, kv_dtype in (("nf4", torch.int8), ("int8", None)):
        kv_name = "int8" if kv_dtype is not None else "bf16"
        build(mode, kv_dtype)[0].run(requests()[:4])  # warm-up: handles, allocator pools
        torch.cuda.synchronize()
        eng, held = build(mode, kv_dtype)
        admissions = count_admissions(eng)
        reset_counts(fa)
        t0 = time.perf_counter()
        outs = eng.run(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = replay_launches(eng, "nf4_matmul", nm.nf4_matmul.launches)
        paged = replay_launches(eng, "paged_decode_attention", fa.paged_decode_attention.launches)
        m = eng.metrics
        steps = m.decode_steps.value
        bad = [o.request_id for o in outs
               if o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64]
        expected = 4 * n_layer * (steps + admissions[0]) if mode == "nf4" else 0
        rec = {"phase": f"bf16_quant_serving_{mode}_w_{kv_name}_kv", "requests": len(outs),
               "max_new_tokens": 64, "generated_tokens": m.tokens_generated.value, "wall_s": wall,
               "tokens_per_s": m.tokens_generated.value / wall,
               "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
               "itl_p50_s": m.inter_token_s.quantile(0.5), "itl_p99_s": m.inter_token_s.quantile(0.99),
               "pipeline_depth": eng.pipeline_depth, "decode_replays": m.decode_dispatches.value,
               "decode_steps": steps, "admission_forwards": admissions[0],
               "nf4_launches": launches, "nf4_launches_expected": expected,
               "paged_decode_launches": paged, "quant_stats": eng.quant_stats(),
               "memory_allocated_after_load": held, "dense_engine_memory_allocated": dense_bytes,
               "card": card}
        print(json.dumps(rec), flush=True)
        if bad:
            raise AssertionError(f"{mode}: requests {bad} did not finish with 64 tokens")
        if launches != expected or paged != n_layer * steps or steps == 0:
            raise AssertionError(f"{mode}: nf4 launches {launches} (expected {expected}), paged "
                                 f"launches {paged} (expected {n_layer * steps})")
        if mode == "nf4":
            pack = sum(t.numel() * t.element_size()
                       for mod in eng.model.modules() if isinstance(mod, QuantizedLinear)
                       for t in (mod.qweight._plane_pack or ()))
            print(json.dumps({"phase": "nf4_plane_pack_cache", "bytes": pack,
                              "not_in": "weight_packed_bytes"}), flush=True)
            lines[mode] = rec
            prof = profile_decode(torch, build(mode, kv_dtype)[0], long_requests(),
                                  phase="bf16_quant_decode_profile")
            print(json.dumps(prof), flush=True)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return lines["nf4"]


def kv_capacity(torch, np, seed: int, card: str) -> dict:
    """The reference's ``BENCH_SERVE_WORKLOAD=quant`` rows: KV bytes per
    token of an fp32, a bf16 and an int8 pool at equal block geometry (pool
    bytes over token capacity, scale planes counted), and the peak concurrent
    streams of one all-at-once ragged trace through an fp32-KV engine and an
    int8-KV engine whose pool holds as many bytes (fp32 compute on both, so
    KV storage is the only variable)."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.kv_cache import make_block_pool
    from accelerate_tpu_torch.serving import PagedKVConfig, Request, SamplingParams, ServingEngine

    cfg = GPT2Config.small()
    bt, probe_blocks = 16, 64
    per_token, per_block = {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        cache = make_block_pool(cfg.n_layer, 1, probe_blocks, bt, cfg.n_head, cfg.head_dim, dtype,
                                "cuda")
        views = [t for i in range(cfg.n_layer)
                 for t in (*cache.pools(i), *(cache.scale_pools(i) or ()))]
        total = sum(t.numel() * t.element_size() for t in views)
        per_token[name], per_block[name] = total / (probe_blocks * bt), total // probe_blocks
        del cache, views
    fp_blocks = 256
    int8_blocks = fp_blocks * per_block["fp32"] // per_block["int8"]
    rng = np.random.default_rng(seed + 7)
    trace = [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, 48)]
    peaks, steps = {}, {}
    for name, kv_dtype, blocks in (("fp32", None, fp_blocks), ("int8", torch.int8, int8_blocks)):
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, kv_cache_dtype=kv_dtype),
                           device="cuda", seed=seed)
        eng = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=bt, num_blocks=blocks),
                            paged_attention="fused", max_concurrency=64, prompt_buckets=BUCKETS)
        for p in trace:
            if not eng.submit(Request(prompt=p, params=SamplingParams(max_new_tokens=32))).accepted:
                raise AssertionError("capacity trace: a request was rejected")
        peak = 0
        while eng.has_work:
            eng.step()
            peak = max(peak, eng.active_slots)
        peaks[name], steps[name] = peak, eng.metrics.steps.value
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    rec = {"phase": "kv_capacity", "kv_bytes_per_token": per_token,
           "int8_over_bf16": per_token["int8"] / per_token["bf16"],
           "pool_blocks": {"fp32": fp_blocks, "int8": int8_blocks},
           "pool_bytes": {"fp32": fp_blocks * per_block["fp32"],
                          "int8": int8_blocks * per_block["int8"]},
           "requests": len(trace), "max_new_tokens": 32, "peak_streams": peaks,
           "int8_over_fp32_peak": peaks["int8"] / peaks["fp32"], "steps": steps, "card": card}
    print(json.dumps(rec), flush=True)
    if not rec["int8_over_bf16"] <= 0.55:
        raise AssertionError(f"int8 KV bytes per token {rec['int8_over_bf16']} of bf16's > 0.55")
    if not peaks["int8"] > peaks["fp32"]:
        raise AssertionError(f"int8 pool seated {peaks['int8']} streams, fp32 {peaks['fp32']}")
    return rec


LLAMA_7B_PROMPT, LLAMA_7B_NEW_TOKENS, LLAMA_7B_POSITIONS = 64, 20, 512
# the big-model phase's depth: 8 of Llama-2-7B's 32 layers (a 3.8 GB fp16
# checkpoint for the whole model's 13.5 GB), cut to keep the script's time
BIG_MODEL_LAYERS = 4


def top2_margin(torch, logits) -> float:
    """The smallest gap between the two largest logits of any row."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def captured_launches(held, eager: int, replays: int) -> int:
    """nf4 kernel launches of one `generate` call: ``eager``, the wrapper's
    own count over the call (the prefill it launched), plus what one replay
    of the kept decode graph launches (counted by the wrapper while the
    graph was recorded) times the replays the call made (``replays``, the
    kept step's count before it)."""
    return eager + held.launches.get("nf4_matmul", 0) * (held.replays - replays)


def counted_generate(nm, generation, model, ids, n_new: int):
    """A `generate` call that replays the decode graph an earlier call
    captured, its nf4 launches counted (`captured_launches`): (tokens,
    launches). Fails if the call captured anew."""
    held = generation._CAPTURED[model]
    graph, replays = held.graph, held.replays
    nm.nf4_matmul.launches = 0
    out = generation.generate(model, ids, n_new)
    if generation._CAPTURED.get(model) is not held or held.graph is not graph:
        raise AssertionError("the counted generate captured its decode step anew")
    return out, captured_launches(held, nm.nf4_matmul.launches, replays)


def replay_kernels(torch, generation, model, pattern: str) -> int:
    """Device kernels whose name holds ``pattern`` in a profiler window
    around one replay of the decode graph `generate` keeps for ``model``
    (the replay writes past the last call's tokens, which the next call
    masks)."""
    _, kernels = device_work(torch, generation._CAPTURED[model].graph.replay)
    return sum(pattern in k for k in kernels)


def llama_decode_parity(torch, np, seed: int, card: str) -> dict:
    """Llama-2-7B's width (hidden 4096, 32 heads, intermediate 11008, vocab
    32000) cut to 2 layers, 512 positions, seeded fp32 weights, TF32 off.
    (a) `generate` over the slot cache (a 64-token prefill, then one decode
    step a token, replayed from a captured CUDA graph) gives the eager
    step's tokens and the no-cache forward's argmax at each step, batch 2,
    16 tokens. (b) The nf4 copy of the model (every projection on the nf4
    kernel, the embedding and head quantized too) gives the tokens of a dense
    model over its dequantized weights and of its own eager step. Its second
    `generate` call replays the first call's graph: 7 nf4 launches a layer
    each forward (the prefill's counted by the wrapper, the decode steps'
    through the replays), 7 a layer in a profiler window around one replay,
    and none in the dense model's call or graph."""
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.generation import _generate, generate
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        dequantize_module,
        quantize_module,
    )

    cfg = LlamaConfig.llama2_7b(num_layers=2, dtype=torch.float32, param_dtype=torch.float32,
                                max_position_embeddings=LLAMA_7B_POSITIONS)
    model = LlamaForCausalLM(cfg, seed=seed)
    n_new = 16
    ids = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (2, LLAMA_7B_PROMPT))).cuda()

    def eager(m):
        return _generate(m, ids, n_new, 0.0, None, None, m.device, capture=False)

    cached = generate(model, ids, n_new)
    eager_tokens = eager(model)
    seq, margins = ids, []
    with torch.no_grad():
        for _ in range(n_new):
            last = model(seq)[:, -1]
            margins.append(top2_margin(torch, last))
            seq = torch.cat([seq, last.argmax(-1)[:, None]], dim=1)
    nocache = seq[:, LLAMA_7B_PROMPT:]
    qmodel = quantize_module(model, QuantizationConfig(load_in_4bit=True,
                                                       compute_dtype=torch.float32))
    generation.release_captured(model)
    del model
    dense = dequantize_module(qmodel)
    nf4_eager = eager(qmodel)
    generate(qmodel, ids, n_new)  # captures the nf4 decode step
    nf4_tokens, nf4_launches = counted_generate(nm, generation, qmodel, ids, n_new)
    nf4_in_replay = replay_kernels(torch, generation, qmodel, "nf4_matmul_kernel")
    generate(dense, ids, n_new)
    dense_tokens, dense_launches = counted_generate(nm, generation, dense, ids, n_new)
    dense_in_replay = replay_kernels(torch, generation, dense, "nf4_matmul_kernel")
    per_forward = 7 * cfg.num_layers
    rec = {"phase": "fp32_llama_decode_parity", "model": "llama-2-7b width, 2 layers",
           "batch": 2, "prompt": LLAMA_7B_PROMPT, "new_tokens": n_new,
           "max_positions": LLAMA_7B_POSITIONS,
           "cached_equal_nocache_argmax": torch.equal(cached, nocache),
           "captured_equal_eager": torch.equal(cached, eager_tokens),
           "nf4_captured_equal_eager": torch.equal(nf4_tokens, nf4_eager),
           "nocache_min_top2_margin": min(margins),
           "nf4_tokens_equal_dense_dequantized": torch.equal(nf4_tokens, dense_tokens),
           "nf4_launches": nf4_launches, "nf4_launches_per_forward": per_forward,
           "nf4_launches_expected": per_forward * n_new,
           "nf4_kernels_in_one_replay": nf4_in_replay,
           "dense_run_nf4_launches": dense_launches,
           "dense_replay_nf4_kernels": dense_in_replay, "card": card}
    print(json.dumps(rec), flush=True)
    if not (rec["cached_equal_nocache_argmax"] and rec["captured_equal_eager"]
            and rec["nf4_captured_equal_eager"]):
        raise AssertionError("Llama slot-cache decode: captured, eager and no-cache argmax "
                             f"tokens differ: {rec}")
    if not rec["nf4_tokens_equal_dense_dequantized"]:
        raise AssertionError("nf4 Llama tokens differ from the dense dequantized model's")
    if (nf4_launches != per_forward * n_new or nf4_in_replay != per_forward
            or dense_launches or dense_in_replay):
        raise AssertionError(f"nf4 launches {nf4_launches} != {per_forward} x {n_new} forwards, "
                             f"{nf4_in_replay} nf4 kernels in a replay (want {per_forward}), "
                             f"or the dense model launched {dense_launches} "
                             f"({dense_in_replay} in a replay)")
    del qmodel, dense
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def synthetic_checkpoint(torch, cfg, path) -> int:
    """The reference tool's synthetic checkpoint (``tools/bench_inference.py``):
    zeros in fp16, in the reference's param layout (``layer_i`` blocks,
    ``[in, out]`` kernels), sharded at 5 GB with an index. Returns the
    parameter count."""
    from accelerate_tpu_torch.utils.safetensors_io import save_safetensors_checkpoint

    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvd = cfg.num_kv_heads * cfg.head_dim

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float16)

    tree = {"embed_tokens": z(v, e), "final_norm": {"scale": z(e)}, "lm_head": z(v, e)}
    for i in range(cfg.num_layers):
        tree[f"layer_{i}"] = {
            "input_norm": {"scale": z(e)}, "post_attn_norm": {"scale": z(e)},
            "attn": {"q_proj": {"kernel": z(e, e)}, "k_proj": {"kernel": z(e, kvd)},
                     "v_proj": {"kernel": z(e, kvd)}, "o_proj": {"kernel": z(e, e)}},
            "mlp": {"gate_proj": {"kernel": z(e, f)}, "up_proj": {"kernel": z(e, f)},
                    "down_proj": {"kernel": z(f, e)}}}
    save_safetensors_checkpoint(tree, path, max_shard_size="5GB")
    return sum(t.numel() for t in _tensors(tree))


def synthetic_hf_checkpoints(torch, cfg, hf_path, ref_path, seed: int) -> int:
    """One set of seeded non-zero fp16 weights (normal(0.02), norm scales
    around 1) written twice: under Hugging Face's ``LlamaForCausalLM`` names
    and layout (``[out, in]`` weights) into ``hf_path``, and under the
    reference's (``layer_i`` blocks, ``[in, out]`` kernels) into
    ``ref_path``. Non-zero values make a transposed square projection (q_proj
    and o_proj are ``e x e``) change the logits instead of loading unseen.
    Returns the parameter count."""
    from accelerate_tpu_torch.utils.safetensors_io import save_safetensors_checkpoint

    g = torch.Generator().manual_seed(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvd = cfg.num_kv_heads * cfg.head_dim

    def w(*shape, norm=False):
        t = torch.randn(shape, generator=g) * 0.02
        return (t + 1.0 if norm else t).to(torch.float16)

    hf = {"model.embed_tokens.weight": w(v, e), "model.norm.weight": w(e, norm=True),
          "lm_head.weight": w(v, e)}
    ref = {"embed_tokens": hf["model.embed_tokens.weight"],
           "final_norm": {"scale": hf["model.norm.weight"]}, "lm_head": hf["lm_head.weight"]}
    shapes = {"self_attn.q_proj": (e, e), "self_attn.k_proj": (kvd, e),
              "self_attn.v_proj": (kvd, e), "self_attn.o_proj": (e, e),
              "mlp.gate_proj": (f, e), "mlp.up_proj": (f, e), "mlp.down_proj": (e, f)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        hf[pre + "input_layernorm.weight"] = w(e, norm=True)
        hf[pre + "post_attention_layernorm.weight"] = w(e, norm=True)
        blk = {"input_norm": {"scale": hf[pre + "input_layernorm.weight"]},
               "post_attn_norm": {"scale": hf[pre + "post_attention_layernorm.weight"]},
               "attn": {}, "mlp": {}}
        for name, shape in shapes.items():
            hf[pre + name + ".weight"] = w(*shape)
            group, proj = name.split(".")
            blk["attn" if group == "self_attn" else "mlp"][proj] = {
                "kernel": hf[pre + name + ".weight"].T.contiguous()}
        ref[f"layer_{i}"] = blk
    save_safetensors_checkpoint(hf, hf_path, max_shard_size="5GB")
    save_safetensors_checkpoint(ref, ref_path, max_shard_size="5GB")
    return sum(t.numel() for t in hf.values())


def hf_checkpoint_parity(torch, card: str, seed: int) -> dict:
    """Phase 19's Hugging Face variant: Llama-2-7B width at 2 layers, one set
    of seeded non-zero fp16 weights saved under HF's names
    (`synthetic_hf_checkpoints`) and under the reference's; the first loaded
    into a bf16 model on the card through `params_from_hf_llama`, the second
    through `params_from_jax`: every weight and the logits of a 64-token
    prompt are equal, bit for bit."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        params_from_hf_llama,
        params_from_jax,
    )
    from accelerate_tpu_torch.utils.safetensors_io import load_checkpoint_in_model

    cfg = LlamaConfig.llama2_7b(num_layers=2, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                max_position_embeddings=LLAMA_7B_POSITIONS)
    tmp = Path(tempfile.mkdtemp(prefix="hf_llama2_7b_"))
    try:
        t0 = time.perf_counter()
        n_params = synthetic_hf_checkpoints(torch, cfg, tmp / "hf", tmp / "ref", seed)
        write_s = time.perf_counter() - t0
        models, load_s = {}, {}
        for name, mapper in (("hf", lambda flat: params_from_hf_llama(flat, cfg)),
                             ("ref", params_from_jax)):
            t0 = time.perf_counter()
            model = LlamaForCausalLM(cfg, device="meta").to_empty(device="cuda")
            load_checkpoint_in_model(model, tmp / name, mapper=mapper)
            torch.cuda.synchronize()
            load_s[name], models[name] = time.perf_counter() - t0, model
        ids = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            logits = {k: m(ids.to("cuda")) for k, m in models.items()}
        weights_equal = all(torch.equal(a, b) for a, b in zip(models["hf"].state_dict().values(),
                                                              models["ref"].state_dict().values()))
        rec = {"phase": "big_model_hf_checkpoint", "preset": "llama2_7b", "layers": cfg.num_layers,
               "params_b": n_params / 1e9, "checkpoint_write_s": write_s,
               "load_s_hf": load_s["hf"], "load_s_reference": load_s["ref"],
               "weights_equal": weights_equal,
               "logits_equal": torch.equal(logits["hf"], logits["ref"]),
               "logits_finite": bool(torch.isfinite(logits["hf"]).all()),
               "logits_std": logits["hf"].float().std().item(), "card": card}
        print(json.dumps(rec), flush=True)
        if not (rec["weights_equal"] and rec["logits_equal"] and rec["logits_finite"]):
            raise AssertionError(f"HF-named Llama checkpoint: {rec}")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _tensors(tree):
    for value in tree.values():
        yield from (_tensors(value) if isinstance(value, dict) else (value,))


def big_model_inference(torch, card: str) -> list[dict]:
    """The reference's big-model-inference row (``tools/bench_inference.py``,
    its defaults: Llama-2-7B capped at 512 positions, a 64-token prompt of
    ones, 20 new tokens) through the port, on the card. The synthetic fp16
    checkpoint is written once to a temporary directory, removed at the end.
    Rows, built one after another and each freed before the next: fp16 ->
    bf16 (`load_checkpoint_in_model`, cast on the card), nf4, int8, and nf4
    over an int8 KV cache (`load_and_quantize_model` into a model on the
    meta device: each leaf quantized on the card). ``load_s`` is disk to
    card, quantization included (the checkpoint read once before, so every
    row reads it from the page cache); ``s_per_token`` is a second
    `generate`'s wall over its new tokens, prefill included, as the tool
    times it (the first call captured the decode step's graph, as the
    tool's first call compiles; the second replays it, its nf4 launches
    counted: the prefill's by the wrapper, the decode steps' through the
    replays), and ``s_per_token_eager`` the same with every step run
    eagerly (`generation._generate`), whose tokens must be the replayed
    ones. Each line has the bytes bound of a token (the weight bytes and the
    slot cache's bytes, which every decode step reads whole, over the HBM
    rate), the peak memory, a profile of three replays of the decode graph
    (host against device ms, the nf4 kernels in one replay) and one of an
    eager decode step."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.generation import _generate, generate
    from accelerate_tpu_torch.models.kv_cache import make_cache, tree_nbytes
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        load_and_quantize_model,
        quantized_nbytes,
    )
    from accelerate_tpu_torch.utils.safetensors_io import (
        load_checkpoint_in_model,
        load_safetensors_checkpoint,
    )

    bw = peak_rates(torch.cuda.get_device_name(0))[0]
    tmp = Path(tempfile.mkdtemp(prefix="bench_inference_llama2_7b_"))
    lines = []
    try:
        base = LlamaConfig.llama2_7b(num_layers=BIG_MODEL_LAYERS, dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16,
                                     max_position_embeddings=LLAMA_7B_POSITIONS)
        t0 = time.perf_counter()
        n_params = synthetic_checkpoint(torch, base, tmp)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in tmp.iterdir())
        t0 = time.perf_counter()
        load_safetensors_checkpoint(tmp)  # into the page cache; the host read's time
        read_s = time.perf_counter() - t0
        for quant, kv in (("", None), ("nf4", None), ("int8", None), ("nf4", torch.int8)):
            cfg = LlamaConfig.llama2_7b(num_layers=BIG_MODEL_LAYERS, dtype=torch.bfloat16,
                                        param_dtype=torch.bfloat16,
                                        max_position_embeddings=LLAMA_7B_POSITIONS,
                                        kv_cache_dtype=kv)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if quant:
                qcfg = QuantizationConfig(load_in_4bit=quant == "nf4", load_in_8bit=quant == "int8",
                                          compute_dtype=cfg.dtype)
                model = load_and_quantize_model(LlamaForCausalLM(cfg, device="meta"), tmp, qcfg,
                                                mapper=params_from_jax)
            else:
                model = LlamaForCausalLM(cfg, device="meta").to_empty(device="cuda")
                load_checkpoint_in_model(model, tmp, mapper=params_from_jax)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated()
            weight_bytes = quantized_nbytes(model)
            prompt = torch.ones((1, LLAMA_7B_PROMPT), dtype=torch.long, device="cuda")
            generate(model, prompt, LLAMA_7B_NEW_TOKENS)  # warm-up, as the tool's first call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, launches = counted_generate(nm, generation, model, prompt,
                                             LLAMA_7B_NEW_TOKENS)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            replay = profile_record("replay_step", 3,
                                    *profile_steps(torch, generation._CAPTURED[model].graph.replay,
                                                   3), top=5)
            nf4_in_replay = replay_kernels(torch, generation, model, "nf4_matmul_kernel")
            t0 = time.perf_counter()
            eager = _generate(model, prompt, LLAMA_7B_NEW_TOKENS, 0.0, None, None, model.device,
                              capture=False)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            cache = make_cache(model, 1, per_slot=False)
            kv_bytes = tree_nbytes(cache)
            with torch.no_grad():
                model(prompt, 0, cache=cache)
                pos = [LLAMA_7B_PROMPT]

                def decode_step():
                    model(prompt[:, :1], pos[0], cache=cache)
                    pos[0] += 1

                decode_step()
                wall_us, by_name = profile_steps(torch, decode_step, 3)
            prof = profile_record("eager_step", 3, wall_us, by_name, top=5)
            bound_s = (weight_bytes + kv_bytes) / bw
            rec = {"phase": "big_model_inference", "preset": "llama2_7b",
                   "layers": cfg.num_layers, "quant": quant or "fp16", "kv_cache": "int8" if kv
                   else "full", "params_b": n_params / 1e9,
                   "load_s": load_s, "s_per_token": gen_s / LLAMA_7B_NEW_TOKENS,
                   "s_per_token_eager": eager_s / LLAMA_7B_NEW_TOKENS,
                   "captured_equal_eager": torch.equal(out, eager),
                   "new_tokens": LLAMA_7B_NEW_TOKENS, "prompt": LLAMA_7B_PROMPT,
                   "max_positions": LLAMA_7B_POSITIONS,
                   "bound_s_per_token": bound_s, "bound_share": bound_s * LLAMA_7B_NEW_TOKENS / gen_s,
                   "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
                   **({"packed_gb": weight_bytes / 1e9} if quant else {}),
                   "nf4_launches": launches, "nf4_kernels_in_one_replay": nf4_in_replay,
                   "peak_mem_bytes_load": load_peak,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": write_s,
                   "checkpoint_read_s": read_s,
                   "replay_step_host_ms": replay["host_ms_per_step"],
                   "replay_step_device_ms": replay["device_ms_per_step"],
                   "replay_step_idle_share": replay["device_idle_share"],
                   "replay_step_top_kernels_ms": replay["top_kernels_ms_per_step"],
                   "eager_step_host_ms": prof["host_ms_per_step"],
                   "eager_step_device_ms": prof["device_ms_per_step"],
                   "eager_step_idle_share": prof["device_idle_share"],
                   "eager_step_top_kernels_ms": prof["top_kernels_ms_per_step"],
                   "reference_row": "GPT-J-6B fp16: 8.7 s load, 0.05 s/token "
                                    "(BASELINE.md, 2x Titan RTX)", "card": card}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
            if tuple(out.shape) != (1, LLAMA_7B_NEW_TOKENS) or not bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()):
                raise AssertionError(f"big-model {quant or 'fp16'}: bad tokens {out.tolist()}")
            if not rec["captured_equal_eager"]:
                raise AssertionError(f"big-model {quant or 'fp16'}: captured and eager tokens "
                                     "differ")
            per_forward = 7 * cfg.num_layers if quant == "nf4" else 0
            if launches != per_forward * LLAMA_7B_NEW_TOKENS or nf4_in_replay != per_forward:
                raise AssertionError(f"big-model {quant or 'fp16'}: the timed generate launched "
                                     f"the nf4 kernel {launches} times, {nf4_in_replay} in one "
                                     f"replay; want {per_forward} a forward")
            generation.release_captured(model)
            del model, cache, out, eager
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return lines


# the prefix-cached serving phase's traffic: a shared system prompt, then a
# unique suffix of 16-96 tokens per request
PREFIX_SYSTEM_TOKENS = 384
PREFIX_BUCKETS = (32, 128, 512)


def first_divergences(torch, model, prompts, got, want, sampled) -> list[dict]:
    """Where streams ``got`` and ``want`` of the same requests part: the
    request, its first differing position and, for a greedy request, the
    top-2 margin of ``model``'s logits there (one full forward over the
    prompt and the tokens both streams share): a near-tie, or a fault."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        t = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), min(len(a), len(b)))
        rec = {"request": i, "position": t, "sampled": bool(sampled[i])}
        if not sampled[i]:
            with torch.no_grad():
                logits = model(torch.tensor([prompts[i] + a[:t]], device="cuda"))[:, -1]
            rec["top2_margin"] = top2_margin(torch, logits)
        out.append(rec)
    return out


def prefix_serving(torch, np, seed: int, card: str) -> list[dict]:
    """GPT-2 small, 16 slots, depth 2, admit 1, ``prompt_buckets``
    PREFIX_BUCKETS, ``block_tokens`` 16: 48 requests, each a shared seeded
    384-token system prompt plus a unique 16-96-token suffix, 64 new tokens,
    every second one sampled; through the slot engine and the paged fused
    engine, each with the prefix cache off and on. In every run with the
    cache, at least 32 hits (the first 16 admissions precede every
    retirement, so every later one can hit) of 384 tokens each; in the paged
    fused engine, the paged kernel launched n_layer times a decode step,
    counted through the replays. First fp32 (TF32 off): the streams are
    equal with the cache on and off, sampled ones too (`fp32_prefix_serving`
    lines). Then bf16 (`bf16_prefix_serving` lines: tokens/s, TTFT with hits
    and misses apart, ITL p50/p99, the admissions' host share of the wall,
    the tokens prefilled, the prefix counters, and how many streams equal
    the cache-off run's, with where any part: a cached suffix prefills over
    the gathered prefix, at other shapes than the cold prompt, so bf16 may
    round it differently). Then the nf4 engine (paged fused) with the cache
    on, once: the nf4 kernel beside the paged one."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        PagedKVConfig,
        PrefixCacheConfig,
        Request,
        SamplingParams,
        ServingEngine,
    )

    rng = np.random.default_rng(seed + 20)
    system = rng.integers(0, 50257, PREFIX_SYSTEM_TOKENS).tolist()
    prompts = [system + rng.integers(0, 50257, int(n)).tolist() for n in rng.integers(16, 97, 48)]
    sampled = [i % 2 == 1 for i in range(len(prompts))]

    def requests():
        return [Request(prompt=p, params=SamplingParams(
                    max_new_tokens=64, temperature=0.8 if sampled[i] else 0.0,
                    top_k=50 if sampled[i] else None, seed=i))
                for i, p in enumerate(prompts)]

    modes = {"slot": {}, "paged_fused": dict(paged_kv=PagedKVConfig(block_tokens=16),
                                             paged_attention="fused")}
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        dtype_name = "fp32" if dtype == torch.float32 else "bf16"
        model = GPT2LMHead(GPT2Config.small(dtype=dtype, param_dtype=dtype), device="cuda",
                           seed=seed)
        n_layer = model.config.n_layer

        def engine(mode, cache, **kw):
            return ServingEngine(model, max_concurrency=16, prompt_buckets=PREFIX_BUCKETS,
                                 pipeline_depth=2, admit_batch=1,
                                 prefix_cache=PrefixCacheConfig(block_tokens=16) if cache else False,
                                 **modes[mode], **kw)

        engine("paged_fused", True).run(requests()[:4])  # warm-up: allocator pools, cuBLAS
        for mode in modes:
            streams = {}
            for cache in (False, True):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                eng = engine(mode, cache)
                admissions = count_admissions(eng)
                paged_decode_attention.launches = 0
                t0 = time.perf_counter()
                outs = eng.run(requests())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                m = eng.metrics
                streams[cache] = [o.tokens for o in outs]
                launches = replay_launches(eng, "paged_decode_attention",
                                           paged_decode_attention.launches)
                parted = (first_divergences(torch, model, prompts, streams[True], streams[False],
                                            sampled) if cache else [])
                line = serving_line(
                    eng, outs, wall, launches, torch.cuda.max_memory_allocated(), card,
                    phase=f"{dtype_name}_prefix_serving", mode=mode, prefix_cache=cache,
                    max_new_tokens=64, admission_forwards=admissions[0],
                    admission_host_s=admissions[1], admission_share_of_wall=admissions[1] / wall,
                    prefill_tokens=m.prefill_tokens.value, prefix_hits=m.prefix_hits.value,
                    prefix_misses=m.prefix_misses.value,
                    prefix_tokens_reused=m.prefix_tokens_reused.value,
                    prefix_blocks_donated=m.prefix_blocks_donated.value,
                    prefix_evictions=m.prefix_evictions.value,
                    ttft_hit_p50_s=m.ttft_hit_s.quantile(0.5),
                    ttft_miss_p50_s=m.ttft_miss_s.quantile(0.5),
                    prefix_pool_bytes=eng.prefix_cache.pool_nbytes if cache else 0,
                    **({"streams_equal_cache_off": len(outs) - len(parted),
                        "streams_parted": parted} if cache else {}))
                print(json.dumps(line), flush=True)
                lines.append(line)
                if any(o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64 for o in outs):
                    raise AssertionError(f"{dtype_name} prefix serving {mode}, cache {cache}: a "
                                         "request did not finish with 64 tokens")
                if cache and not (m.prefix_hits.value >= 32 and m.prefix_tokens_reused.value
                                  == PREFIX_SYSTEM_TOKENS * m.prefix_hits.value):
                    raise AssertionError(f"{dtype_name} prefix serving {mode}: "
                                         f"{m.prefix_hits.value} hits, "
                                         f"{m.prefix_tokens_reused.value} tokens reused")
                steps = m.decode_steps.value
                if mode == "paged_fused" and (launches != n_layer * steps or steps == 0):
                    raise AssertionError(f"{dtype_name} prefix serving {mode}, cache {cache}: "
                                         f"paged kernel launches {launches} != n_layer x "
                                         "decode steps")
                if cache and dtype == torch.float32 and parted:
                    raise AssertionError(f"fp32 prefix serving {mode}: streams differ with the "
                                         f"cache on and off: {parted}")
                del eng
        if dtype == torch.float32:
            del model
            gc.collect()
            torch.cuda.empty_cache()

    # the bf16 nf4 engine with the cache on: kernel #11 beside kernel #1
    gc.collect()
    torch.cuda.empty_cache()
    eng = engine("paged_fused", True, weight_quant="nf4")
    nm.nf4_matmul.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nf4 = replay_launches(eng, "nf4_matmul", nm.nf4_matmul.launches)
    paged = replay_launches(eng, "paged_decode_attention", paged_decode_attention.launches)
    m = eng.metrics
    line = serving_line(eng, outs, wall, paged, torch.cuda.max_memory_allocated(), card,
                        phase="bf16_prefix_serving_nf4", mode="paged_fused", prefix_cache=True,
                        nf4_launches=nf4, prefix_hits=m.prefix_hits.value,
                        prefix_tokens_reused=m.prefix_tokens_reused.value,
                        prefill_tokens=m.prefill_tokens.value)
    print(json.dumps(line), flush=True)
    lines.append(line)
    if not (nf4 > 0 and paged == n_layer * m.decode_steps.value > 0 and m.prefix_hits.value >= 32):
        raise AssertionError(f"nf4 prefix serving: nf4 launches {nf4}, paged {paged}, "
                             f"{m.prefix_hits.value} hits")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return lines


def spec_prompts(np, seed: int, n: int = 32) -> list[list[int]]:
    """``n`` prompts of 64-256 tokens, each a seeded 32-token pattern
    repeated: the n-gram drafter's prompt-lookup has matches from the first
    verify on."""
    rng = np.random.default_rng(seed + 21)
    pattern = rng.integers(0, 50257, 32).tolist()
    return [(pattern * 8)[:int(k)] for k in rng.integers(64, 257, n)]


def spec_serving(torch, np, seed: int, card: str) -> list[dict]:
    """GPT-2 small, 16 slots, depth 2, ``prompt_buckets`` PREFIX_BUCKETS: 32
    greedy requests over `spec_prompts`, 64 new tokens, with
    ``speculation=4`` (the n-gram drafter) against off, in the slot and the
    paged fused engines. First fp32 (TF32 off): spec-on streams equal
    spec-off, and the verify step ran from its graph (one replay a
    dispatch). Then bf16: one line each with tokens/s, ITL, the verify
    steps' accepted tokens per forward and whether the streams equal
    spec-off's (the paged fused engine's plain step attends through kernel
    #1 and its verify step over the gathered view, which round bf16
    differently); then a profiler window over 16 steps of each spec engine:
    host against device ms per dispatch."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        PagedKVConfig,
        Request,
        SamplingParams,
        ServingEngine,
    )

    prompts = spec_prompts(np, seed)
    modes = {"slot": {}, "paged_fused": dict(paged_kv=PagedKVConfig(block_tokens=16),
                                             paged_attention="fused")}

    def requests():
        return [Request(prompt=p, params=SamplingParams(max_new_tokens=64)) for p in prompts]

    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        dtype_name = str(dtype).removeprefix("torch.")
        model = GPT2LMHead(GPT2Config.small(dtype=dtype, param_dtype=dtype), device="cuda",
                           seed=seed)
        for mode in modes:
            streams = {}
            for spec in (None, 4):
                gc.collect()
                torch.cuda.empty_cache()
                eng = ServingEngine(model, max_concurrency=16, prompt_buckets=PREFIX_BUCKETS,
                                    pipeline_depth=2, speculation=spec, **modes[mode])
                t0 = time.perf_counter()
                outs = eng.run(requests())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                streams[spec] = [o.tokens for o in outs]
                m = eng.metrics
                snap = m.snapshot()
                line = serving_line(
                    eng, outs, wall, 0, torch.cuda.max_memory_allocated(), card,
                    phase=f"{dtype_name}_spec_serving", mode=mode, speculation=spec or 0,
                    graph=eng._graph is not None, spec_forwards=m.spec_forwards.value,
                    spec_tokens=m.spec_tokens.value, spec_proposed=m.spec_proposed.value,
                    spec_accepted=m.spec_accepted.value,
                    accepted_tokens_per_forward=snap["serving/accepted_tokens_per_forward"],
                    accept_len_mean=m.spec_accept_len.mean,
                    **({"streams_equal_spec_off": sum(a == b for a, b in zip(streams[spec],
                                                                            streams[None])),
                        "streams_parted": first_divergences(
                            torch, model, prompts, streams[spec], streams[None],
                            [False] * len(prompts))} if spec else {}))
                print(json.dumps(line), flush=True)
                lines.append(line)
                if any(o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64 for o in outs):
                    raise AssertionError(f"{dtype_name} spec serving {mode}: a request did not "
                                         "finish with 64 tokens")
                if spec and not (eng._graph is not None and m.spec_forwards.value
                                 == m.decode_dispatches.value > 0
                                 and m.spec_tokens.value == m.tokens_generated.value - len(outs)
                                 and m.spec_accepted.value <= m.spec_proposed.value):
                    raise AssertionError(f"{dtype_name} spec serving {mode}: the verify step did "
                                         f"not replay from its graph, or its counts disagree: "
                                         f"{line}")
                if spec and dtype == torch.bfloat16:
                    lines.append(profile_decode(torch, ServingEngine(
                        model, max_concurrency=16, prompt_buckets=PREFIX_BUCKETS,
                        pipeline_depth=2, speculation=spec, **modes[mode]), requests()[:16],
                        phase="bf16_spec_decode_profile"))
                    lines[-1].update(mode=mode, card=card)
                    print(json.dumps(lines[-1]), flush=True)
                del eng
            if dtype == torch.float32 and streams[4] != streams[None]:
                diff = sum(a != b for a, b in zip(streams[4], streams[None]))
                raise AssertionError(f"fp32 spec serving {mode}: {diff} streams differ spec-on "
                                     "and spec-off")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return lines


def llama_fused_parity(torch, np, seed: int, card: str) -> dict:
    """One fp32 train step (TF32 off) of the Mistral-7B-width model cut to 2
    layers, batch 1 x 2048, with `llama_loss_fn_fused` (the untied head on
    the fused-CE kernels at e 4096) and one with `llama_loss_fn`, from the
    same weights and batch: loss and global gradient norm agree; each
    fused-CE kernel ran once in the fused step and never in the other."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn, llama_loss_fn_fused
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 32000, (1, 2048))).to("cuda")
    out = {}
    for fn in (llama_loss_fn, llama_loss_fn_fused):
        model = LlamaForCausalLM(mistral_config(torch, num_layers=2, dtype=torch.float32),
                                 seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[fn.__name__] = (loss, step.grad_norm.item(), fused_ce_counts())
        del model, acc, step
        gc.collect()
        torch.cuda.empty_cache()
    (loss_p, norm_p, counts_p), (loss_f, norm_f, counts) = out["llama_loss_fn"], \
        out["llama_loss_fn_fused"]
    rec = {"phase": "fp32_llama_fused_ce_parity", "model": "mistral-7b-width, 2 layers",
           "batch": 1, "seq": 2048, "loss_plain": loss_p, "loss_fused": loss_f,
           "loss_abs_diff": abs(loss_f - loss_p), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_norm_plain": norm_p, "grad_norm_fused": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_p) / norm_p,
           "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL, "launches": counts,
           "launches_plain": counts_p, "card": card}
    print(json.dumps(rec), flush=True)
    if not (abs(loss_f - loss_p) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
        raise AssertionError(f"fp32 Llama fused step: loss {loss_f} vs plain {loss_p}")
    if not abs(norm_f - norm_p) <= TRAIN_GRAD_NORM_RTOL * norm_p:
        raise AssertionError(f"fp32 Llama fused step: grad norm {norm_f} vs plain {norm_p}")
    if counts != {n: 1 for n in FUSED_CE_REPLACES} or any(counts_p.values()):
        raise AssertionError(f"fp32 Llama fused step launches {counts} (plain {counts_p})")
    return rec



# the reliability phase's serving child: builds phase 5's model in fp32 from
# the seed, a slot engine and a paged fused engine at depth 2, each with its
# own journal, submits the requests to both, steps both ``steps`` times,
# says READY and waits to be killed
RELIABILITY_CHILD = """
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine
seed, steps, spec = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
engines = [ServingEngine(model, max_concurrency=16, prompt_buckets=tuple(spec["buckets"]),
                         pipeline_depth=2, journal=path, **kw)
           for path, kw in zip(spec["journals"], spec["modes"])]
for engine in engines:
    for prompt, p in spec["requests"]:
        assert engine.submit(Request(prompt, SamplingParams(**p))).accepted
for _ in range(steps):
    for engine in engines:
        engine.step()
torch.cuda.synchronize()
print("READY", flush=True)
time.sleep(600)
"""

# the two engine modes of the reliability phase: the paged fused engine
# (kernel #1 in its decode graph) and the slot engine (the default)
RELIABILITY_MODES = {"paged_fused": {"paged_kv": True, "paged_attention": "fused"},
                     "slot": {}}


def health_flag_cost(torch, b: int, vocab: int, iters: int = 50) -> dict:
    """The health flag's device work in one decode iteration, alone: the ops
    `ServingEngine._decode_step` adds for it (poison the marked rows' fp32
    logits with NaN, ``ok = isfinite(logits).all(-1)``, the row masks and
    the health row of the output plane) at ``[b, vocab]``, in a profiler
    window of ``iters`` runs: device us per iteration by kernel name, and
    the bytes bound of the pass (the logits read once)."""
    logits = torch.randn(b, vocab, device="cuda")
    poison = torch.zeros(b, dtype=torch.bool, device="cuda")
    finished = torch.zeros(b, dtype=torch.bool, device="cuda")
    out = torch.zeros(3, b, dtype=torch.long, device="cuda")

    def flag():
        live = ~finished
        last = logits.masked_fill(poison[:, None], float("nan"))
        ok = torch.isfinite(last).all(dim=-1)
        healthy = live & ok
        out[2].copy_(ok | ~live)
        return last, healthy

    for _ in range(3):
        flag()
    wall_us, by_name = profile_steps(torch, flag, iters)
    bw = peak_rates(torch.cuda.get_device_name(0))[0]
    kernels: dict[str, float] = {}
    for n, us in by_name.items():  # names cut to 90 characters may meet: add them up
        kernels[n[:90]] = kernels.get(n[:90], 0.0) + us / iters
    return {"device_us_per_iteration": sum(by_name.values()) / iters,
            "kernels": len(by_name), "kernels_us_per_iteration": kernels,
            "bound_us": b * vocab * 4 / bw * 1e6, "shape": [b, vocab]}


def reliability_serving(torch, np, seed: int, card: str, prompts: list[list[int]],
                        phase5_profile: dict) -> list[dict]:
    """Phase 23: crash-exact serving on the card. GPT-2 small at full width
    and depth, 16 slots, depth 2, every decode step a graph replay, phase
    5's 48 requests (every second sampled), in the paged fused and the slot
    engine. fp32 (TF32 off): (a) a child process serving them with a
    journal in both modes is killed with SIGKILL mid-run, and fresh engines
    resume from the journals: completed plus resumed streams equal an
    uninterrupted run's, token for token; (b) the same for an in-process
    snapshot and restore; (c) one request poisoned once (its stream is
    equal) and another twice (``error``), the other 46 streams equal, each
    poisoning a real `FaultInjector` spec aimed at the request's slot; (d)
    deadline expiry and drain. Then bf16, phase 5's fused engine at (2, 1):
    tokens/s, TTFT and ITL with the journal off, with fsync ``never`` and
    ``accept``, the journal's share of the wall; a profiler window over the
    journaled engine's decode steps against phase 5's; and the health
    flag's kernels alone at the decode shape."""
    import shutil
    import signal
    import tempfile

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject
    from accelerate_tpu_torch.serving import (
        FINISH_ERROR,
        FINISH_LENGTH,
        REJECT_DEADLINE,
        REJECT_DRAINING,
        PagedKVConfig,
        Request,
        RequestJournal,
        SamplingParams,
        ServingEngine,
    )

    t_phase = time.perf_counter()
    params = [dict(max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                   top_k=50 if i % 2 else None, seed=i) for i in range(len(prompts))]

    def requests():
        return [Request(prompt=list(p), params=SamplingParams(**kw))
                for p, kw in zip(prompts, params)]

    def build(model, mode, **kw):
        engine = ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS,
                               pipeline_depth=2, **RELIABILITY_MODES[mode], **kw)
        if engine._graph is None:
            raise AssertionError(f"reliability {mode}: the engine captured no decode graph")
        return engine

    def drive(engine, outputs):
        while engine.has_work:
            for out in engine.step():
                outputs[out.request_id] = out
        return outputs

    def streams(outputs):
        return [outputs[i].tokens for i in range(len(prompts))]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_reliability_"))
    lines = []
    try:
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
        want = {}
        for mode in RELIABILITY_MODES:
            engine = build(model, mode)
            want[mode] = streams({o.request_id: o for o in engine.run(requests())})
            if engine.metrics.decode_dispatches.value == 0:
                raise AssertionError(f"reliability {mode}: no decode replay ran")
            del engine

        # (a) SIGKILL of a serving child, then resume from its journals
        journals = {mode: tmp / f"{mode}.journal" for mode in RELIABILITY_MODES}
        spec = {"buckets": list(BUCKETS), "journals": [str(p) for p in journals.values()],
                "modes": list(RELIABILITY_MODES.values()),
                "requests": [[p, kw] for p, kw in zip(prompts, params)]}
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", RELIABILITY_CHILD, str(seed), "90",
                                  json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE, text=True)
        try:
            ready = child.stdout.readline().strip()
            child.send_signal(signal.SIGKILL)
            code = child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        child_s = time.perf_counter() - t0
        if ready != "READY" or code != -signal.SIGKILL:
            raise AssertionError(f"reliability: the serving child said {ready!r} and exited "
                                 f"{code}, not READY and -SIGKILL")
        for mode, path in journals.items():
            scan = RequestJournal.scan(path)
            engine = build(model, mode, journal=path)
            t0 = time.perf_counter()
            report = engine.resume()
            resume_s = time.perf_counter() - t0
            final = drive(engine, dict(report.completed))
            got = streams(final)
            line = {"phase": "fp32_reliability_sigkill", "mode": mode, "child_s": child_s,
                    "child_exit": code, "journal_bytes": path.stat().st_size,
                    "journal_records": scan.records, "torn_tail_bytes": scan.truncated_tail_bytes,
                    "completed": len(report.completed), "resumed": len(report.resumed),
                    "restored": len(report.restored), "resume_s": resume_s,
                    "replayed_tokens": engine.metrics.replayed_tokens.value,
                    "decode_replays": engine.metrics.decode_dispatches.value,
                    "streams_equal": sum(a == b for a, b in zip(got, want[mode])),
                    "requests": len(prompts), "card": card}
            if got != want[mode]:
                line["divergences"] = first_divergences(
                    torch, model, prompts, got, want[mode], [p["temperature"] > 0 for p in params])
            print(json.dumps(line), flush=True)
            lines.append(line)
            if got != want[mode] or not report.resumed or not report.completed:
                raise AssertionError(f"reliability {mode}: resume after SIGKILL gave other streams "
                                     f"than the uninterrupted run, or resumed nothing: {line}")
            del engine

        # (b) in-process snapshot, then restore in a fresh engine
        for mode in RELIABILITY_MODES:
            engine = build(model, mode)
            for r in requests():
                engine.submit(r)
            outputs = {}
            for _ in range(30):
                for out in engine.step():
                    outputs[out.request_id] = out
            snap = tmp / f"{mode}.snap"
            for out in engine.snapshot(snap):
                outputs[out.request_id] = out
            del engine
            fresh = build(model, mode)
            report = fresh.resume(snap)
            got = streams(drive(fresh, outputs))
            line = {"phase": "fp32_reliability_snapshot", "mode": mode,
                    "snapshot_bytes": snap.stat().st_size, "resumed": len(report.resumed),
                    "restored": len(report.restored),
                    "streams_equal": sum(a == b for a, b in zip(got, want[mode])),
                    "requests": len(prompts), "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if got != want[mode] or not report.resumed:
                raise AssertionError(f"reliability {mode}: snapshot and restore gave other "
                                     f"streams than the uninterrupted run: {line}")
            del fresh

        # (c) one request poisoned once, another twice, by FaultInjector
        # specs aimed at the slot each holds at that step
        once_rid, twice_rid = 5, 9
        for mode in RELIABILITY_MODES:
            engine = build(model, mode)
            for r in requests():
                engine.submit(r)
            outputs, hits, step = {}, {once_rid: 0, twice_rid: 0}, 0
            targets = {once_rid: 1, twice_rid: 2}
            injectors = []
            while engine.has_work:
                specs = []
                for rid, n in targets.items():
                    slot = next((s for s, o in enumerate(engine._slot_out)
                                 if o is not None and o.request_id == rid
                                 and 4 <= len(o.tokens) <= 48), None)
                    retries = engine._slot_req[slot].retries if slot is not None else None
                    if slot is not None and hits[rid] < n and retries == hits[rid]:
                        specs.append(FaultSpec.poison(at_steps=(0,), slots=(slot,)))
                        hits[rid] += 1
                inj = FaultInjector(seed=seed, specs=specs)
                injectors.append(inj)
                with inject(inj):
                    for out in engine.step():
                        outputs[out.request_id] = out
                step += 1
            got = streams(outputs)
            others = [i for i in range(len(prompts)) if i != twice_rid]
            fired = sum(len(i.fired) for i in injectors)
            line = {"phase": "fp32_reliability_poison", "mode": mode, "poisonings": fired,
                    "steps_poisoned": engine.metrics.steps_poisoned.value,
                    "requests_retried": engine.metrics.requests_retried.value,
                    "poison_uploads": engine.poison_uploads,
                    "twice_reason": outputs[twice_rid].finish_reason,
                    "twice_tokens": len(outputs[twice_rid].tokens),
                    "once_stream_equal": got[once_rid] == want[mode][once_rid],
                    "others_equal": sum(got[i] == want[mode][i] for i in others),
                    "others": len(others), "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if (fired != 3 or outputs[twice_rid].finish_reason != FINISH_ERROR
                    or any(got[i] != want[mode][i] for i in others)
                    or engine.metrics.requests_retried.value != 2
                    or got[twice_rid] != want[mode][twice_rid][:len(got[twice_rid])]):
                raise AssertionError(f"reliability {mode}: the poisoned run is not the "
                                     f"reference's quarantine: {line}")
            del engine

        # (d) deadline expiry and drain
        for mode in RELIABILITY_MODES:
            engine = build(model, mode)
            short = [Request(prompt=list(p), params=SamplingParams(max_new_tokens=8))
                     for p in prompts[:20]]
            for i, r in enumerate(short):
                if i >= 16:
                    r.deadline_s = 0.0  # queued behind 16 busy slots: expires
                engine.submit(r)
            engine.begin_drain()
            refused = engine.submit(Request(prompt=list(prompts[0]),
                                            params=SamplingParams(max_new_tokens=8)))
            outs = {}
            while engine.has_work:
                for out in engine.step():
                    outs[out.request_id] = out
            engine.end_drain()
            reasons = [outs[i].finish_reason for i in range(20)]
            line = {"phase": "fp32_reliability_deadline_drain", "mode": mode,
                    "finished": reasons.count(FINISH_LENGTH),
                    "expired": reasons.count(f"rejected:{REJECT_DEADLINE}"),
                    "requests_expired": engine.metrics.requests_expired.value,
                    "draining_reject": refused.reason, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if (line["finished"] != 16 or line["expired"] != 4
                    or line["requests_expired"] != 4 or refused.reason != REJECT_DRAINING):
                raise AssertionError(f"reliability {mode}: deadlines or drain: {line}")
            del engine
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # bf16: the journal's cost, and the decode replay with the health flag
        model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                           device="cuda", seed=seed)

        def fused(**kw):
            return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                                 paged_attention="fused", max_concurrency=16,
                                 prompt_buckets=BUCKETS, pipeline_depth=2, **kw)

        fused().run(requests()[:4])  # warm-up
        runs, rates = {}, {}
        # in turns, so drift in the host's pace falls on each policy alike
        for turn, fsync in enumerate((None, "never", "accept", "accept", "never", None)):
            gc.collect()
            torch.cuda.synchronize()
            journal = (RequestJournal(tmp / f"bf16_{fsync}.journal", fsync=fsync)
                       if fsync else None)
            engine = fused(journal=journal)
            t0 = time.perf_counter()
            outs = engine.run(requests())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = engine.metrics
            runs.setdefault(fsync, []).append([o.tokens for o in outs])
            rates.setdefault(fsync or "off", []).append(m.tokens_generated.value / wall)
            line = {"phase": "bf16_reliability_journal", "turn": turn, "fsync": fsync or "off",
                    "pipeline_depth": 2, "tokens_per_sync": 1, "requests": len(outs),
                    "generated_tokens": m.tokens_generated.value, "wall_s": wall,
                    "tokens_per_s": m.tokens_generated.value / wall,
                    "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
                    "itl_p50_s": m.inter_token_s.quantile(0.5),
                    "itl_p99_s": m.inter_token_s.quantile(0.99),
                    "journal_records": m.journal_records.value,
                    "journal_bytes": m.journal_bytes.value,
                    "journal_s": journal.append_s if journal else 0.0,
                    "journal_share_of_wall": (journal.append_s / wall) if journal else 0.0,
                    "decode_replays": m.decode_dispatches.value, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if journal is not None:
                journal.close()
            del engine
        if any(r != runs[None][0] for rs in runs.values() for r in rs):
            raise AssertionError("bf16 reliability: the journal changed the token streams")
        off = statistics.mean(rates["off"])
        line = {"phase": "bf16_reliability_journal_summary",
                "tokens_per_s_mean": {k: statistics.mean(v) for k, v in rates.items()},
                "tokens_per_s_vs_off": {k: statistics.mean(v) / off - 1 for k, v in rates.items()},
                "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        long_requests = [Request(prompt=list(p), params=SamplingParams(max_new_tokens=64))
                         for p in prompts[:16]]
        rec = profile_decode(torch, fused(journal=RequestJournal(tmp / "bf16_profile.journal")),
                             long_requests, phase="bf16_reliability_decode_profile")
        rec["phase5_device_ms_per_iteration"] = phase5_profile["device_ms_per_iteration"]
        rec["phase5_host_ms_per_iteration"] = phase5_profile["host_ms_per_iteration"]
        rec["health_flag"] = health_flag_cost(torch, 16, model.config.vocab_size)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "reliability_phase_s", "seconds": time.perf_counter() - t_phase}),
          flush=True)
    return lines


def observability_serving(torch, np, seed: int, card: str, prompts: list[list[int]]) -> dict:
    """Phase 24: observable, self-healing serving on the card. GPT-2 small at
    full width and depth, 16 slots, depth 2, phase 5's 48 requests (every
    second sampled), in the paged fused engine (kernel #1 in its decode
    graph) and the slot engine. fp32 (TF32 off): (a) a traced engine's
    streams equal an untraced one's, its trace validates with nothing
    dropped, every request runs from submit to one terminal event, every
    dispatch pairs with a fetch by seq, and the exported file reloads; (b)
    `EngineSupervisor` with a journal under one `FaultInjector`: a hang past
    the stall timeout, a device error and a poison storm give the restarts
    ``stall``, ``device_error`` and ``nan_storm``, the 48 streams equal the
    uninterrupted run's, the first step is no stall, each restart's seconds
    and the allocated memory after the restarts are reported; an exhausted
    budget rejects with ``unhealthy`` and raises. Then bf16, the fused
    engine at (2, 1): (c) a brownout over a burst of priorities 0-3, level,
    sheds, clamped budgets and exit per step; (d) off, traced and
    traced+telemetry+anomaly in turns (off, traced, full, full, traced,
    off): tokens/s, TTFT, ITL, events a second and host us an event, the
    step phases against the step wall, the device gauges against the
    allocator's peak; and a profiler window with ``annotate=True``, whose
    ``step`` ranges enclose the decode graph's launches. Returns the traced
    fused run's kernel #1 launches and the phase's lines."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        REJECT_OVERLOAD,
        REJECT_UNHEALTHY,
        AnomalyMonitor,
        EngineSupervisor,
        EngineUnhealthyError,
        PagedKVConfig,
        Request,
        SamplingParams,
        ServingEngine,
        SupervisorConfig,
        TelemetryConfig,
        TelemetryExporter,
        Tracer,
    )
    from accelerate_tpu_torch.serving.trace import (
        EV_DISPATCH,
        EV_FETCH,
        EV_QUEUED,
        EV_RESTART,
        EV_SUBMIT,
        TERMINAL_KINDS,
        load_exported,
        request_streams,
        validate,
    )

    t_phase = time.perf_counter()
    params = [dict(max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                   top_k=50 if i % 2 else None, seed=i) for i in range(len(prompts))]

    def requests(priorities=None):
        return [Request(prompt=list(p), params=SamplingParams(**kw),
                        priority=0 if priorities is None else priorities[i])
                for i, (p, kw) in enumerate(zip(prompts, params))]

    def build(model, mode, **kw):
        engine = ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS,
                               pipeline_depth=2, **RELIABILITY_MODES[mode], **kw)
        if engine._graph is None:
            raise AssertionError(f"observability {mode}: the engine captured no decode graph")
        return engine

    def streams(outputs):
        return [outputs[i].tokens for i in range(len(prompts))]

    def settle():
        gc.collect()
        torch.cuda.synchronize()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_observability_"))
    lines, launches = [], 0
    try:
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
        for mode in RELIABILITY_MODES:
            # (a) the trace gates
            want = streams({o.request_id: o for o in build(model, mode).run(requests())})
            settle()
            tracer = Tracer()
            engine = build(model, mode, tracer=tracer)
            reset_counts(fa)
            t0 = time.perf_counter()
            outs = {o.request_id: o for o in engine.run(requests())}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = replay_launches(engine, "paged_decode_attention",
                                           fa.paged_decode_attention.launches)
            if mode == "paged_fused":
                launches = run_launches
            events = tracer.events()
            report = tracer.validate()
            per_request = request_streams(events)
            complete = sum(s[0].kind == EV_SUBMIT and s[-1].kind in TERMINAL_KINDS
                           for s in per_request.values())
            dispatched = {e.data["seq"] for e in events if e.kind == EV_DISPATCH}
            fetched = [e.data["seq"] for e in events if e.kind == EV_FETCH]
            summary = tracer.export(tmp / f"{mode}.trace.json")
            back, dropped = load_exported(json.loads((tmp / f"{mode}.trace.json").read_text()))
            reloaded = validate(back, dropped=dropped)
            line = {"phase": "fp32_observability_trace", "mode": mode, "requests": len(outs),
                    "streams_equal_untraced": sum(a == b for a, b in zip(streams(outs), want)),
                    "events": len(events), "dropped": tracer.dropped, "clean": report["clean"],
                    "anomalies": report["anomalies"][:4], "requests_traced": len(per_request),
                    "submit_to_terminal": complete, "dispatches": len(dispatched),
                    "fetches": len(fetched), "fetch_seqs_equal_dispatch_seqs":
                        sorted(fetched) == sorted(dispatched),
                    "export_trace_events": summary["trace_events"],
                    "export_bytes": (tmp / f"{mode}.trace.json").stat().st_size,
                    "reloaded_events": len(back), "reloaded_clean": reloaded["clean"],
                    "wall_s": wall, "kernel_launches": run_launches,
                    "compile_count": engine.metrics.compile_count.value, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if (line["streams_equal_untraced"] != len(prompts) or not report["clean"]
                    or tracer.dropped or complete != len(prompts)
                    or not line["fetch_seqs_equal_dispatch_seqs"] or len(back) != len(events)
                    or not reloaded["clean"]
                    or (mode == "paged_fused") != (run_launches > 0)):
                raise AssertionError(f"observability {mode}: a trace gate failed: {line}")
            del engine, tracer, events, back
            settle()

            # (b) supervision: stall, device error and storm restarts, then
            # an exhausted budget
            builds: list[float] = []

            def factory(**kw):
                t_build = time.perf_counter()
                engine = build(model, mode, **kw)
                builds.append(time.perf_counter() - t_build)
                return engine

            settle()
            mem_before = torch.cuda.memory_allocated()
            tracer = Tracer()
            config = SupervisorConfig(stall_timeout_s=1.0, storm_quarantines=2,
                                      storm_window_steps=8, max_restarts=3)
            t0 = time.perf_counter()
            sup = EngineSupervisor(factory, tmp / f"{mode}.journal", config=config, tracer=tracer)
            construct_s = time.perf_counter() - t0
            compiles_built = sup.metrics.compile_count.value
            mem_one = torch.cuda.memory_allocated() - mem_before
            # dispatches 0-20 or so are the first step's admissions (runs
            # of one bucket) and decode: the faults come after it
            inj = FaultInjector(seed=seed, specs=[
                FaultSpec.step_hang(at_calls=(30,), hang_s=1.5),
                FaultSpec.device_error(at_calls=(100,)),
                FaultSpec.poison(at_steps=(150,))])  # every active slot: a storm
            got, restart_steps, first_step = {}, [], None
            with inject(inj):
                for r in requests():
                    if not sup.submit(r).accepted:
                        raise AssertionError(f"observability {mode}: a submit was rejected")
                while sup.has_work:
                    before = sup.restarts
                    t_step = time.perf_counter()
                    for o in sup.step():
                        if o.request_id in got:
                            raise AssertionError(f"observability {mode}: request "
                                                 f"{o.request_id} delivered twice")
                        got[o.request_id] = o
                    step_s = time.perf_counter() - t_step
                    if first_step is None:
                        first_step = {"step_s": step_s,
                                      "stalled": sup.heartbeat()["stalled"],
                                      "stalls": sup.metrics.supervisor_stalls.value}
                    if sup.restarts != before:
                        restart_steps.append(step_s)
            reasons = [e.data["reason"] for e in tracer.events() if e.kind == EV_RESTART]
            report = tracer.validate()
            rebuilds = builds[1:]
            sup.close()
            del sup
            settle()
            mem_after = torch.cuda.memory_allocated() - mem_before
            line = {"phase": "fp32_observability_supervisor", "mode": mode,
                    "restart_reasons": reasons, "restarts": len(reasons),
                    "streams_equal_uninterrupted": sum(
                        got[i].tokens == want[i] for i in range(len(prompts)) if i in got),
                    "finished": sum(o.finish_reason == FINISH_LENGTH for o in got.values()),
                    "faults_fired": [(e.scope, e.call_index, e.kind) for e in inj.fired],
                    "first_step": first_step, "construct_s": construct_s,
                    "compile_count_after_construction": compiles_built,
                    "restart_step_s": restart_steps, "rebuild_s": rebuilds,
                    "resume_and_rest_s": [s - b for s, b in zip(restart_steps, rebuilds)],
                    "memory_allocated_one_engine": mem_one,
                    "memory_allocated_after_restarts_and_close": mem_after,
                    "trace_clean": report["clean"], "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if (reasons != ["stall", "device_error", "nan_storm"]
                    or line["streams_equal_uninterrupted"] != len(prompts)
                    or first_step["stalled"] or first_step["stalls"]
                    or not report["clean"] or mem_after > mem_one // 2):
                raise AssertionError(f"observability {mode}: a supervision gate failed: {line}")

            inj = FaultInjector(seed=seed, specs=[FaultSpec.device_error(at_calls=(8,))])
            sup = EngineSupervisor(factory, tmp / f"{mode}.dead.journal",
                                   config=SupervisorConfig(max_restarts=0))
            dead = {}
            with inject(inj):
                for r in requests():
                    sup.submit(r)
                while sup.has_work:
                    for o in sup.step():
                        dead[o.request_id] = o.finish_reason
            probe = sup.submit(Request(prompt=list(prompts[0]),
                                       params=SamplingParams(max_new_tokens=4)))
            try:
                sup.step()
                raised = False
            except EngineUnhealthyError:
                raised = True
            line = {"phase": "fp32_observability_unhealthy", "mode": mode,
                    "accounted": len(dead), "rejected_unhealthy": sum(
                        r == f"rejected:{REJECT_UNHEALTHY}" for r in dead.values()),
                    "finished": sum(r == FINISH_LENGTH for r in dead.values()),
                    "submit_after": probe.reason, "step_raises": raised,
                    "shed": sup.metrics.supervisor_shed.value, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if (len(dead) != len(prompts) or not line["rejected_unhealthy"]
                    or probe.reason != REJECT_UNHEALTHY or not raised):
                raise AssertionError(f"observability {mode}: the unhealthy end failed: {line}")
            del sup
            settle()
        del model
        settle()
        torch.cuda.empty_cache()

        # bf16, the fused engine at (2, 1)
        model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                           device="cuda", seed=seed)

        def fused(**kw):
            return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                                 paged_attention="fused", max_concurrency=16,
                                 prompt_buckets=BUCKETS, pipeline_depth=2, **kw)

        fused().run(requests()[:4])  # warm-up

        # (c) brownout over a burst of priorities 0..3, three waves of 48
        config = SupervisorConfig(stall_timeout_s=30.0, brownout_ttft_s=0.05,
                                  brownout_exit_fraction=0.5, brownout_exit_steps=3,
                                  brownout_max_level=3, brownout_clamp_tokens=16)
        sup = EngineSupervisor(lambda **kw: fused(**kw), tmp / "brownout.journal", config=config,
                               tracer=Tracer())
        prios = [i % 4 for i in range(len(prompts))]
        waves = {0: requests(prios), 8: requests(prios), 16: requests(prios)}
        per_step, served = [], {}
        step = 0
        while sup.has_work or step <= max(waves):
            sheds = clamped = accepted = 0
            for r in waves.get(step, ()):
                res = sup.submit(r)
                accepted += res.accepted
                sheds += res.reason == REJECT_OVERLOAD
                clamped += res.accepted and r.params.max_new_tokens == 16
            for o in sup.step():
                served[o.request_id] = o
            head = sup.engine.capacity_headroom()
            per_step.append([step, sup.brownout_level, accepted, sheds, clamped,
                             round(head["est_slot_free_s"] or 0.0, 4), head["queue_depth"]])
            step += 1
        levels = [s[1] for s in per_step]
        runs_of_level = []  # [level, first step, last step]
        for s in per_step:
            if runs_of_level and runs_of_level[-1][0] == s[1]:
                runs_of_level[-1][2] = s[0]
            else:
                runs_of_level.append([s[1], s[0], s[0]])
        phases = [(e.data["phase"], e.data["level"]) for e in sup.engine.tracer.events()
                  if e.kind == "brownout"]
        line = {"phase": "bf16_observability_brownout", "steps": len(per_step),
                "level_runs_level_first_last_step": runs_of_level,
                "waves_step_level_accepted_shed_clamped_est_slot_free_s_queue": [
                    s for s in per_step if s[0] in waves],
                "est_slot_free_s_every_8th_step": [s[5] for s in per_step[::8]],
                "max_level": max(levels), "sheds": sum(s[3] for s in per_step),
                "clamped": sum(s[4] for s in per_step), "served": len(served),
                "exit_step": next((s[0] for s in per_step[::-1] if s[1] > 0), None),
                "markers": phases, "brownouts": sup.metrics.supervisor_brownouts.value,
                "time_in_brownout_s": sup.metrics.supervisor_time_in_brownout_s,
                "trace_clean": sup.engine.tracer.validate()["clean"], "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        sup.close()
        del sup
        settle()

        # (d) the hooks' costs, in turns
        emit_tracer = Tracer(capacity=1 << 17)
        t0 = time.perf_counter()
        for i in range(100_000):
            emit_tracer.emit(EV_QUEUED, i, queue_depth=3, bucket=64)
        emit_us = (time.perf_counter() - t0) * 1e6 / 100_000
        del emit_tracer
        runs, rates = {}, {}
        for turn, kind in enumerate(("off", "traced", "full", "full", "traced", "off")):
            settle()
            torch.cuda.reset_peak_memory_stats()
            kw = {}
            if kind != "off":
                kw["tracer"] = Tracer(capacity=1 << 20)
            if kind == "full":
                kw["telemetry"] = TelemetryExporter(TelemetryConfig(
                    interval_s=0.0, jsonl_path=str(tmp / f"telemetry{turn}.jsonl")))
                kw["anomaly"] = AnomalyMonitor()
            engine = fused(**kw)
            t0 = time.perf_counter()
            outs = engine.run(requests())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = engine.metrics
            mem = engine.memory_stats()
            n_events = len(kw["tracer"].events()) if "tracer" in kw else 0
            phase_sums = {name: getattr(m, f"step_phase_{name}").sum for name in (
                "schedule_s", "draft_s", "dispatch_s", "fetch_blocked_s", "deliver_s",
                "journal_s", "telemetry_s")}
            device = {k.split("/", 1)[1]: v for k, v in mem.items() if k.startswith("device")}
            runs.setdefault(kind, []).append([o.tokens for o in outs])
            rates.setdefault(kind, []).append((m.tokens_generated.value / wall, wall, n_events))
            line = {"phase": "bf16_observability_cost", "turn": turn, "hooks": kind,
                    "requests": len(outs), "generated_tokens": m.tokens_generated.value,
                    "wall_s": wall, "tokens_per_s": m.tokens_generated.value / wall,
                    "ttft_p50_s": m.ttft_s.quantile(0.5), "ttft_p99_s": m.ttft_s.quantile(0.99),
                    "itl_p50_s": m.inter_token_s.quantile(0.5),
                    "itl_p99_s": m.inter_token_s.quantile(0.99),
                    "events": n_events, "events_per_s": n_events / wall,
                    "telemetry_points": len(kw["telemetry"].points()) if kind == "full" else 0,
                    "steps": m.steps.value, "step_total_s": m.step_total_s.sum,
                    "step_phase_s": phase_sums,
                    "step_phases_share_of_total": sum(phase_sums.values()) / m.step_total_s.sum,
                    "device_gauges": device,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "decode_replays": m.decode_dispatches.value, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if kind == "full":
                kw["telemetry"].close()
            del engine, kw
        off_wall = statistics.mean(w for _, w, _ in rates["off"])
        summary = {"phase": "bf16_observability_cost_summary",
                   "tokens_per_s_mean": {k: statistics.mean(r for r, _, _ in v)
                                         for k, v in rates.items()},
                   "wall_s_vs_off": {k: statistics.mean(w for _, w, _ in v) / off_wall - 1
                                     for k, v in rates.items()},
                   "host_us_per_event_from_wall": {
                       k: (statistics.mean(w for _, w, _ in v) - off_wall) * 1e6
                       / statistics.mean(e for _, _, e in v)
                       for k, v in rates.items() if k != "off"},
                   "emit_us_alone": emit_us,
                   "streams_equal_across_turns": all(r == runs["off"][0]
                                                     for rs in runs.values() for r in rs),
                   "card": card}
        print(json.dumps(summary), flush=True)
        lines.append(summary)

        # a profiler window with annotate=True around 16 decode replays
        from torch.profiler import ProfilerActivity, profile

        tracer = Tracer(annotate=True)
        engine = fused(tracer=tracer)
        for r in requests()[:16]:
            engine.submit(r)
        engine.step()
        engine.step()  # admitted; decode under way
        replays0 = engine.metrics.decode_dispatches.value
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                engine.step()
            torch.cuda.synchronize()
        replays = engine.metrics.decode_dispatches.value - replays0
        evs = list(prof.events())
        ranges = [e for e in evs if e.name == "step" and e.device_type
                  == torch.autograd.DeviceType.CPU]
        graph_launches = [e for e in evs if "GraphLaunch" in e.name]
        enclosed = sum(any(r.time_range.start <= g.time_range.start
                           and g.time_range.end <= r.time_range.end for r in ranges)
                       for g in graph_launches)
        paged = sum(1 for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
                    and "paged_decode" in e.name)
        line = {"phase": "bf16_observability_profile", "replays": replays,
                "step_ranges": len(ranges), "graph_launches": len(graph_launches),
                "graph_launches_inside_step_ranges": enclosed,
                "paged_decode_kernels": paged, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if (replays == 0 or len(ranges) != replays or enclosed != len(graph_launches)
                or not graph_launches):
            raise AssertionError(f"observability profile: the step ranges do not enclose the "
                                 f"graph replays: {line}")
        while engine.has_work:
            engine.step()
        del engine, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "observability_phase_s", "seconds": time.perf_counter() - t_phase}),
          flush=True)
    return {"launches": launches, "lines": lines}


def tenant_trace(np, seed: int, n: int, prefix_len: int, tenants: int, vocab: int) -> list:
    """The reference serving benchmark's multi-tenant trace
    (benchmarks/bench_serving.py `_tenant_trace`): ``tenants`` shared
    prefixes of ``prefix_len`` tokens, requests round-robin over them, each
    with a 4-12 token tail and 8-16 new tokens, greedy. Returns (prompt,
    max_new_tokens) pairs; arrivals are paced by the caller."""
    r = np.random.default_rng(seed)
    prefixes = [r.integers(0, vocab, prefix_len).tolist() for _ in range(tenants)]
    out = []
    for i in range(n):
        tail = r.integers(0, vocab, int(r.integers(4, 13))).tolist()
        out.append((prefixes[i % tenants] + tail, int(r.integers(8, 17))))
    return out


def fleet_serving(torch, np, seed: int, card: str, prompts: list[list[int]]) -> dict:
    """Phase 26: the serving fleet and its front door on the card. GPT-2
    small at full width and depth, every replica a supervised paged fused
    engine (kernel #1 in its decode graph) at depth 2 with 16 slots and the
    prefix cache, all over one model. fp32 (TF32 off), phase 5's 48 requests
    (every second sampled), 64 tokens each: (a) a 2-replica `ServingCluster`
    under ``prefix`` and ``round_robin`` gives a lone engine's streams, token
    for token (`fp32_cluster_parity`: placements, `router_stats`, kernel #1's
    launches per replica); (b) a `FaultInjector` device error spends replica
    0's restart budget mid-traffic, the cluster migrates its backlog off the
    journal, `replace_replica` spawns a successor, and the replica the
    streams moved to is killed the same way: no request lost, no emitted
    token decoded twice (the replicas' generated tokens sum to the outputs'),
    streams equal (`fp32_cluster_migration`); (c) a `ServingFrontend` over a
    journaled 2-replica cluster of `FairScheduler` engines, two tenants and
    two priority classes, every request streamed, replica 0 killed
    mid-stream: every stream's events concatenate to its lone-engine output
    (`fp32_frontend_streams`, `stream_lag_s` p50/p99). bf16: (d) the
    reference benchmark's 5-tenant shared-prefix trace with a 256-token
    prefix, 1 replica, then 2 under ``prefix`` and ``round_robin``: tokens/s,
    TTFT p50/p99, trie hit rate, peak memory, and the device's idle share
    over the 2-replica ``prefix`` run, profiled (`bf16_cluster_routing`,
    reported, not gated);
    (e) a surge then idle under `FleetAutoscaler(min_replicas=1,
    max_replicas=3)` with a spawn under traffic, the scale events in order,
    then three spawn-and-retire cycles after which ``memory_allocated()`` is
    back within 1 MiB (`bf16_autoscale`). Returns kernel #1's launches over
    the phase."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        AutoscalerConfig,
        ClusterConfig,
        FairScheduler,
        FleetAutoscaler,
        PagedKVConfig,
        PrefixCacheConfig,
        Request,
        SamplingParams,
        ServingCluster,
        ServingEngine,
        ServingFrontend,
        SubmitOptions,
        SupervisorConfig,
    )

    t_phase = time.perf_counter()
    params = [dict(max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                   top_k=50 if i % 2 else None, seed=i) for i in range(len(prompts))]

    def requests():
        return [Request(prompt=list(p), params=SamplingParams(**kw))
                for p, kw in zip(prompts, params)]

    def factory(model, fair=False):
        """A replica's engine; ``fair`` gives each engine a `FairScheduler`
        of its own."""
        def build(**kw):
            engine = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                                   paged_attention="fused", max_concurrency=16,
                                   prompt_buckets=BUCKETS, pipeline_depth=2, max_queue=256,
                                   prefix_cache=PrefixCacheConfig(block_tokens=16),
                                   scheduler=FairScheduler() if fair else None, **kw)
            if engine._graph is None or not engine.graph_launches.get("paged_decode_attention"):
                raise AssertionError("fleet: a replica captured no decode graph with kernel #1")
            return engine
        return build

    def replica_launches(cluster) -> list[int]:
        """Kernel #1's launches of each replica: what one replay launches
        (counted at capture) times the replica's decode replays."""
        return [rep.engine.graph_launches.get("paged_decode_attention", 0)
                * rep.metrics.decode_dispatches.value for rep in cluster.replicas]

    def drive(cluster, outs):
        while cluster.has_work:
            for o in cluster.step():
                if o.request_id in outs:
                    raise AssertionError(f"fleet: request {o.request_id} delivered twice")
                outs[o.request_id] = o
        return outs

    def kill_first_stepped(cluster):
        """One cluster step under a FaultInjector whose device error fires
        at the step's first dispatch: the first live replica with work (the
        lowest index) fails it and, with no restart budget, dies."""
        with inject(FaultInjector(seed=seed, specs=[FaultSpec.device_error(at_calls=(0,))])):
            return cluster.step()

    def settle():
        gc.collect()
        torch.cuda.synchronize()

    def shut(cluster):
        """Close the replicas' journals and free their device memory now
        (engines sit in reference cycles)."""
        cluster.close()
        for rep in cluster.replicas:
            rep.engine._release_device()

    def paced(cluster, trace, interval):
        """Submit ``trace`` at fixed intervals while stepping the cluster,
        until every request finished (the reference benchmark's
        `_run_cluster` pacing)."""
        for rep in cluster.replicas:
            rep.metrics.reset_rate_window()
        t0 = time.perf_counter()
        pending = list(enumerate(trace))
        done = 0
        while pending or cluster.has_work:
            now = time.perf_counter() - t0
            while pending and pending[0][0] * interval <= now:
                _, (prompt, n_new) = pending.pop(0)
                res = cluster.submit(Request(prompt=prompt,
                                             params=SamplingParams(max_new_tokens=n_new)))
                if not res.accepted:
                    raise AssertionError(f"fleet routing: a request was rejected: {res}")
            done += len(cluster.step())
            if not cluster.has_work and pending:
                time.sleep(max(0.0, pending[0][0] * interval - (time.perf_counter() - t0)))
        if done != len(trace):
            raise AssertionError(f"fleet routing: {done} of {len(trace)} requests finished")

    def device_busy(fn) -> tuple[float, float]:
        """(host wall us, device busy us) of ``fn`` under a CUDA-only
        torch.profiler window (the kernels run on one stream)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.is_user_annotation)
        return wall_us, busy

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    launches = 0
    try:
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
        # (a) parity: a lone engine, then 2-replica clusters under both policies
        lone = factory(model)()
        want = [o.tokens for o in lone.run(requests())]
        del lone
        for policy in ("prefix", "round_robin"):
            t_part = time.perf_counter()
            settle()
            cluster = ServingCluster(factory(model), tmp / f"parity_{policy}", replicas=2,
                                     config=ClusterConfig(policy=policy))
            t0 = time.perf_counter()
            rids = [cluster.submit(r).request_id for r in requests()]
            placed = [cluster.placement(rid)[0] for rid in rids]
            outs = drive(cluster, {})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = [outs[rid].tokens for rid in rids]
            per_replica = replica_launches(cluster)
            launches += sum(per_replica)
            line = {"phase": "fp32_cluster_parity", "policy": policy, "requests": len(rids),
                    "streams_equal_lone_engine": sum(a == b for a, b in zip(got, want)),
                    "placements_per_replica": [placed.count(i) for i in range(2)],
                    "router_stats": cluster.router_stats(), "wall_s": wall,
                    "kernel1_launches_per_replica": per_replica,
                    "decode_replays_per_replica": [rep.metrics.decode_dispatches.value
                                                   for rep in cluster.replicas],
                    "seconds": time.perf_counter() - t_part, "card": card}
            print(json.dumps(line), flush=True)
            if got != want:
                raise AssertionError(f"fp32 cluster ({policy}): streams differ from a lone "
                                     f"engine's: {line}")
            if min(per_replica) <= 0 or min(line["placements_per_replica"]) <= 0:
                raise AssertionError(f"fp32 cluster ({policy}): a replica served nothing: {line}")
            shut(cluster)
            del cluster

        # (b) migration: kill, replace, kill the replica the streams moved to
        t_part = time.perf_counter()
        settle()
        cluster = ServingCluster(factory(model), tmp / "migration", replicas=2,
                                 config=ClusterConfig(policy="round_robin"),
                                 supervisor_config=SupervisorConfig(max_restarts=0))
        rids = [cluster.submit(r).request_id for r in requests()]
        outs: dict = {}
        for _ in range(8):
            for o in cluster.step():
                outs[o.request_id] = o
        for o in kill_first_stepped(cluster):
            outs[o.request_id] = o
        first = dict(states=[rep.state for rep in cluster.replicas],
                     migrated_requests=cluster.migrated_requests)
        if cluster.replicas[0].state != "dead" or cluster.migrations != 1:
            raise AssertionError(f"fleet migration: replica 0 did not die and migrate: {first}")
        successor = cluster.replace_replica(0)
        for _ in range(4):
            for o in cluster.step():
                outs[o.request_id] = o
        moved_to = {cluster.placement(rid)[0] for rid in rids if rid not in outs}
        for o in kill_first_stepped(cluster):
            outs[o.request_id] = o
        if cluster.replicas[1].state != "dead" or cluster.migrations != 2:
            raise AssertionError("fleet migration: the second kill did not land on replica 1")
        cluster.replace_replica(1)
        drive(cluster, outs)
        torch.cuda.synchronize()
        got = [outs[rid].tokens for rid in rids if rid in outs]
        generated = sum(rep.metrics.tokens_generated.value for rep in cluster.replicas)
        per_replica = replica_launches(cluster)
        launches += sum(per_replica)
        line = {"phase": "fp32_cluster_migration", "requests": len(rids),
                "delivered": len(outs), "lost": len(rids) - len(outs),
                "finished_length": sum(o.finish_reason == FINISH_LENGTH for o in outs.values()),
                "streams_equal_uninterrupted": sum(a == b for a, b in zip(got, want)),
                "tokens_delivered": sum(len(t) for t in got),
                "tokens_generated_by_replicas": generated,
                "tokens_decoded_twice": generated - sum(len(t) for t in got),
                "after_first_kill": first, "successor": successor.index,
                "second_kill_hit": sorted(moved_to),
                "states": [rep.state for rep in cluster.replicas],
                "router_stats": cluster.router_stats(),
                "kernel1_launches_per_replica": per_replica,
                "seconds": time.perf_counter() - t_part, "card": card}
        print(json.dumps(line), flush=True)
        if (len(outs) != len(rids) or got != want or generated != sum(len(t) for t in got)
                or line["finished_length"] != len(rids)):
            raise AssertionError(f"fleet migration: lost, re-decoded or changed streams: {line}")
        shut(cluster)
        del cluster

        # (c) the front door: streams over a journaled 2-replica fair cluster
        t_part = time.perf_counter()
        settle()
        cluster = ServingCluster(factory(model, fair=True), tmp / "frontend", replicas=2,
                                 config=ClusterConfig(policy="round_robin"),
                                 supervisor_config=SupervisorConfig(max_restarts=0))
        fe = ServingFrontend(cluster)
        streams = [fe.submit_stream(r, options=SubmitOptions(priority=i % 2,
                                                             tenant="ab"[i * 2 // len(prompts)]))
                   for i, r in enumerate(requests())]
        if not all(s.result.accepted for s in streams):
            raise AssertionError("fleet frontend: a stream was rejected")
        events = {s.request_id: [] for s in streams}
        steps = 0
        killed_mid = None
        while fe.open_streams():
            if steps == 10:
                mid = [s.request_id for s in streams
                       if cluster.placement(s.request_id)[0] == 0 and s.delivered
                       and not s.finished]
                killed_mid = len(mid)
                kill_first_stepped(cluster)
            else:
                cluster.step()
            steps += 1
            for ev in fe.pump():
                events[ev.request_id].append(ev)
        torch.cuda.synchronize()
        lag = cluster.replicas[0].metrics.stream_lag_s
        concat_equal = sum([t for ev in events[s.request_id] for t in ev.tokens] == s.delivered
                           == want[i] for i, s in enumerate(streams))
        per_replica = replica_launches(cluster)
        launches += sum(per_replica)
        line = {"phase": "fp32_frontend_streams", "streams": len(streams),
                "streams_equal_completed": concat_equal, "killed_mid_stream": killed_mid,
                "migrations": cluster.migrations, "events": sum(map(len, events.values())),
                "stream_lag_p50_s": lag.quantile(0.5), "stream_lag_p99_s": lag.quantile(0.99),
                "streamed_ttft_p50_s": cluster.replicas[0].metrics.streamed_ttft_s.quantile(0.5),
                "kernel1_launches_per_replica": per_replica,
                "seconds": time.perf_counter() - t_part, "card": card}
        print(json.dumps(line), flush=True)
        if concat_equal != len(streams) or not killed_mid or cluster.migrations != 1:
            raise AssertionError(f"fleet frontend: streams differ from the completed outputs, "
                                 f"or no stream was cut by the kill: {line}")
        shut(cluster)
        del cluster, fe, streams, model
        settle()
        torch.cuda.empty_cache()

        # (d) bf16 routing: the 5-tenant shared-prefix trace
        model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                           device="cuda", seed=seed)
        trace = tenant_trace(np, seed, 60, 256, 5, 50257)
        interval = 0.03  # a tenant returns every 150 ms: after its last request donated

        def routed(n_reps, policy, profiled):
            """One paced run of the trace in a fresh cluster; ``profiled``
            inside a CUDA-only profiler window (no host-side events
            recorded), whose events take most of the run's seconds to read."""
            settle()
            torch.cuda.reset_peak_memory_stats()
            # a fresh workdir each run: a used one would be resumed
            workdir = Path(tempfile.mkdtemp(prefix="route_", dir=tmp))
            cluster = ServingCluster(factory(model), workdir, replicas=n_reps,
                                     config=ClusterConfig(policy=policy))
            if profiled:
                wall_us, busy_us = device_busy(lambda: paced(cluster, trace, interval))
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                paced(cluster, trace, interval)
                torch.cuda.synchronize()
                wall_us, busy_us = (time.perf_counter() - t0) * 1e6, None
            snap = cluster.metrics.snapshot()
            hits, misses = snap["serving/prefix_hits"], snap["serving/prefix_misses"]
            out = {"tokens_per_s": snap["serving/tokens_generated"] / (wall_us / 1e6),
                   "wall_s": wall_us / 1e6, "ttft_p50_s": snap["serving/ttft_s/p50"],
                   "ttft_p99_s": snap["serving/ttft_s/p99"],
                   "trie_hit_rate": hits / max(hits + misses, 1),
                   "route_match_tokens": snap["cluster/route_match_tokens"],
                   "placements_per_replica": [rep.metrics.requests_submitted.value
                                              for rep in cluster.replicas],
                   "device_idle_share": (None if busy_us is None
                                         else max(0.0, 1.0 - busy_us / wall_us)),
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "kernel1_launches_per_replica": replica_launches(cluster)}
            shut(cluster)
            return out

        # one replica routes every request to itself whatever the policy:
        # its run is the baseline, once; the device's idle share is read
        # in the 2-replica prefix run only
        for n_reps, policy in ((1, "prefix"), (2, "prefix"), (2, "round_robin")):
            t0 = time.perf_counter()
            row = routed(n_reps, policy, profiled=(n_reps, policy) == (2, "prefix"))
            launches += sum(row["kernel1_launches_per_replica"])
            print(json.dumps({"phase": "bf16_cluster_routing", "replicas": n_reps,
                              "policy": policy, "requests": len(trace), "tenants": 5,
                              "prefix_len": 256, "arrival_interval_s": interval, **row,
                              "seconds": time.perf_counter() - t0, "card": card}), flush=True)

        # (e) the autoscaler: a surge, then idle, then spawn-and-retire cycles
        t_part = time.perf_counter()
        settle()
        cluster = ServingCluster(factory(model), tmp / "autoscale", replicas=1)
        scaler = FleetAutoscaler(cluster, AutoscalerConfig(
            min_replicas=1, max_replicas=3, target_ttft_s=0.05, scale_up_windows=2,
            scale_down_idle_windows=3, drain_grace_evals=1000, thrash_enter_events=99))
        surge = requests() + requests()
        rids, outs, events, at_spawn = [], {}, [], []
        seen = {0: "ok"}
        for _ in range(20000):
            # the surge arrives 4 requests a step, so spawned replicas get work
            rids += [cluster.submit(r).request_id for r in surge[len(rids):len(rids) + 4]]
            for o in cluster.step():
                outs[o.request_id] = o
            for rep in cluster.replicas:
                if seen.get(rep.index) != rep.state:
                    if rep.index not in seen:
                        # the spawn ran at the end of this step: what replica
                        # 0 had in flight while the new replica captured
                        at_spawn.append({"replica": rep.index,
                                         "replica0_active_slots": cluster.replicas[0]
                                         .engine.active_slots,
                                         "replica0_dispatches_in_flight":
                                             len(cluster.replicas[0].engine._inflight)})
                    events.append(("spawn" if rep.index not in seen else rep.state, rep.index))
                    seen[rep.index] = rep.state
            if len(rids) == len(surge) and not cluster.has_work and cluster.live_replicas == 1:
                break
        cluster.autoscaler = None  # the cycles below spawn and retire by hand
        torch.cuda.synchronize()
        per_replica = replica_launches(cluster)
        launches += sum(per_replica)
        # three spawn-and-retire cycles, each serving 8 requests on the spawn
        settle()
        mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        cycles = []
        for c in range(3):
            rep = cluster.add_replica()
            for r in requests()[:8]:
                if not rep.supervisor.submit(r).accepted:
                    raise AssertionError("fleet: the spawned replica rejected a request")
            drive(cluster, {})
            launches += replica_launches(cluster)[rep.index]
            cluster.retire_replica(rep.index)
            cluster.step()
            settle()
            cycles.append({"replica": rep.index, "state": rep.state,
                           "allocated": torch.cuda.memory_allocated(),
                           "reserved": torch.cuda.memory_reserved()})
        mem1 = torch.cuda.memory_allocated()
        line = {"phase": "bf16_autoscale", "requests": len(rids), "delivered": len(outs),
                "lost": len(rids) - len(outs),
                "finished_length": sum(o.finish_reason == FINISH_LENGTH for o in outs.values()),
                "scale_events": events, "scale_ups": scaler.scale_ups, "retires": scaler.retires,
                "at_spawns": at_spawn,
                "gauges": scaler.gauges(), "kernel1_launches_per_replica": per_replica,
                "allocated_before_cycles": mem0, "reserved_before_cycles": res0,
                "cycles": cycles, "allocated_after_cycles": mem1,
                "allocated_delta_bytes": mem1 - mem0,
                "seconds": time.perf_counter() - t_part, "card": card}
        print(json.dumps(line), flush=True)
        if len(outs) != len(rids) or line["finished_length"] != len(rids):
            raise AssertionError(f"fleet autoscale: requests lost: {line}")
        if (scaler.scale_ups < 1 or cluster.live_replicas != 1
                or not any(s["replica0_dispatches_in_flight"] for s in at_spawn)):
            raise AssertionError(f"fleet autoscale: no spawn under traffic, or the fleet did "
                                 f"not drain back to one replica: {line}")
        if abs(mem1 - mem0) > 1 << 20:
            raise AssertionError(f"fleet autoscale: memory_allocated moved {mem1 - mem0} B over "
                                 "three spawn-and-retire cycles")
        shut(cluster)
        del cluster, scaler, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "fleet_phase_s", "seconds": time.perf_counter() - t_phase}),
          flush=True)
    return {"launches": launches}


def nlp_example_phase(torch, card: str, mixed_precision: str) -> dict:
    """Phase 25 (a): the port's `examples/nlp_example.py` at BERT-base width
    (hidden 768, 12 layers, 12 heads, vocab 30522, length 64, batch 16, 8
    train and 2 eval batches of the reference's seeded synthetic task) for 3
    epochs with ``--gradient_accumulation_steps 2 --with_tracking
    --checkpointing`` in ``mixed_precision``: each epoch's loss and accuracy,
    samples/s over epochs 1-2 (epoch 0 holds the first calls), peak memory,
    the JSONL tracker's lines, the checkpoint's bytes and ``save_state``
    seconds; then a profiler window over 3 train steps (device ms of one
    step), and ``load_state`` of the checkpoint, timed, which must give the
    eval logits of the moment it was saved, bit for bit."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.examples import nlp_example

    tmp = Path(tempfile.mkdtemp(prefix=f"nlp_example_{mixed_precision}_"))
    try:
        args = nlp_example.parser().parse_args(
            ["--mixed_precision", mixed_precision, "--gradient_accumulation_steps", "2",
             "--with_tracking", "--checkpointing", "--project_dir", str(tmp)])
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = nlp_example.training_function(args)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        acc, model, step = run["accelerator"], run["model"], run["step"]
        train, evals = nlp_example.get_dataloaders(args.batch_size, model.config.vocab_size,
                                                   args.seed)
        on_card = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()} for b in (train[0],
                                                                                      evals[0])]

        def eval_logits():
            with torch.no_grad():
                return model(on_card[1]["input_ids"], on_card[1]["attention_mask"])

        saved = eval_logits()
        wall_us, by_name = profile_steps(torch, lambda: step(on_card[0]), 3)
        prof = profile_record(f"{mixed_precision}_nlp_example_profile", 3, wall_us, by_name)
        moved = not torch.equal(eval_logits(), saved)
        t0 = time.perf_counter()
        acc.load_state(run["checkpoint_dir"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored = torch.equal(eval_logits(), saved)
        ckpt = Path(run["checkpoint_dir"])
        lines = (tmp / "nlp_example.metrics.jsonl").read_text().splitlines()
        timed = run["epochs"][1:]
        samples = args.batch_size * 8 * len(timed)
        scale = acc._optimizers[0].scaler_state
        rec = {"phase": f"{mixed_precision}_nlp_example", "model": "bert-base",
               "batch": args.batch_size, "seq": nlp_example.MAX_LEN, "epochs": run["epochs"],
               "gradient_accumulation_steps": 2, "microbatch_losses": run["losses"],
               "updates": run["optimizer"].num_updates,
               "skipped_updates": run["optimizer"].skipped_updates,
               "fp16_scale": None if scale is None else scale.scale.item(),
               "samples_per_s": samples / sum(e["train_s"] for e in timed),
               "device_ms_per_step": prof["device_ms_per_step"],
               "host_ms_per_step": prof["host_ms_per_step"],
               "device_idle_share": prof["device_idle_share"], "peak_mem_bytes": peak,
               "tracker_lines": len(lines), "checkpoint_bytes": sum(f.stat().st_size
                                                                    for f in ckpt.iterdir()),
               "checkpoint_files": len(list(ckpt.iterdir())), "save_s": run["save_s"],
               "load_s": load_s, "steps_moved_logits": moved, "load_restored_logits": restored,
               "wall_s": wall, "card": card}
        print(json.dumps(rec), flush=True)
        print(json.dumps(prof), flush=True)
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"{rec['phase']}: a loss is not finite: {run['losses']}")
        if len(lines) != 1 + args.num_epochs:
            raise AssertionError(f"{rec['phase']}: the tracker wrote {len(lines)} lines")
        if not (ckpt / "_COMPLETE").exists() or not moved or not restored:
            raise AssertionError(f"{rec['phase']}: the checkpoint did not restore the saved "
                                 f"weights (moved {moved}, restored {restored})")
        del run, acc, model, step
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def facade_training(torch, np, seed: int, card: str) -> dict:
    """Phase 25 (b): GPT-2 small at the reference's bench shape (flash
    attention, batch 8 x 1024, bf16, ``gradient_accumulation_steps=4``,
    ``max_grad_norm=1.0``, `lm_loss_fn_pallas`) through the facade: a
    `DataLoaderShard` of 8 seeded batches (``prefetch="auto"``: pinned host
    copies, the next batch's copy issued before the step on this one),
    AdamW and an `AcceleratedScheduler` over the optax schedule. The
    imperative loop (``accumulate``: ``backward``, ``clip_grad_norm_`` on
    the boundary, ``optimizer.step()``, ``scheduler.step()``,
    ``zero_grad()``) and ``make_train_step`` give equal losses over the 8
    microbatches; the loop launches each flash kernel n_layer times and each
    fused-CE kernel once per microbatch; ``save_state`` after 4 microbatches,
    then a fresh `Accelerator`, model (another seed), optimizer, scheduler
    and loader, ``load_state`` and ``skip_first_batches`` reproduce the last
    4 losses. Tokens/s of both forms (the host clock over the 8 microbatches,
    ending in a sync), each form run twice from a fresh build, in turns
    (loop, fused, fused, loop)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoaderShard
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn_pallas
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.scheduler import schedule_lambda, warmup_cosine_decay_schedule

    batch, seq, k, n = 8, 1024, 4, 8
    cfg = GPT2Config.small(dtype=torch.bfloat16, attention_impl="flash")
    rng = np.random.default_rng(seed)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq))} for _ in range(n)]
    tmp = Path(tempfile.mkdtemp(prefix="facade_gpt2_"))

    def build(model_seed):
        acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=k,
                          project_dir=str(tmp))
        module = GPT2LMHead(cfg, device="cuda", seed=model_seed)
        opt = torch.optim.AdamW(module.parameters(), weight_decay=1e-4)
        sched = schedule_lambda(opt, warmup_cosine_decay_schedule(1e-5, 1e-4, warmup_steps=1,
                                                                  decay_steps=4))
        return (acc, *acc.prepare(module, opt, DataLoaderShard(batches, prefetch="auto"), sched))

    def explicit(acc, model, opt, dl, sched, stop=None):
        losses = []
        for i, b in enumerate(dl):
            with acc.accumulate(model):
                losses.append(acc.backward(lm_loss_fn_pallas, b))
                if acc.sync_gradients:
                    acc.clip_grad_norm_(max_norm=1.0)
                opt.step()
                sched.step()
                opt.zero_grad()
            if stop is not None and i + 1 == stop:
                break
        return losses

    def fused(acc, model, opt, dl, sched):
        step = acc.make_train_step(lm_loss_fn_pallas, max_grad_norm=1.0)
        losses = []
        for b in dl:
            losses.append(step(b))
            sched.step()
        return losses

    def timed(form, parts):
        gc.collect()
        torch.cuda.synchronize()
        reset_counts(fa)
        t0 = time.perf_counter()
        losses = [x.item() for x in form(*parts)]
        wall = time.perf_counter() - t0
        return losses, wall, {**flash_counts(fa), **fused_ce_counts()}

    try:
        # in turns, each from a fresh build: loop, fused, fused, loop
        loop_losses, loop_wall, launches = timed(explicit, build(seed))
        fused_losses, fused_wall, fused_launches = timed(fused, build(seed))
        fused_again, fused_wall_2, _ = timed(fused, build(seed))
        loop_again, loop_wall_2, _ = timed(explicit, build(seed))
        first = build(seed)
        head = [x.item() for x in explicit(*first, stop=n // 2)]
        saved = first[0].save_state()
        del first
        gc.collect()
        resumed = build(seed + 1)
        acc, model, opt, dl, sched = resumed
        acc.load_state(saved)
        acc.skip_first_batches(dl, n // 2)
        tail = [x.item() for x in explicit(acc, model, opt, dl, sched)]
        rec = {"phase": "bf16_facade_gpt2", "model": "gpt2-small", "batch": batch, "seq": seq,
               "gradient_accumulation_steps": k, "microbatches": n, "max_grad_norm": 1.0,
               "loss": "lm_loss_fn_pallas", "prefetch": "auto", "losses_loop": loop_losses,
               "losses_make_train_step": fused_losses,
               "forms_max_abs_diff": max(abs(a - b) for a, b in zip(loop_losses, fused_losses)),
               "losses_resumed_head": head, "losses_resumed_tail": tail,
               "resume_max_abs_diff": max(abs(a - b) for a, b in zip(tail, loop_losses[n // 2:])),
               "updates": opt.num_updates, "lr_last": sched.get_last_lr()[0],
               "launches_loop": launches, "launches_make_train_step": fused_launches,
               "tokens_per_s_loop": [batch * seq * n / w for w in (loop_wall, loop_wall_2)],
               "tokens_per_s_make_train_step": [batch * seq * n / w
                                                for w in (fused_wall, fused_wall_2)],
               "card": card}
        print(json.dumps(rec), flush=True)
        expected = {**{name: cfg.n_layer * n for name in FLASH_REPLACES},
                    **{name: n for name in FUSED_CE_REPLACES}}
        if launches != expected or fused_launches != expected:
            raise AssertionError(f"facade launches {launches} / {fused_launches}, expected "
                                 f"{expected}")
        if (not all(math.isfinite(x) for x in loop_losses)
                or not loop_losses == fused_losses == fused_again == loop_again):
            raise AssertionError("the imperative loop's losses differ from make_train_step's: "
                                 f"{loop_losses}, {loop_again} vs {fused_losses}, {fused_again}")
        if head != loop_losses[:n // 2] or tail != loop_losses[n // 2:]:
            raise AssertionError(f"the resumed run's losses {head} + {tail} differ from the "
                                 f"uninterrupted run's {loop_losses}")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# nominal host link of an H100 SXM: PCIe 5.0 x16, 64 GB/s per direction
PCIE_PEAK_BYTES_PER_S = 64e9


def kv_tier_serving(torch, np, seed: int, card: str, prompts: list[list[int]]) -> dict:
    """Phase 27: the host-RAM KV tier behind the paged pool on the card.
    GPT-2 small at full width and depth, paged fused engines (kernel #1 in
    the decode graph) at depth 2, over a pool of about half the decode
    extents of the requests a full set of slots admits, so that
    reservations fall short and the tier spills and hibernates. fp32 (TF32
    off), with the prefix cache, 16 requests of a 64-token shared prefix and
    a tail under one block (every second sampled), 48 tokens each, 16
    slots: the tier-off engine
    (over a full-context pool), then ``wake_policy`` ``"upload"`` and
    ``"prefill"``; then the whole trie spilled and the first 4 prompts
    served again, whose hits page in. Tier-on streams must equal tier-off's and a lone `generate`'s, with
    ``page_outs``, ``page_ins``, ``hibernated`` and ``wakeups`` above 0,
    ``memory_allocated()`` back to the byte after the drain and, after
    `_release_device`, to where it was before the engine
    (`fp32_kv_tier_parity`). bf16 weights over an int8 pool, phase 5's 48
    requests, 64 tokens, 16 slots, no prefix cache, tier off and
    ``"upload"``, ``"prefill"`` and ``"auto"``: page-out and page-in bytes/s beside the PCIe peak, wake
    latency by policy (wake to the stream's next token), what ``"auto"``
    chose, peak admitted concurrency (active + hibernated) against what the
    pool alone holds (the tier-off engine's peak), tokens/s
    (`bf16_kv_tier`, reported, not gated); the upload run writes a trace, a
    telemetry JSONL and a journal, and the five port tools must exit 0 on
    them (`kv_tier_tools`). Returns kernel #1's launches over the phase."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import (
        KVTierConfig,
        PagedKVConfig,
        PrefixCacheConfig,
        Request,
        SamplingParams,
        ServingEngine,
        TelemetryConfig,
        TelemetryExporter,
        Tracer,
    )

    t_phase = time.perf_counter()
    launches = 0
    bt = 16

    def requests(ps, n_new):
        return [Request(prompt=list(p), params=SamplingParams(
                    max_new_tokens=n_new, temperature=0.8 if i % 2 else 0.0,
                    top_k=50 if i % 2 else None, seed=i)) for i, p in enumerate(ps)]

    def half_pool(ps, n_new, slots):
        """About half the blocks the first ``slots`` requests reserve, and
        never less than one full context."""
        need = sum(-(-min(len(p) + n_new, 1024) // bt) for p in ps[:slots])
        return max(1024 // bt, need // 2)

    def build(model, num_blocks, slots, policy=None, prefix=True, tier_kw=None, **kw):
        tier = KVTierConfig(wake_policy=policy, **(tier_kw or {})) if policy else None
        engine = ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=bt, num_blocks=num_blocks),
                               paged_attention="fused", max_concurrency=slots,
                               prompt_buckets=BUCKETS, pipeline_depth=2, max_queue=256,
                               prefix_cache=PrefixCacheConfig(block_tokens=bt) if prefix else False,
                               kv_tier=tier, **kw)
        if engine._graph is None or not engine.graph_launches.get("paged_decode_attention"):
            raise AssertionError("kv tier: an engine captured no decode graph with kernel #1")
        return engine

    def drive(engine, reqs):
        """Serve ``reqs`` to the end; per step, the admitted streams (active
        and hibernated) and each woken stream's latency from its wake to
        its next token, by the path it took."""
        tier = engine.kv_tier
        woke: dict[int, tuple[float, int, str]] = {}
        lat: dict[str, list[float]] = {"upload": [], "prefill": []}
        if tier is not None:
            upload, prefill = engine._wake_hibernated_upload, tier._wake_prefill

            def on_upload(rec):
                done = upload(rec)
                if done:
                    woke[rec.request.request_id] = (time.perf_counter(), len(rec.tokens), "upload")
                return done

            def on_prefill(rec):
                prefill(rec)
                woke[rec.request.request_id] = (time.perf_counter(), len(rec.tokens), "prefill")

            engine._wake_hibernated_upload, tier._wake_prefill = on_upload, on_prefill
        for r in reqs:
            if not engine.submit(r).accepted:
                raise AssertionError("kv tier: a request was rejected")
        outs, peak = {}, 0
        t0 = time.perf_counter()
        while engine.has_work:
            for o in engine.step():
                outs[o.request_id] = o.tokens
            now = time.perf_counter()
            peak = max(peak, engine.active_slots + (tier.hibernated_count if tier else 0))
            if woke:
                seen = {o.request_id: len(o.tokens) for o in engine._slot_out if o is not None}
                seen.update((rid, len(t)) for rid, t in outs.items())
                for rid, (t_wake, n, how) in list(woke.items()):
                    if seen.get(rid, 0) > n:
                        lat[how].append(now - t_wake)
                        del woke[rid]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if tier is not None:
            tier.settle(block=True)
        return [outs[r.request_id] for r in reqs], wall, peak, lat

    def tier_counts(engine):
        m = engine.metrics
        return {k: int(getattr(m, f"host_{k}").value)
                for k in ("page_ins", "page_outs", "hibernated", "wakeups", "thrash_events")}

    def settle():
        gc.collect()
        torch.cuda.synchronize()

    # --- fp32: parity, memory
    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 27)
    system = rng.integers(0, 50257, 64).tolist()
    # tails of under one block: a retired prompt donates the shared prefix
    # and at most one block of its own, so the trie strands few interior
    # blocks (a pool held by stranded chains stalls admission, ROADMAP
    # Queue 3)
    fp32_prompts = [system + p[:int(rng.integers(3, 16))] for p in prompts[:16]]
    n_new, slots = 48, 16
    pool = half_pool(fp32_prompts, n_new, slots)
    replay = fp32_prompts[:4]
    # the oracle runs over a full-context pool: a stream does not depend on
    # the pool's size
    off = build(model, None, slots)
    want, _, _, _ = drive(off, requests(fp32_prompts, n_new))
    want_b, _, _, _ = drive(off, requests(replay, n_new))
    launches += replay_launches(off, "paged_decode_attention", 0)
    off._release_device()
    del off
    solos = []
    for i, p in enumerate(fp32_prompts):
        gen = torch.Generator(device="cuda").manual_seed(i) if i % 2 else None
        solos.append(generate(model, torch.tensor([p], device="cuda"), n_new,
                              temperature=0.8 if i % 2 else 0.0, top_k=50 if i % 2 else None,
                              generator=gen)[0].tolist())
    fp32_line = {"phase": "fp32_kv_tier_parity", "requests": len(fp32_prompts), "slots": slots,
                 "pool_blocks": pool, "tier_off_equal_generate": want == solos}
    if want != solos:
        raise AssertionError(f"kv tier fp32: tier-off streams differ from generate's: {fp32_line}")
    for policy in ("upload", "prefill"):
        settle()
        base = torch.cuda.memory_allocated()
        # the guard would freeze spill within the first seconds of this
        # burst; parity wants every cycle the pool forces
        engine = build(model, pool, slots, policy, tier_kw=dict(thrash_enter_events=10_000))
        settle()
        built = torch.cuda.memory_allocated()
        got, wall, peak, lat = drive(engine, requests(fp32_prompts, n_new))
        spilled = engine.kv_tier.page_out_trie(10 ** 6)
        got_b, _, _, _ = drive(engine, requests(replay, n_new))
        counts = tier_counts(engine)
        settle()
        drained = torch.cuda.memory_allocated()
        mem = engine.memory_stats()
        host_after = (engine.kv_tier.host_bytes - engine.kv_tier.trie_host_bytes,
                      engine.kv_tier.uploads_in_flight)
        launches += replay_launches(engine, "paged_decode_attention", 0)
        engine._release_device()
        tier = engine.kv_tier
        del engine
        settle()
        released = torch.cuda.memory_allocated()
        fp32_line[policy] = {
            "streams_equal_tier_off": got == want, "streams_equal_generate": got == solos,
            "replay_equal_tier_off": got_b == want_b, "counters": counts,
            "trie_blocks_spilled": spilled, "peak_admitted": peak,
            "wake_latency_s": {k: statistics.median(v) if v else None for k, v in lat.items()},
            "allocated_after_drain_minus_built": drained - built,
            "allocated_after_release_minus_before": released - base,
            "hibernated_host_bytes_after_drain": host_after[0],
            "uploads_held_after_drain": host_after[1],
            "host_bytes_after_release": tier.host_bytes, "wall_s": wall,
            "block_pool_free_after_drain": mem["block_pool/blocks_free"]}
        if (got != want or got != solos or got_b != want_b
                or min(counts[k] for k in ("page_ins", "page_outs", "hibernated", "wakeups")) <= 0
                or counts["wakeups"] < 3 or drained != built or released != base
                or host_after != (0, 0) or tier.host_bytes):
            raise AssertionError(f"kv tier fp32 ({policy}): {fp32_line}")
    print(json.dumps({**fp32_line, "card": card}), flush=True)
    del model
    settle()
    torch.cuda.empty_cache()

    # --- bf16 weights over an int8 pool: rates, wake latency, capacity
    model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                        kv_cache_dtype=torch.int8), device="cuda", seed=seed)
    pool = half_pool(prompts, 64, 16)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_kv_tier_"))
    pcie = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
                           "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bf16_line = {"phase": "bf16_kv_tier", "requests": len(prompts), "slots": 16,
                 "pool_blocks": pool, "kv_cache_dtype": "int8", "pcie_link": pcie,
                 "pcie_peak_bytes_per_s": PCIE_PEAK_BYTES_PER_S}
    try:
        build(model, pool, 16, prefix=False).run(requests(prompts, 64)[:4])  # warm-up
        streams = {}
        for policy in (None, "upload", "prefill", "auto"):
            settle()
            kw = {}
            if policy == "upload":
                kw = dict(tracer=Tracer(), journal=str(tmp / "requests.journal"),
                          telemetry=TelemetryExporter(TelemetryConfig(
                              interval_s=0.05, jsonl_path=str(tmp / "telemetry.jsonl"))))
            engine = build(model, pool, 16, policy, prefix=False, **kw)
            engine.metrics.reset_rate_window()
            got, wall, peak, lat = drive(engine, requests(prompts, 64))
            streams[policy] = got
            tokens = engine.metrics.tokens_generated.value
            rec = {"tokens_per_s": tokens / wall, "wall_s": wall, "peak_admitted": peak,
                   "decode_replays": engine.metrics.decode_dispatches.value}
            launches += replay_launches(engine, "paged_decode_attention", 0)
            if policy is not None:
                m, tier = engine.metrics, engine.kv_tier
                counts = tier_counts(engine)
                rec.update(counters=counts, block_bytes=tier.block_bytes,
                           streams_equal_tier_off=sum(a == b for a, b in zip(got, streams[None])),
                           wake_latency_p50_s={k: statistics.median(v) if v else None
                                               for k, v in lat.items()},
                           wakes_by_path={k: len(v) for k, v in lat.items()})
                if m.host_page_out_s.count:
                    rate = counts["page_outs"] * tier.block_bytes / m.host_page_out_s.sum
                    rec.update(page_out_bytes_per_s=rate,
                               page_out_share_of_pcie=rate / PCIE_PEAK_BYTES_PER_S)
                if m.host_page_in_s.count:
                    rate = counts["page_ins"] * tier.block_bytes / m.host_page_in_s.sum
                    rec.update(page_in_bytes_per_s=rate,
                               page_in_share_of_pcie=rate / PCIE_PEAK_BYTES_PER_S)
                if policy == "upload":
                    engine.tracer.export(tmp / "trace.json")
                    engine.telemetry.close()
                    engine.journal.close()
            bf16_line[policy or "tier_off"] = rec
            engine._release_device()
            del engine
        bf16_line["tier_off_peak_active"] = bf16_line["tier_off"]["peak_admitted"]
        print(json.dumps({**bf16_line, "card": card}), flush=True)

        # the five port tools on the upload run's own files
        tools = {
            "journal_fsck": [tmp / "requests.journal"],
            "trace_report": [tmp / "trace.json", "--json"],
            "explain_request": ["0", tmp / "trace.json", "--journal", tmp / "requests.journal",
                                "--telemetry", tmp / "telemetry.jsonl", "--json"],
            "serve_top": [tmp / "telemetry.jsonl"],
            "check_metrics_docs": ["--json"],
        }
        procs = {name: subprocess.Popen(
                     [sys.executable, "-m", f"accelerate_tpu_torch.tools.{name}", *map(str, args)],
                     cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for name, args in tools.items()}
        rcs, outs = {}, {}
        for name, proc in procs.items():
            outs[name], err = proc.communicate(timeout=300)
            rcs[name] = proc.returncode
            if proc.returncode != 0:
                raise AssertionError(f"kv tier tools: {name} exited {proc.returncode}: "
                                     f"{outs[name][-2000:]} {err[-2000:]}")
        host = [ln for ln in outs["serve_top"].splitlines() if ln.startswith("host   [")]
        print(json.dumps({"phase": "kv_tier_tools", "exit_codes": rcs, "serve_top_host_line": host}),
              flush=True)
        if not host:
            raise AssertionError("kv tier tools: serve_top rendered no host-tier line")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del model
        settle()
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "kv_tier_phase_s", "seconds": time.perf_counter() - t_phase}),
          flush=True)
    return {"launches": launches}


# the CPU op whose kernels a ResNet step's device time is charged to: the
# innermost match among the launching op and its parents, by name prefix
RESNET_OP_CATEGORIES = (
    ("layout copies", ("aten::contiguous",)),
    ("casts", ("aten::_to_copy",)),
    ("padding", ("aten::constant_pad_nd",)),
    ("GroupNorm", ("aten::group_norm", "aten::native_group_norm")),
    ("convolutions", ("aten::cudnn_convolution", "aten::convolution_backward",
                      "aten::_convolution")),
    ("max pool", ("aten::max_pool2d",)),
    ("classifier and loss", ("aten::addmm", "aten::mm", "aten::_log_softmax", "aten::gather",
                             "aten::nll_loss")),
    ("SGD", ("aten::_foreach_", "Optimizer.step")),
)
# the card-vs-CPU fp32 ResNet-50 step: both sides fp32 with TF32 off, 53
# convolutions summed in other orders on each side
RESNET_LOSS_ATOL = 1e-4
RESNET_GRAD_NORM_RTOL = 1e-3

PREEMPTION_CHILD = """
import os, sys, time, torch
from accelerate_tpu_torch.accelerator import Accelerator, ProjectConfiguration
from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig, image_classification_loss_fn
from accelerate_tpu_torch.reliability import install_preemption_handler
acc = Accelerator(mixed_precision="bf16", project_config=ProjectConfiguration(
    project_dir=sys.argv[1], automatic_checkpoint_naming=True))
model = acc.prepare(ResNet(ResNetConfig.resnet50(), seed=0))
opt = acc.prepare(torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9))
step = acc.make_train_step(image_classification_loss_fn)
install_preemption_handler(acc)
g = torch.Generator(device="cuda").manual_seed(1)
batch = {"image": torch.randn(16, 224, 224, 3, device="cuda", generator=g),
         "label": torch.randint(0, 1000, (16,), device="cuda", generator=g)}
for _ in range(3):
    step(batch)
torch.save({"model": model.state_dict(), "updates": opt.num_updates},
           os.path.join(sys.argv[1], "trained.pt"))
print("ready", flush=True)
while True:  # the loop between steps; SIGTERM lands a checkpoint and exits 143
    time.sleep(0.01)
"""


def profile_by_op(torch, run_step, steps: int, categories=None, kernel_kinds=()) -> dict:
    """A profiler window over ``steps`` calls of ``run_step``: host and device
    ms per step, the idle share, device ms per step by kind, the layout
    copies by the op that asked for them (the first op above
    ``aten::contiguous``), and the top kernels by name. A kernel whose name
    matches a pattern of ``kernel_kinds`` ((kind, regex) pairs; the port's
    own kernels, launched outside any aten op) is that kind; every other
    kernel is charged to the innermost op over the one that launched it
    that matches ``categories`` (default RESNET_OP_CATEGORIES)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name: dict[str, float] = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    categories = RESNET_OP_CATEGORIES if categories is None else categories
    by_kind: dict[str, float] = {}
    copies_by_caller: dict[str, float] = {}
    attributed = 0.0

    def named_kind(kname: str) -> str | None:
        return next((k for k, pattern in kernel_kinds if re.search(pattern, kname)), None)

    for kname, us in by_name.items():
        kind = named_kind(kname)
        if kind:
            by_kind[kind] = by_kind.get(kind, 0.0) + us
            attributed += us
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        chain, node = [], ev
        while node is not None:
            chain.append(node.name)
            node = node.cpu_parent
        kind = next((k for name in chain for k, prefixes in categories
                     if name.startswith(prefixes)), "elementwise and other")
        us = sum(k.duration for k in ev.kernels if not named_kind(k.name))
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        attributed += us
        if kind == "layout copies":
            above = chain[chain.index("aten::contiguous") + 1:] if "aten::contiguous" in chain \
                else []
            caller = next((n for n in above if n.startswith("aten::")), "the caller's own")
            copies_by_caller[caller] = copies_by_caller.get(caller, 0.0) + us
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "host_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "device_ms_per_step_by_kind": {k: us / steps / 1e3 for k, us in
                                           sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "attributed_share": attributed / busy_us if busy_us else 0.0,
            "layout_copies_ms_per_step_by_caller": {k: us / steps / 1e3 for k, us in
                                                    sorted(copies_by_caller.items(),
                                                           key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": {n[:80]: us / steps / 1e3 for n, us in ranked}}


def group_norm_layout_probe(torch) -> dict:
    """One fp32 `F.group_norm` forward and backward at ResNet-50's stage-0
    width (16 x 256 x 56 x 56, 32 groups) on a channels_last input and on a
    contiguous one: the kernels each launches, its device ms, and whether
    the output keeps the input's layout."""
    import torch.nn.functional as F

    out = {}
    for layout in ("channels_last", "contiguous"):
        x = torch.randn(16, 256, 56, 56, device="cuda")
        if layout == "channels_last":
            x = x.to(memory_format=torch.channels_last)
        x.requires_grad_(True)
        w = torch.ones(256, device="cuda", requires_grad=True)
        b = torch.zeros(256, device="cuda", requires_grad=True)

        def run():
            y = F.group_norm(x, 32, w, b, 1e-6)
            y.backward(torch.ones_like(y))
            return y

        y = run()
        rec = profile_by_op(torch, run, 3)
        out[layout] = {"output_channels_last": y.is_contiguous(memory_format=torch.channels_last),
                       "device_ms": rec["device_ms_per_step"],
                       "kernels": sorted(rec["top_kernels_ms_per_step"]),
                       "layout_copies_ms": rec["device_ms_per_step_by_kind"].get("layout copies",
                                                                                  0.0)}
    return out


def resnet_step_pair(torch, card: str) -> dict:
    """Phase 28 (b): one fp32 ResNet-50 step (TF32 off) on the card and on
    the CPU, from the same seeded weights and batch (4 x 224 x 224): loss
    within RESNET_LOSS_ATOL, the gradient's global norm within
    RESNET_GRAD_NORM_RTOL relative."""
    from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig, image_classification_loss_fn

    cfg = ResNetConfig.resnet50(dtype=torch.float32)
    weights = ResNet(cfg, device="cpu", seed=0).state_dict()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(4, 224, 224, 3, generator=g),
             "label": torch.randint(0, 1000, (4,), generator=g)}

    def step(device):
        model = ResNet(cfg, device=device)
        model.load_state_dict(weights)
        t0 = time.perf_counter()
        loss = image_classification_loss_fn(model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack([p.grad.double().norm()
                                                     for p in model.parameters()]))
        return loss.item(), norm.item(), time.perf_counter() - t0

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    card_loss, card_norm, card_s = step("cuda")
    cpu_loss, cpu_norm, cpu_s = step("cpu")
    rec = {"phase": "fp32_resnet50_card_vs_cpu", "batch": 4, "image_size": 224,
           "loss_card": card_loss, "loss_cpu": cpu_loss, "loss_abs_diff": abs(card_loss - cpu_loss),
           "grad_norm_card": card_norm, "grad_norm_cpu": cpu_norm,
           "grad_norm_rel_diff": abs(card_norm - cpu_norm) / cpu_norm, "tf32": False,
           "card_step_s": card_s, "cpu_step_s": cpu_s, "card": card}
    print(json.dumps(rec), flush=True)
    if not (rec["loss_abs_diff"] <= RESNET_LOSS_ATOL
            and rec["grad_norm_rel_diff"] <= RESNET_GRAD_NORM_RTOL):
        raise AssertionError(f"fp32 ResNet-50 step: the card and the CPU disagree: {rec}")
    return rec


def cv_example_run(torch, card: str, mixed_precision: str) -> dict:
    """Phase 28 (a): the port's `examples/cv_example.py` at the reference's
    defaults (ResNet-50, 224 x 224, 1000 classes, batch 16, 3 epochs of 8
    batches, SGD momentum 0.9 at lr 0.02) in ``mixed_precision``; under
    ``"no"`` the model's convolutions compute in fp32 too (the reference's
    config computes them in bf16 under every policy). Each epoch's loss and
    accuracy, images/s over epochs 1-2, peak memory, and a profiler window
    over 3 steps."""
    from accelerate_tpu_torch.examples import cv_example
    from accelerate_tpu_torch.models.resnet import ResNetConfig

    args = cv_example.parser().parse_args(["--mixed_precision", mixed_precision])
    config = None if mixed_precision == "bf16" else ResNetConfig.resnet50(dtype=torch.float32)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = cv_example.training_function(args, config=config)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    images, labels = cv_example.synthetic_images(16, 224, 1000, args.seed)
    batch = {"image": torch.from_numpy(images).cuda(), "label": torch.from_numpy(labels).cuda()}
    prof = profile_by_op(torch, lambda: run["step"](batch), 3)
    timed = run["epochs"][1:]
    rec = {"phase": f"{mixed_precision}_cv_example", "model": "resnet50", "batch": 16,
           "image_size": 224, "conv_dtype": "bf16" if config is None else "fp32", "tf32": False,
           "epochs": run["epochs"], "microbatch_losses": run["losses"],
           "images_per_s": 16 * 8 * len(timed) / sum(e["train_s"] for e in timed),
           "peak_mem_bytes": peak, "wall_s": wall, **prof, "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in run["losses"]) or len(run["losses"]) != 24:
        raise AssertionError(f"{rec['phase']}: {len(run['losses'])} losses, or one not finite")
    del run
    return rec


def resnet_bf16_throughput(torch, card: str, batch_size: int = 128, steps: int = 10) -> dict:
    """Phase 28 (a): ``steps`` timed bf16 ResNet-50 steps at ``batch_size``
    after 2 warm-up steps: images/s, MFU (3 x the forward FLOPs counted from
    the convolution and classifier shapes, over the card's dense bf16 peak),
    peak memory, and a profiler window over 3 steps."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig, image_classification_loss_fn

    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare(ResNet(ResNetConfig.resnet50(), seed=0))
    acc.prepare(torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9))
    step = acc.make_train_step(image_classification_loss_fn)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(batch_size, 224, 224, 3, device="cuda", generator=g),
             "label": torch.randint(0, 1000, (batch_size,), device="cuda", generator=g)}
    losses, wall = timed_steps(torch, step, batch, warmup=2, steps=steps)
    peak = torch.cuda.max_memory_allocated()
    flops = 3 * model.module.forward_flops(224)
    images_per_s = batch_size * steps / wall
    prof = profile_by_op(torch, lambda: step(batch), 3)
    rec = {"phase": f"bf16_resnet50_b{batch_size}", "batch": batch_size, "steps": steps,
           "step_ms": wall / steps * 1e3, "images_per_s": images_per_s,
           "train_flops_per_image": flops,
           "mfu": images_per_s * flops / bf16_peak(torch.cuda.get_device_name(0)),
           "peak_mem_bytes": peak, "losses": losses, "tf32": False, **prof, "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{rec['phase']}: a loss is not finite: {losses}")
    del acc, model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def complete_cv_resume(torch, card: str) -> dict:
    """Phase 28 (c): `examples/complete_cv_example.py` at ResNet-50 with
    ``--checkpointing --with_tracking`` (2 epochs, cosine schedule), then
    resumed from ``epoch_0``: the resumed run retraces the unbroken run's
    epoch 1, every loss bit for bit. cuDNN is held deterministic for the
    pair (its weight-gradient algorithms may otherwise sum in another order
    from run to run)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.examples import complete_cv_example as ccv

    tmp = Path(tempfile.mkdtemp(prefix="complete_cv_"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = ccv.training_function(ccv.parser().parse_args(
            ["--checkpointing", "--with_tracking", "--project_dir", str(tmp / "a")]))
        resumed = ccv.training_function(ccv.parser().parse_args(
            ["--project_dir", str(tmp / "b"), "--resume_from_checkpoint",
             full["checkpoints"][0]["dir"]]))
        lines = (tmp / "a" / "complete_cv_example.metrics.jsonl").read_text().splitlines()
        equal = resumed["losses"][:8] == full["losses"][8:16]
        rec = {"phase": "complete_cv_example_resume", "model": "resnet50", "epochs": full["epochs"],
               "resumed_epochs": resumed["epochs"], "resumed_equals_unbroken": equal,
               "checkpoint_bytes": full["checkpoints"][0]["bytes"],
               "save_s": [c["save_s"] for c in full["checkpoints"]], "load_s": resumed["load_s"],
               "tracker_lines": len(lines), "cudnn_deterministic": True, "card": card}
        print(json.dumps(rec), flush=True)
        if not equal:
            raise AssertionError(f"complete_cv_example resumed from epoch_0 does not retrace the "
                                 f"unbroken run: {resumed['losses'][:8]} != {full['losses'][8:16]}")
        if len(lines) != 3:
            raise AssertionError(f"complete_cv_example: the tracker wrote {len(lines)} lines")
        del full, resumed
        return rec
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def oom_batch_search(torch, card: str, start: int = 4096) -> dict:
    """Phase 28 (d): `find_executable_batch_size` over one bf16 ResNet-50
    step from ``start`` images, each attempt building its accelerator, model,
    optimizer and batch on the card: the card's allocator raises
    ``torch.cuda.OutOfMemoryError`` until the batch fits. After the search
    and `release_memory`, ``memory_allocated()`` is back within 1 MiB."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.memory import find_executable_batch_size, release_memory
    from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig, image_classification_loss_fn

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    tried, errors = [], []

    @find_executable_batch_size(starting_batch_size=start)
    def attempt(batch_size: int) -> float:
        tried.append(batch_size)
        try:
            acc = Accelerator(mixed_precision="bf16")
            model = acc.prepare(ResNet(ResNetConfig.resnet50(), seed=0))
            acc.prepare(torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9))
            step = acc.make_train_step(image_classification_loss_fn)
            batch = {"image": torch.randn(batch_size, 224, 224, 3, device="cuda"),
                     "label": torch.randint(0, 1000, (batch_size,), device="cuda")}
            loss = float(step(batch))
            torch.cuda.synchronize()
            return loss
        except torch.cuda.OutOfMemoryError as e:
            errors.append(type(e).__name__)
            raise

    t0 = time.perf_counter()
    loss = attempt()
    search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    release_memory()
    after = torch.cuda.memory_allocated()
    rec = {"phase": "bf16_resnet50_find_executable_batch_size", "starting_batch_size": start,
           "tried": tried, "found": attempt.batch_size, "oom_errors": errors, "loss": loss,
           "search_s": search_s, "allocated_before": before, "allocated_after": after,
           "peak_mem_bytes": peak, "card": card}
    print(json.dumps(rec), flush=True)
    if not errors or attempt.batch_size >= start or not math.isfinite(loss):
        raise AssertionError(f"find_executable_batch_size: no real OOM was recovered from: {rec}")
    if abs(after - before) > 2**20:
        raise AssertionError(f"find_executable_batch_size left {after - before} bytes allocated")
    return rec


def by_feature_on_card(torch, np, card: str) -> dict:
    """Phase 28 (e): the by_feature examples on the card at their own
    defaults: gradient accumulation and checkpointing (``configs[2]``),
    early stopping, tracking, the sliding-window Llama (band kernels #5-#7,
    counted), the profiler, whose Chrome trace must name a CUDA kernel, and
    schedule-free AdamW.
    Then a child process training ResNet-50 on the card under
    `install_preemption_handler` is sent SIGTERM: it exits 143 with a
    complete checkpoint, which loads here to its weights."""
    import importlib
    import os
    import shutil
    import signal
    import tempfile

    from accelerate_tpu_torch.ops import flash_attention as fa

    tmp = Path(tempfile.mkdtemp(prefix="by_feature_"))
    out: dict = {"phase": "by_feature_examples", "examples": {}, "card": card}
    try:
        for name in ("gradient_accumulation", "checkpointing", "early_stopping", "tracking",
                     "sliding_window_long_context", "profiler", "schedule_free"):
            main = importlib.import_module(f"accelerate_tpu_torch.examples.by_feature.{name}").main
            reset_counts(fa)
            t0 = time.perf_counter()
            res = main(["--project_dir", str(tmp / name)])
            torch.cuda.synchronize()
            summary = {"seconds": time.perf_counter() - t0}
            for key in ("accuracy", "stopped_at", "updates", "loss"):
                if key in res:
                    summary[key] = res[key]
            if "losses" in res:
                summary.update(first_loss=res["losses"][0], last_loss=res["losses"][-1],
                               steps=len(res["losses"]))
            if name == "sliding_window_long_context":
                out["band_launches"] = band_counts(fa)
                summary["band_launches"] = out["band_launches"]
            if name == "profiler":
                events = json.loads(Path(res["traces"][0]).read_text())["traceEvents"]
                kernels = sorted({ev["name"] for ev in events if ev.get("cat") == "kernel"})
                summary.update(trace_files=len(res["traces"]), cuda_kernels=len(kernels),
                               some_kernels=[k[:60] for k in kernels[:3]])
                if not kernels:
                    raise AssertionError("by_feature profiler: the trace names no CUDA kernel")
            out["examples"][name] = summary
        if any(v == 0 for v in out["band_launches"].values()):
            raise AssertionError(f"sliding_window_long_context launched no band kernel: "
                                 f"{out['band_launches']}")

        # the training preemption handler on the card
        from accelerate_tpu_torch.accelerator import Accelerator, ProjectConfiguration
        from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig

        pdir = tmp / "preempt"
        pdir.mkdir()
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", PREEMPTION_CHILD, str(pdir)], cwd=ROOT,
                                 stdout=subprocess.PIPE, text=True, env={**os.environ})
        try:
            ready = child.stdout.readline().strip()
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        acc = Accelerator(mixed_precision="bf16", project_config=ProjectConfiguration(
            project_dir=str(pdir), automatic_checkpoint_naming=True))
        model = acc.prepare(ResNet(ResNetConfig.resnet50(), seed=1))
        opt = acc.prepare(torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9))
        loaded = acc.load_state()
        want = torch.load(pdir / "trained.pt")
        matches = all(torch.equal(v, want["model"][k].to(v.device))
                      for k, v in model.state_dict().items())
        out["preemption"] = {"ready": ready, "exit_code": rc, "checkpoint": Path(loaded).name,
                             "complete": (Path(loaded) / "_COMPLETE").exists(),
                             "updates": opt.num_updates, "weights_equal": matches,
                             "seconds": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        if ready != "ready" or rc != 143 or not out["preemption"]["complete"] or not matches \
                or opt.num_updates != want["updates"]:
            raise AssertionError(f"preemption on the card: {out['preemption']}")
        del acc, model, opt
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def vision_and_facade(torch, np, card: str) -> dict:
    """Phase 28: ResNet-50 image classification and the rest of the
    one-process facade; returns the by_feature record (band launches)."""
    t0 = time.perf_counter()
    runs = {mp: cv_example_run(torch, card, mp) for mp in ("bf16", "no")}
    big = resnet_bf16_throughput(torch, card)
    probe = group_norm_layout_probe(torch)
    print(json.dumps({"phase": "group_norm_layout_probe", **probe, "card": card}), flush=True)
    resnet_step_pair(torch, card)
    resume = complete_cv_resume(torch, card)
    oom = oom_batch_search(torch, card)
    features = by_feature_on_card(torch, np, card)
    print(json.dumps({"phase": "vision_facade_phase_s", "seconds": time.perf_counter() - t0,
                      "bf16_images_per_s_b16": runs["bf16"]["images_per_s"],
                      "fp32_images_per_s_b16": runs["no"]["images_per_s"],
                      "bf16_images_per_s_b128": big["images_per_s"], "mfu_b128": big["mfu"],
                      "checkpoint_bytes": resume["checkpoint_bytes"], "oom_found": oom["found"],
                      "card": card}), flush=True)
    return features


def precision_run(torch, card: str, seed: int, name: str, mixed: str, cfg_kw: dict, o2: bool,
                  batches: list, warmup: int = 2, steps: int = 5) -> dict:
    """One of phase 29's training variants: GPT-2 small at bench.py's shape,
    flash attention, the fused loss (`lm_loss_fn_pallas`), AdamW (lr 1e-4,
    weight decay 1e-4, optax's default) or ``adamw_fp8(1e-4,
    opt_level="O2")``; ``warmup`` steps, then ``steps`` timed ones with the
    launch counts set to 0 and the peak memory reset just before them, over
    two fixed batches in turn. Prints and returns the line."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn_pallas
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8

    kw = dict(cfg_kw)
    if kw.pop("fp8", False):
        kw["fp8_recipe"] = fp8.DelayedScalingRecipe(backend="native")
    dtype = torch.float16 if mixed == "fp16" else torch.bfloat16
    cfg = GPT2Config.small(dtype=dtype, attention_impl="flash", **kw)
    model = GPT2LMHead(cfg, device="cuda", seed=seed)
    acc = Accelerator(mixed_precision=mixed)
    opt = (fp8.adamw_fp8(model.parameters(), 1e-4, opt_level="O2") if o2 else
           torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    model, opt = acc.prepare(model, opt)
    step = acc.make_train_step(lm_loss_fn_pallas)
    losses = [step(batches[i % 2]).item() for i in range(warmup)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    fp8.fp8_gemm.calls = 0
    t0 = time.perf_counter()
    timed = [step(batches[(warmup + i) % 2]) for i in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += [t.item() for t in timed]
    batch, seq = batches[0]["input_ids"].shape
    tokens_per_s = batch * seq * steps / wall
    flops_per_token = train_flops_per_token(model, seq)
    dev = torch.cuda.get_device_name(0)
    opt_bytes = sum(t.numel() * t.element_size() for st in opt.optimizer.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor))
    counts = {**flash_counts(fa), **fused_ce_counts()}
    rec = {"phase": "precision_train", "run": name, "mixed_precision": mixed,
           "model": "gpt2-small", "batch": batch, "seq": seq, "fp8": "fp8_recipe" in kw,
           "optimizer": "adamw_fp8 O2" if o2 else "AdamW", "remat_policy": kw.get("remat_policy"),
           "warmup_steps": warmup, "steps": steps, "step_ms": wall / steps * 1e3,
           "tokens_per_s": tokens_per_s,
           "mfu": tokens_per_s * flops_per_token / bf16_peak(dev),
           **({"mfu_vs_fp8_peak": tokens_per_s * flops_per_token / fp8_peak(dev)}
              if "fp8_recipe" in kw else {}),
           "flops_per_token": flops_per_token, "losses": losses,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "optimizer_state_bytes": opt_bytes,
           "launches": counts, "fp8_gemm_calls": fp8.fp8_gemm.calls,
           "loss_scale": (opt.scaler_state.scale.item() if opt.scaler_state is not None else None),
           "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"precision run {name}: the loss did not fall: {losses}")
    fwd = 2 if kw.get("remat") else 1  # the recompute runs the forward again
    expected = {"flash_attention_fwd": fwd * cfg.n_layer * steps,
                "flash_attention_dq": cfg.n_layer * steps,
                "flash_attention_dkv": cfg.n_layer * steps,
                **{n: steps for n in FUSED_CE_REPLACES}}
    if counts != expected:
        raise AssertionError(f"precision run {name}: launches {counts}, expected {expected}")
    # forward, dX and dK of 4 projections a layer; under remat "dots" the
    # recompute calls the forward's again and is handed the saved product
    gemm = (3 + (fwd - 1)) * 4 * cfg.n_layer * steps if "fp8_recipe" in kw else 0
    if fp8.fp8_gemm.calls != gemm:
        raise AssertionError(f"precision run {name}: {fp8.fp8_gemm.calls} fp8 GEMM calls, "
                             f"expected {gemm}")
    if name in PRECISION_PROFILED:
        profile_train(torch, lambda: step(batches[0]), f"precision_train_{name}_profile", card=card)
    del model, acc, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def fp8_gemm_line(torch, card: str, seed: int, flush) -> dict:
    """Phase 29 (c): the fp8 GEMM (`ops.fp8.fp8_gemm`, ``torch._scaled_mm``)
    at GPT-2 small's four projection shapes, M 8192, e4m3 operands at
    delayed-style scales: its error against the fp32 product of the
    dequantized operands, its ms, bf16 ``F.linear``'s ms on the same shape,
    and its bound (2 M K N at the fp8 dense rate, or its bytes)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import fp8

    dev = torch.cuda.get_device_name(0)
    bw = peak_rates(dev)[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = []
    for K, N in GPT2_NF4_SHAPES:
        M = 8192
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(N, K, generator=g, device="cuda") / math.sqrt(K)).to(torch.bfloat16)
        xs = torch.tensor(fp8.E4M3_MAX, device="cuda") / x.float().abs().max()
        ws = torch.tensor(fp8.E4M3_MAX, device="cuda") / w.float().abs().max()
        xq, wq = fp8.quantize(x, xs, fp8.E4M3, fp8.E4M3_MAX), fp8.quantize(w.T, ws, fp8.E4M3,
                                                                           fp8.E4M3_MAX)
        got = fp8.fp8_gemm(xq, wq, xs, ws, torch.bfloat16)
        want = fp8.fp8_gemm_reference(xq, wq, xs, ws, torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        flops, n_bytes = 2 * M * K * N, M * K + K * N + 2 * M * N
        bound_ms = max(flops / fp8_peak(dev), n_bytes / bw) * 1e3
        ms = device_ms(torch, lambda: fp8.fp8_gemm(xq, wq, xs, ws, torch.bfloat16), flush)
        shapes.append({"M": M, "K": K, "N": N, "max_abs_err": err, "err_over_max": err / scale,
                       "rtol_of_max": FP8_GEMM_RTOL, "ms": ms,
                       "bf16_linear_ms": device_ms(torch, lambda: F.linear(x, w), flush),
                       "bound_ms": bound_ms,
                       "bound_by": "operations" if flops / fp8_peak(dev) >= n_bytes / bw else "bytes",
                       "bound_share": bound_ms / ms, "tflops": flops / ms * 1e-9})
        if not (math.isfinite(err) and err <= FP8_GEMM_RTOL * scale):
            raise AssertionError(f"fp8 GEMM {M}x{K}x{N}: max_abs_err {err} > "
                                 f"{FP8_GEMM_RTOL} x {scale}")
    rec = {"phase": "fp8_gemm", "route": "torch._scaled_mm (cuBLASLt)", "dtype": "e4m3 x e4m3 -> bf16",
           "shapes": shapes, "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def precision_phase(torch, np, seed: int, card: str) -> dict:
    """Phase 29: precision on one card. (a) GPT-2 small's five training
    variants (`PRECISION_RUNS`), each 7 steps (2 untimed) from one seed over the same
    two batches; (b) the fp8 curves against bf16's and fp8 O2 with remat
    against without; (c) the fp8 GEMM at the projection shapes; (d) the fp16
    instances of the flash (#2-#4) and fused-CE (#8-#10) kernels against
    their plain versions at phase 6's and phase 9's main shapes. Returns the
    variants' flash and fused-CE launches and the fp16 cases."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    batches = [{"input_ids": torch.from_numpy(rng.integers(0, 50257, (8, 1024))).to("cuda")}
               for _ in range(2)]
    runs = {name: precision_run(torch, card, seed, name, mixed, kw, o2, batches)
            for name, mixed, kw, o2 in PRECISION_RUNS}
    runs["fp8_all_repeat"] = precision_run(torch, card, seed, "fp8_all_repeat",
                                           *PRECISION_RUNS[2][1:], batches)

    base = runs["bf16"]["losses"]
    parity = {"phase": "fp8_loss_parity", "steps": len(base), "tolerance": FP8_LOSS_TOL,
              "bf16": base, "remat_atol": REMAT_LOSS_ATOL, "card": card}
    for name in ("fp8_model", "fp8_all"):
        curve = runs[name]["losses"]
        parity[name] = curve
        parity[f"{name}_max_divergence"] = max(abs(a - b) for a, b in zip(curve, base))
    parity["remat_max_abs_diff"] = max(abs(a - b) for a, b in zip(
        runs["fp8_all"]["losses"], runs["fp8_all_remat_dots"]["losses"]))
    parity["repeat_max_abs_diff"] = max(abs(a - b) for a, b in zip(
        runs["fp8_all"]["losses"], runs["fp8_all_repeat"]["losses"]))
    parity["fp16_max_divergence"] = max(abs(a - b) for a, b in zip(runs["fp16"]["losses"], base))
    print(json.dumps(parity), flush=True)
    for name in ("fp8_model", "fp8_all"):
        if not (parity[f"{name}_max_divergence"] <= FP8_LOSS_TOL
                and runs[name]["losses"][-1] < runs[name]["losses"][0]):
            raise AssertionError(f"fp8 loss parity ({name}): {parity}")
    if not parity["remat_max_abs_diff"] <= REMAT_LOSS_ATOL:
        raise AssertionError(f"fp8 O2 under remat 'dots' differs from without: {parity}")

    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fp8_gemm_line(torch, card, seed, flush)
    flash = flash_case(torch, "gpt2_small_fp16_causal", dtype=torch.float16, causal=True,
                       seed=seed, b=8, h=12, s=1024, d=64, flush=flush)
    fused = fused_ce_case(torch, "gpt2_small_fp16", dtype=torch.float16, ignore_every=16,
                          seed=seed, n=8192, v=50257, e=768, flush=flush)
    del flush
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in (*FLASH_REPLACES, *FUSED_CE_REPLACES)}
    print(json.dumps({"phase": "precision_phase_s", "seconds": time.perf_counter() - t0,
                      "launches": launches, "fp16_run_launches": runs["fp16"]["launches"],
                      "card": card}), flush=True)
    return {"launches": launches, "flash_case": flash, "fused_case": fused,
            "bf16_step_ms": runs["bf16"]["step_ms"]}


# phase 30: big models on one card (placement and streaming, Mixtral-8x7B).
# The card's host link: PCIe 5.0 x16, 32 GT/s a lane, 128b/130b, one way
PCIE5_X16_BYTES_PER_S = 32e9 * 16 * 128 / 130 / 8
GIB, MIB = 1 << 30, 1 << 20
# fp32 (TF32 off) streamed against resident logits: the same kernels in the
# same order on the same weights, so 0 is expected; this is the bar
BIG_MODEL_ATOL = 1e-5
BIG_MIXTRAL_LAYERS = 4
BIG_MIXTRAL_BUDGET = {"device": 4 * GIB, "cpu": 6 * GIB}
BIG_MIXTRAL_FORWARDS = 3
RESIDENT_TIMED_FORWARDS = 7
MIXTRAL_TRAIN_SEQ = 4096
# device kernels of the Mixtral train step: flash and fused CE by kernel
# name; the bf16 products by their aten op's shapes (`moe_gemm_kind`)
MOE_KINDS = ("expert GEMMs", "dispatch/combine einsums", "flash kernels", "fused-CE kernels",
             "other GEMMs", "rest")
# cuBLAS's product kernels by name, which the rest's split leaves to the ops
MOE_GEMM_KERNELS = r"nvjet|gemm|cutlass|xmma"


def mixtral_config(torch, **kw):
    """Mixtral-8x7B's published width (mistralai/Mixtral-8x7B-v0.1
    config.json; arXiv 2401.04088, Table 1): hidden 4096, 32 heads over 8 kv
    heads, 8 experts of intermediate 14336, top-2, vocab 32000, rope base
    1e6; the reference's 4096 positions and capacity factor 2.0."""
    from accelerate_tpu_torch.models.mixtral import MixtralConfig

    return MixtralConfig.mixtral_8x7b(**kw)


def mixtral_param_counts(cfg) -> dict:
    """Parameters of a Mixtral config: per layer (attention, experts,
    router, norms), the embedding and head, the whole."""
    e, f, E, kvd = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, \
        cfg.num_kv_heads * cfg.head_dim
    attn = 2 * e * e + 2 * e * kvd
    experts = 3 * E * e * f
    layer = attn + experts + E * e + 2 * e
    table = cfg.vocab_size * e
    return {"attention": attn, "experts": experts, "router": E * e, "layer": layer,
            "embed_and_head": 2 * table + e, "total": cfg.num_layers * layer + 2 * table + e}


def mixtral_train_flops_per_token(cfg, seq: int) -> dict:
    """Training FLOPs per token (forward and backward, 6 per matmul
    parameter): ``active`` counts the top-k experts a token uses,
    ``executed`` what the static-capacity einsums compute: every expert's
    ``capacity`` slots, and the dispatch and combine products, 2 T E C e
    each, forward, then backward the dispatch's once (the activations'
    gradient; the one-hot takes none) and the combine's twice (the gates'
    and the expert outputs'). Attention adds 12 e w per layer, w the mean
    keys a causal query sees."""
    from accelerate_tpu_torch.ops.moe import expert_capacity

    e, f, E, k, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.top_k, \
        cfg.num_layers
    counts = mixtral_param_counts(cfg)
    capacity = expert_capacity(cfg.capacity_factor, seq, k, E)
    attention = 12 * L * e * (seq + 1) / 2
    dense = 6 * (L * (counts["attention"] + counts["router"]) + cfg.vocab_size * e)
    active = dense + 6 * L * k * 3 * e * f + attention
    executed = (dense + 6 * L * (E * capacity / seq) * 3 * e * f + attention
                + L * 5 * 2 * E * capacity * e)
    return {"active": active, "executed": executed, "capacity": capacity}


def interval_union(intervals) -> list[tuple[float, float]]:
    """Sorted disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def overlap_us(a, b) -> float:
    """Length of the intersection of two disjoint unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def copy_compute_overlap(copies, kernels) -> dict:
    """Device time of the host-to-device copies, of the kernels, and the
    share of copy time that runs under a kernel (intervals in us)."""
    cu, ku = interval_union(copies), interval_union(kernels)
    copy_us = sum(b - a for a, b in cu)
    both = overlap_us(cu, ku)
    return {"copy_ms": copy_us / 1e3, "compute_ms": sum(b - a for a, b in ku) / 1e3,
            "overlap_ms": both / 1e3, "hidden_share": both / copy_us if copy_us else None}


def stream_overlap(torch, fn) -> dict:
    """A profiler window around ``fn``: its host-to-device copies (the copy
    stream) against its kernels (the compute stream), by device intervals."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies, kernels = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        if "HtoD" in ev.name:
            copies.append(span)
        elif not ev.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    if not copies or not kernels:
        return {"copy_ms": None, "compute_ms": None, "overlap_ms": None, "hidden_share": None,
                "note": "the profiler showed no device copies or kernels: not measured"}
    return copy_compute_overlap(copies, kernels)


def moe_gemm_kind(shapes, experts: int, slots: int) -> str:
    """Which kind of bf16 product an aten mm/bmm call is, by its operands'
    shapes: one with a dimension of ``slots`` (experts x capacity, the
    flattened dispatch and combine axes) is a dispatch or combine einsum;
    a batched one over the experts is an expert GEMM; the rest (attention
    projections, the router) other GEMMs."""
    dims = [d for s in shapes if s for d in s]
    if slots in dims:
        return "dispatch/combine einsums"
    if any(s and len(s) == 3 and s[0] == experts for s in shapes):
        return "expert GEMMs"
    return "other GEMMs"


def profile_mixtral_step(torch, run_step, cfg, seq: int, steps: int = 2) -> dict:
    """Device ms per step of the Mixtral train step by kind (`MOE_KINDS`),
    from a profiler window with operand shapes: the flash and fused-CE
    kernels by name, the aten mm/bmm calls by `moe_gemm_kind`, the rest as
    the difference, itself split by `TRAIN_KERNEL_CATEGORIES` over the
    kernels that are not products; host ms per step and the idle share
    beside."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.ops.moe import expert_capacity

    slots = cfg.num_experts * expert_capacity(cfg.capacity_factor, seq, cfg.top_k,
                                              cfg.num_experts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = dict.fromkeys(MOE_KINDS, 0.0)
    rest: dict[str, float] = {}
    total = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation:
            continue
        us = ev.time_range.elapsed_us()
        total += us
        if re.search(r"flash_(fwd|dq|dkv)_kernel", ev.name):
            kinds["flash kernels"] += us
        elif fused_ce_part(ev.name):
            kinds["fused-CE kernels"] += us
        elif not re.search(MOE_GEMM_KERNELS, ev.name, re.IGNORECASE):
            # the products are counted by their aten op below
            cat = next((c for c, pattern in TRAIN_KERNEL_CATEGORIES
                        if re.search(pattern, ev.name, re.IGNORECASE)), "other")
            rest[cat] = rest.get(cat, 0.0) + us
    for avg in prof.key_averages(group_by_input_shape=True):
        if avg.key in ("aten::mm", "aten::bmm", "aten::addmm"):
            dev = getattr(avg, "self_device_time_total", None)
            if dev is None:
                dev = avg.self_cuda_time_total
            kinds[moe_gemm_kind(avg.input_shapes, cfg.num_experts, slots)] += dev
    kinds["rest"] = total - sum(v for k, v in kinds.items() if k != "rest")
    return {"steps": steps, "host_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": total / steps / 1e3,
            "device_idle_share": max(0.0, 1.0 - total / wall_us),
            "device_ms_per_step_by_kind": {k: v / steps / 1e3 for k, v in kinds.items()},
            "rest_ms_per_step_by_kind": {k: v / steps / 1e3 for k, v in
                                         sorted(rest.items(), key=lambda kv: -kv[1])}}


def blockwise_parity(torch, np, seed: int, card: str) -> dict:
    """Phase 30 (a): fp32 (TF32 off) Llama-2-7B width (phase 18's) and
    Mixtral-8x7B width, each at 2 layers with ``attention_impl="flash"``,
    through their blockwise decompositions dispatched as embed -> device,
    layer_0 -> cpu, layer_1 -> disk, head -> device: two calls on one 1 x 512
    prompt give the resident model's logits (max |err| <= BIG_MODEL_ATOL,
    expected 0). Returns the flash forward launches."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, llama_blockwise,
                                                   llama_blockwise_state_dict)
    from accelerate_tpu_torch.models.mixtral import (MixtralForCausalLM, mixtral_blockwise,
                                                     mixtral_blockwise_state_dict)
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 32000, (1, 512))).to("cuda")
    dmap = {"embed": "device", "layer_0": "cpu", "layer_1": "disk", "head": "device"}
    launches = 0
    for name, cfg, cls, bw_fn, sd_fn in (
            ("llama2_7b_width", LlamaConfig.llama2_7b(
                num_layers=2, dtype=torch.float32, param_dtype=torch.float32,
                max_position_embeddings=LLAMA_7B_POSITIONS, attention_impl="flash"),
             LlamaForCausalLM, llama_blockwise, llama_blockwise_state_dict),
            ("mixtral_8x7b_width", mixtral_config(
                torch, num_layers=2, dtype=torch.float32, param_dtype=torch.float32,
                attention_impl="flash"),
             MixtralForCausalLM, mixtral_blockwise, mixtral_blockwise_state_dict)):
        model = cls(cfg, seed=seed)
        reset_counts(fa)
        with torch.no_grad():
            want = model(ids)
        torch.cuda.synchronize()
        resident_launches = fa.flash_attention_fwd.launches
        sd = sd_fn({k: v.to("cpu") for k, v in model.state_dict().items()})
        del model
        gc.collect()
        torch.cuda.empty_cache()
        off = tempfile.mkdtemp(prefix="offload_")
        try:
            bw = dispatch_model(bw_fn(cfg), dmap, sd, offload_dir=off)
            del sd
            reset_counts(fa)
            t0 = time.perf_counter()
            with torch.no_grad():
                got = [bw(ids) for _ in range(2)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counted = fa.flash_attention_fwd.launches
        finally:
            shutil.rmtree(off, ignore_errors=True)
        errs = [float((g - want).abs().max()) for g in got]
        rec = {"phase": f"fp32_blockwise_parity_{name}", "layers": cfg.num_layers,
               "device_map": dmap, "prompt": list(ids.shape), "max_abs_err": max(errs),
               "max_abs_err_by_call": errs, "atol": BIG_MODEL_ATOL,
               "streamed_bytes": dict(bw.streamed_bytes), "s_per_forward": wall / 2,
               "flash_fwd_launches": counted, "flash_fwd_launches_resident": resident_launches,
               "card": card}
        print(json.dumps(rec), flush=True)
        if not all(math.isfinite(e) and e <= BIG_MODEL_ATOL for e in errs):
            raise AssertionError(f"{name}: streamed logits differ from the resident model's: {rec}")
        if counted != 2 * cfg.num_layers or resident_launches != cfg.num_layers:
            raise AssertionError(f"{name}: flash forward launches {counted} (resident "
                                 f"{resident_launches}), expected {2 * cfg.num_layers}")
        launches += counted + resident_launches
        del bw, got, want
        torch.cuda.empty_cache()
    return {"flash_attention_fwd": launches}


def copy_rates(log, forwards: int) -> dict:
    """Per tier from a `BlockwiseModel.copy_log`: bytes per forward, the copy
    stream's ms per forward (disk: file reads into the staging buffer
    included, as the copies wait for them), GB/s, and the disk tier's host
    read seconds per forward."""
    out = {}
    for tier in ("cpu", "disk"):
        rows = [r for r in log if r["tier"] == tier]
        nbytes = sum(r["bytes"] for r in rows)
        ms = sum(r["start"].elapsed_time(r["end"]) for r in rows)
        out[tier] = {"bytes_per_forward": nbytes / forwards, "copy_ms_per_forward": ms / forwards,
                     "gb_per_s": nbytes / (ms / 1e3) / 1e9 if ms else None,
                     "host_read_s_per_forward": sum(r["read_s"] for r in rows) / forwards}
    return out


def big_mixtral_streaming(torch, np, seed: int, card: str) -> dict:
    """Phase 30 (b): bf16 Mixtral-8x7B at full width, BIG_MIXTRAL_LAYERS
    layers. The seeded model's blockwise state dict is exported as a
    safetensors checkpoint (a temporary directory, removed after) and loaded
    with ``load_checkpoint_and_dispatch(device_map="auto",
    max_memory=BIG_MIXTRAL_BUDGET)``: the solved map uses device, cpu and
    disk; the logits of a 1 x 512 prompt equal the resident model's bit for
    bit in each of BIG_MIXTRAL_FORWARDS timed forwards; the peak allocated
    memory stays within what was allocated before, the two consecutive
    blocks that stream the most and the resident forward's activations
    (plus 1 MiB a streamed tensor of allocator rounding). One line with the
    bytes streamed per tier, seconds per forward, GB/s per tier beside PCIe
    5.0 x16, the copy time hidden under compute (a profiler window over one
    forward) and peak memory; then `cpu_offload_with_hook` over two such
    models; then the full 32-layer model's bytes and the seconds per
    forward these rates predict for it (`full_model_prediction`, not
    run)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.big_modeling import (load_checkpoint_and_dispatch, tree_bytes)
    from accelerate_tpu_torch.checkpointing import save_model_weights
    from accelerate_tpu_torch.models.mixtral import (MixtralForCausalLM, mixtral_blockwise,
                                                     mixtral_blockwise_state_dict)
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg = mixtral_config(torch, num_layers=BIG_MIXTRAL_LAYERS, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16, attention_impl="flash")
    ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, 32000, (1, 512))).to("cuda")
    model = MixtralForCausalLM(cfg, seed=seed)
    model_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    with torch.no_grad():
        model(ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        want = model(ids)
        torch.cuda.synchronize()
        activations = torch.cuda.max_memory_allocated() - before
        # a resident forward takes some 20 ms, host-paced, so one timing
        # swings by 2x: the median of RESIDENT_TIMED_FORWARDS
        resident_times = []
        for _ in range(RESIDENT_TIMED_FORWARDS):
            t0 = time.perf_counter()
            model(ids)
            torch.cuda.synchronize()
            resident_times.append(time.perf_counter() - t0)
        resident_s = statistics.median(resident_times)
    ckpt = tempfile.mkdtemp(prefix="mixtral_ckpt_")
    off = tempfile.mkdtemp(prefix="mixtral_offload_")
    try:
        t0 = time.perf_counter()
        save_model_weights(mixtral_blockwise_state_dict(model.state_dict()), ckpt)
        write_s = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bw = load_checkpoint_and_dispatch(mixtral_blockwise(cfg), ckpt, device_map="auto",
                                          max_memory=BIG_MIXTRAL_BUDGET, offload_folder=off)
        load_s = time.perf_counter() - t0
        tiers = sorted(set(bw.device_map.values()))
        resident_bytes = sum(tree_bytes(bw.params[k]) for k, t in bw.device_map.items()
                             if t.startswith("device"))
        with torch.no_grad():
            first = bw(ids)  # makes the staging buffer and the copy stream
        bw.copy_log, bw.streamed_bytes = [], {"cpu": 0, "disk": 0}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fa)
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = [bw(ids) for _ in range(BIG_MIXTRAL_FORWARDS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = fa.flash_attention_fwd.launches
        rates = copy_rates(bw.copy_log, BIG_MIXTRAL_FORWARDS)
        bw.copy_log = None
        pair_bytes, pair_tensors = bw.streamed_pair()
        bound = pair_bytes + activations + pair_tensors * MIB
        with torch.no_grad():
            overlap = stream_overlap(torch, lambda: bw(ids))
        equal = [bool(torch.equal(o, want)) for o in [first, *outs]]
        rec = {"phase": "bf16_big_mixtral_streaming", "model": "mixtral-8x7b-width",
               "layers": cfg.num_layers, "model_bytes": model_bytes, "max_memory":
               BIG_MIXTRAL_BUDGET, "device_map": bw.device_map, "tiers": tiers,
               "resident_bytes": resident_bytes, "checkpoint_write_s": write_s,
               "load_and_dispatch_s": load_s, "prompt": list(ids.shape),
               "forwards": BIG_MIXTRAL_FORWARDS, "s_per_forward": wall / BIG_MIXTRAL_FORWARDS,
               "s_per_forward_resident": resident_s,
               "s_per_forward_resident_runs": resident_times, "streamed": rates,
               "pcie5_x16_gb_per_s": PCIE5_X16_BYTES_PER_S / 1e9,
               "overlap": overlap, "peak_mem_bytes": peak, "peak_bound_bytes": bound,
               "streamed_pair_bytes": pair_bytes, "activation_bytes": activations,
               "logits_equal_resident": equal, "flash_fwd_launches": launches, "card": card}
        print(json.dumps(rec), flush=True)
        if tiers != ["cpu", "device", "disk"]:
            raise AssertionError(f"the solved map does not use device, cpu and disk: {bw.device_map}")
        if not all(equal):
            raise AssertionError(f"streamed bf16 logits differ from the resident model's: {equal}")
        if not peak <= bound:
            raise AssertionError(f"streamed forward's peak {peak} B above its bound {bound} B")
        if launches != cfg.num_layers * BIG_MIXTRAL_FORWARDS:
            raise AssertionError(f"flash forward launches {launches}, expected "
                                 f"{cfg.num_layers * BIG_MIXTRAL_FORWARDS}")
        del bw, outs, first
        gc.collect()
        torch.cuda.empty_cache()
        hook = offload_with_hook_pair(torch, cfg, ckpt, ids, want, model_bytes, activations, card)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(off, ignore_errors=True)
    predicted = {"phase": "big_mixtral_full_model_prediction",
                 **full_model_prediction(torch, rates, overlap, resident_s / cfg.num_layers,
                                         activations), "card": card}
    print(json.dumps(predicted), flush=True)
    return {"flash_attention_fwd": launches + hook["launches"],
            "line": rec, "hook": hook, "prediction": predicted}


def full_model_prediction(torch, rates: dict, overlap: dict, layer_compute_s: float,
                          activations: int, free_bytes: int | None = None) -> dict:
    """Seconds per forward that this run's rates predict for the full
    32-layer bf16 Mixtral-8x7B over the cpu tier: the device holds 0.9 of
    its free memory less the activations and the two streamed layers in
    flight (current and prefetched); the rest streams at the cpu tier's
    measured GB/s, of which only the measured share hides under compute;
    compute is the resident forward's seconds a layer (the median of
    RESIDENT_TIMED_FORWARDS) times 32."""
    full = mixtral_config(torch, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    counts = mixtral_param_counts(full)
    full_bytes, layer_bytes = 2 * counts["total"], 2 * counts["layer"]
    if free_bytes is None:
        free_bytes = torch.cuda.mem_get_info()[0]
    budget = 0.9 * free_bytes - activations - 2 * layer_bytes
    streamed = max(0.0, full_bytes - budget)
    copy_s = streamed / (rates["cpu"]["gb_per_s"] * 1e9)
    hidden = overlap["hidden_share"] or 0.0
    compute_s = layer_compute_s * full.num_layers
    return {"layers": full.num_layers, "model_bytes": full_bytes, "layer_bytes": layer_bytes,
            "device_budget_bytes": budget, "streamed_bytes_per_forward": streamed,
            "copy_s": copy_s, "hidden_share": hidden, "compute_s": compute_s,
            "predicted_s_per_forward": copy_s * (1.0 - hidden) + compute_s,
            "basis": "0.9 of the card's free memory less activations and two streamed layers "
                     "holds layers; the rest at the cpu tier's measured GB/s; exposed copy "
                     "time (1 - measured hidden share) plus the resident forward's s a layer "
                     "x 32"}


def offload_with_hook_pair(torch, cfg, ckpt: str, ids, want, model_bytes: int,
                           activations: int, card: str) -> dict:
    """`cpu_offload_with_hook` over two Mixtral models of one pinned state
    dict, the second given the first's hook: each call keeps its model on
    the card; entering the second frees the first's copies (the second's
    peak stays within what the first held, the activations and 1 MiB of
    allocator rounding a tensor), and its ``offload()``
    brings the allocated memory back within 1 MiB. Both give the resident
    logits bit for bit."""
    from accelerate_tpu_torch.big_modeling import _leaves, _tree_map, cpu_offload_with_hook
    from accelerate_tpu_torch.checkpointing import load_model_weights
    from accelerate_tpu_torch.models.mixtral import mixtral_blockwise
    from accelerate_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    sd = _tree_map(lambda t: t.pin_memory(), load_model_weights(ckpt))
    pin_s = time.perf_counter() - t0
    n_tensors = len(_leaves(sd))
    m1, hook1 = cpu_offload_with_hook(mixtral_blockwise(cfg), sd)
    m2, hook2 = cpu_offload_with_hook(mixtral_blockwise(cfg), sd, prev_module_hook=hook1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_counts(fa)
    with torch.no_grad():
        a = m1(ids)
        torch.cuda.synchronize()
        held_first = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        b = m2(ids)
        torch.cuda.synchronize()
        peak_second = torch.cuda.max_memory_allocated() - base
    first_evicted = not m1._cache
    equal = [bool(torch.equal(a, want)), bool(torch.equal(b, want))]
    hook2.offload()
    del a, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    back = torch.cuda.memory_allocated() - base
    launches = fa.flash_attention_fwd.launches
    rec = {"phase": "bf16_big_mixtral_offload_with_hook", "pin_s": pin_s,
           "held_after_first_bytes": held_first, "peak_during_second_bytes": peak_second,
           "model_bytes": model_bytes, "first_evicted": first_evicted,
           "allocated_after_offload_delta_bytes": back, "logits_equal_resident": equal,
           "card": card}
    print(json.dumps(rec), flush=True)
    if not (held_first >= model_bytes and first_evicted and all(equal)):
        raise AssertionError(f"cpu_offload_with_hook: {rec}")
    # had the first model's copies stayed, the peak would hold both models
    if not peak_second <= held_first + activations + n_tensors * MIB:
        raise AssertionError(f"entering the second model did not free the first's copies: {rec}")
    if abs(back) > MIB:
        raise AssertionError(f"offload() left {back} B allocated: {rec}")
    del m1, m2, hook1, hook2, sd
    gc.collect()
    return {"launches": launches, **rec}


def mixtral_train_parity(torch, np, seed: int, card: str) -> dict:
    """Phase 30 (c), first: one fp32 step (TF32 off) of Mixtral-8x7B width
    at 1 layer, batch 1 x 1024, router aux loss included, from the same
    weights and batch three ways: `mixtral_loss_fn` with
    ``attention_impl="xla"``, the same with ``"flash"``, and
    `mixtral_loss_fn_fused` with ``"flash"``. Flash against plain attention
    (phase 7's bars) and the fused loss against the plain one (phase 10's):
    loss and global gradient norm agree; each flash kernel ran once in each
    flash step, each fused-CE kernel once in the fused step and never in
    the others. Returns the launches by kernel."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.mixtral import (MixtralForCausalLM, mixtral_loss_fn,
                                                     mixtral_loss_fn_fused)
    from accelerate_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 32000, (1, 1024))).to("cuda")
    out = {}
    for key, impl, loss_fn in (("xla", "xla", mixtral_loss_fn),
                               ("flash", "flash", mixtral_loss_fn),
                               ("flash_fused", "flash", mixtral_loss_fn_fused)):
        model = MixtralForCausalLM(mixtral_config(torch, num_layers=1, dtype=torch.float32,
                                                  attention_impl=impl), seed=seed)
        acc = Accelerator(mixed_precision="no")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4))
        step = acc.make_train_step(loss_fn, max_grad_norm=1e30)
        reset_counts(fa)
        loss = step({"input_ids": ids}).item()
        out[key] = (loss, step.grad_norm.item(), {**flash_counts(fa), **fused_ce_counts()})
        del model, acc, step
        gc.collect()
        torch.cuda.empty_cache()
    (loss_x, norm_x, counts_x), (loss_f, norm_f, counts_f), (loss_c, norm_c, counts_c) = (
        out["xla"], out["flash"], out["flash_fused"])
    rec = {"phase": "fp32_mixtral_train_parity", "layers": 1, "batch": 1, "seq": 1024,
           "loss_plain": loss_x, "loss_flash": loss_f, "loss_abs_diff": abs(loss_f - loss_x),
           "loss_flash_fused_ce": loss_c, "loss_fused_ce_abs_diff": abs(loss_c - loss_f),
           "loss_atol": TRAIN_LOSS_ATOL, "grad_norm_plain": norm_x, "grad_norm_flash": norm_f,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x,
           "grad_norm_flash_fused_ce": norm_c,
           "grad_norm_fused_ce_rel_diff": abs(norm_c - norm_f) / norm_f,
           "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL, "launches_plain": counts_x,
           "launches": counts_f, "launches_fused_ce": counts_c, "card": card}
    print(json.dumps(rec), flush=True)
    for what, (loss_a, norm_a), (loss_b, norm_b) in (
            ("flash against plain attention", (loss_f, norm_f), (loss_x, norm_x)),
            ("fused CE against the plain loss", (loss_c, norm_c), (loss_f, norm_f))):
        if not (abs(loss_a - loss_b) <= TRAIN_LOSS_ATOL and math.isfinite(loss_a)):
            raise AssertionError(f"fp32 Mixtral step, {what}: loss {loss_a} vs {loss_b}")
        if not abs(norm_a - norm_b) <= TRAIN_GRAD_NORM_RTOL * norm_b:
            raise AssertionError(f"fp32 Mixtral step, {what}: grad norm {norm_a} vs {norm_b}")
    once, never = dict.fromkeys(FLASH_REPLACES, 1), dict.fromkeys(FUSED_CE_REPLACES, 0)
    if (counts_x != {**dict.fromkeys(FLASH_REPLACES, 0), **never}
            or counts_f != {**once, **never}
            or counts_c != {**once, **dict.fromkeys(FUSED_CE_REPLACES, 1)}):
        raise AssertionError(f"fp32 Mixtral step launches: plain {counts_x}, flash {counts_f}, "
                             f"flash with fused CE {counts_c}")
    return {n: counts_f[n] + counts_c[n] for n in counts_c}


def train_mixtral(torch, np, seed: int, card: str, warmup: int = 2, steps: int = 10) -> dict:
    """Phase 30 (c): Mixtral-8x7B width at 2 layers, fp32 masters,
    ``Accelerator(mixed_precision="bf16")``, AdamW (lr 1e-4, weight decay
    1e-4), ``make_train_step(mixtral_loss_fn_fused)`` with
    ``attention_impl="flash"`` on one seeded 1 x MIXTRAL_TRAIN_SEQ batch,
    repeated: ``warmup`` then ``steps`` timed steps. The loss is finite and
    falls; each step launches each flash kernel once a layer and each
    fused-CE kernel once. Step ms, tokens/s, MFU on active FLOPs (top-2 of 8
    experts) and on executed FLOPs (every expert's capacity slots and the
    dispatch and combine products), peak memory; then a profiler window
    split by `MOE_KINDS`."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_loss_fn_fused
    from accelerate_tpu_torch.ops import flash_attention as fa

    batch, seq = 1, MIXTRAL_TRAIN_SEQ
    cfg = mixtral_config(torch, num_layers=2, attention_impl="flash")
    model = MixtralForCausalLM(cfg, seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(mixtral_loss_fn_fused)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    data = {"input_ids": torch.from_numpy(ids).to("cuda")}
    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = {**flash_counts(fa), **fused_ce_counts()}
    flops = mixtral_train_flops_per_token(cfg, seq)
    tokens_per_s = batch * seq * steps / wall
    peak_rate = bf16_peak(torch.cuda.get_device_name(0))
    rec = {"phase": "bf16_train_mixtral", "model": "mixtral-8x7b-width, 2 layers",
           "batch": batch, "seq": seq, "params": sum(p.numel() for p in model.parameters()),
           "capacity": flops["capacity"], "capacity_factor": cfg.capacity_factor,
           "warmup_steps": warmup, "steps": steps, "step_ms": wall / steps * 1e3,
           "tokens_per_s": tokens_per_s,
           "mfu_active": tokens_per_s * flops["active"] / peak_rate,
           "mfu_executed": tokens_per_s * flops["executed"] / peak_rate,
           "flops_per_token_active": flops["active"],
           "flops_per_token_executed": flops["executed"],
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "launches": counts, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral training: the loss did not fall: {losses}")
    expected = {**{n: cfg.num_layers * steps for n in FLASH_REPLACES},
                **{n: steps for n in FUSED_CE_REPLACES}}
    if counts != expected:
        raise AssertionError(f"bf16_train_mixtral launches {counts}, expected {expected}")
    prof = {"phase": "bf16_train_mixtral_profile", **profile_mixtral_step(
        torch, lambda: step(data), cfg, seq), "card": card}
    print(json.dumps(prof), flush=True)
    del model, acc, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "line": rec, "profile": prof}


def big_models_phase(torch, np, seed: int, card: str) -> dict:
    """Phase 30: big models on one card: first the flash and fused-CE
    kernels against their plain versions at the Mixtral train step's
    shapes, then (a) `blockwise_parity`, (b) `big_mixtral_streaming`, (c)
    `mixtral_train_parity` and `train_mixtral`. Returns the phase's
    launches of #2-#4 and #8-#10 and the two kernel cases."""
    t0 = time.perf_counter()
    # the Mixtral train step's kernel shapes against the plain versions:
    # attention b 1, 32 heads (the 8 kv heads repeated), s 4096, d 128,
    # causal; the head N 4096 x e 4096 by V 32000, each row's last label
    # ignored as next-token labels ignore it
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    flash = flash_case(torch, "mixtral_train_bf16_causal", b=1, h=32, s=MIXTRAL_TRAIN_SEQ,
                       d=128, dtype=torch.bfloat16, causal=True, seed=seed + 30, flush=flush)
    fused = fused_ce_case(torch, "mixtral_head_n4096_bf16", n=MIXTRAL_TRAIN_SEQ, v=32000,
                          e=4096, dtype=torch.bfloat16, ignore_every=MIXTRAL_TRAIN_SEQ,
                          seed=seed + 31, flush=flush)
    del flush
    torch.cuda.empty_cache()
    parity = blockwise_parity(torch, np, seed, card)
    streaming = big_mixtral_streaming(torch, np, seed, card)
    fp32_step = mixtral_train_parity(torch, np, seed, card)
    train = train_mixtral(torch, np, seed, card)
    launches = {n: fp32_step[n] + train["launches"][n] for n in (*FLASH_REPLACES,
                                                                 *FUSED_CE_REPLACES)}
    launches["flash_attention_fwd"] += (parity["flash_attention_fwd"]
                                        + streaming["flash_attention_fwd"])
    print(json.dumps({"phase": "big_models_phase_s", "seconds": time.perf_counter() - t0,
                      "launches": launches, "card": card}), flush=True)
    return {"launches": launches, "flash_case": flash, "fused_case": fused}


# phase 31: T5-v1.1-base training on the fused-CE kernels, ViT-B/16, and the
# one-process inference examples. T5-v1.1-base's head: batch 16 x target 128
# rows of e 768 against its untied 32128-entry vocabulary
T5_TRAIN_BATCH, T5_SRC, T5_TGT = 16, 512, 128
# the fp32 parity step (phase 31 (b)): full width, 2 + 2 layers, batch 2
T5_PARITY_BATCH, T5_PARITY_LAYERS = 2, 2
# device kernels of the T5 step by kind: the port's fused-CE kernels and
# AdamW's multi-tensor kernels by name, every other kernel by the innermost
# op over its launch (T5LayerNorm is plain tensor code: its rsqrt and mean,
# forward and backward, stand for it; its products fall to the rest)
T5_KERNEL_KINDS = (("fused-CE kernels", r"fused_ce_(fwd|bwd)_kernel"),
                   ("AdamW", r"multi_tensor_apply"))
T5_OP_CATEGORIES = (
    ("GEMMs", ("aten::mm", "aten::addmm", "MmBackward", "AddmmBackward")),
    ("plain attention", ("aten::bmm", "aten::_softmax", "aten::_softmax_backward_data",
                         "BmmBackward", "SoftmaxBackward")),
    ("norms", ("aten::rsqrt", "aten::mean", "aten::native_layer_norm", "RsqrtBackward",
               "MeanBackward", "NativeLayerNormBackward")),
    ("copies and casts", ("aten::_to_copy", "aten::copy_", "aten::contiguous", "ToCopyBackward")),
    ("AdamW", ("aten::_foreach_", "Optimizer.step")),
)
# ViT-B/16 fp32 logits (TF32 off), the card against the CPU from the same
# weights: 12 blocks of products summed in other orders; logits of size ~1
VIT_CARD_ATOL = 1e-4
VIT_TRAIN_BATCH = 128


def t5_train_flops(cfg, batch: int, src: int, tgt: int) -> dict[str, float]:
    """FLOPs of one T5 training step (forward and backward, 3 x the forward's
    2 x multiply-adds): 6 per matmul parameter a token for the encoder's
    projections over the source tokens, the decoder's (self, cross and
    feed-forward) and the head's over the target tokens, and 12 x ``heads x
    d_kv`` a query-key pair for attention (QK^T and PV) over the encoder's
    src x src, the decoder's tgt x tgt and its cross tgt x src pairs, all
    counted in full (masked pairs too, as the plain path computes them).
    The parts and their ``total``."""
    e, inner, f = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    ff = (3 if cfg.gated_ffn else 2) * e * f
    attn = 4 * e * inner
    parts = {
        "encoder_projections": 6.0 * cfg.num_layers * (attn + ff) * batch * src,
        "decoder_projections": 6.0 * cfg.num_decoder_layers * (2 * attn + ff) * batch * tgt,
        "head": 6.0 * cfg.vocab_size * e * batch * tgt,
        "attention": 12.0 * inner * batch * (cfg.num_layers * src * src
                                             + cfg.num_decoder_layers * (tgt * tgt + tgt * src)),
    }
    parts["total"] = sum(parts.values())
    return parts


def t5_batch(torch, cfg, seed: int, batch: int, src: int, tgt: int) -> dict:
    """A seeded T5 batch on the card: source ids with a padded tail on every
    second row (``attention_mask``), labels with a padded tail (-100) on
    every second row, the decoder inputs shifted from them and their mask."""
    from accelerate_tpu_torch.models.t5 import shift_tokens_right

    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, src), generator=g, device="cuda")
    labels = torch.randint(1, cfg.vocab_size, (batch, tgt), generator=g, device="cuda")
    src_mask = torch.ones(batch, src, dtype=torch.long, device="cuda")
    src_mask[1::2, src * 3 // 4:] = 0
    labels[1::2, tgt * 5 // 8:] = -100
    return {"input_ids": ids, "attention_mask": src_mask,
            "decoder_input_ids": shift_tokens_right(labels),
            "decoder_attention_mask": (labels != -100).long(), "labels": labels}


def t5_fp32_parity(torch, np, seed: int, card: str) -> list[dict]:
    """Phase 31 (b): one fp32 step (TF32 off) of T5-v1.1-base's width at
    2 + 2 layers, batch 2, source 512, target 128, padded labels, with
    `seq2seq_loss_fn_fused` and one with `seq2seq_loss_fn`, untied and tied:
    loss and global gradient norm agree within phase 10's bars and each
    fused-CE kernel ran once in the fused step, never in the dense one."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.t5 import (
        T5Config,
        T5ForConditionalGeneration,
        seq2seq_loss_fn,
        seq2seq_loss_fn_fused,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa

    recs = []
    for tied in (False, True):
        cfg = T5Config.base(num_layers=T5_PARITY_LAYERS, num_decoder_layers=T5_PARITY_LAYERS,
                            dtype=torch.float32, tie_word_embeddings=tied)
        data = t5_batch(torch, cfg, seed, T5_PARITY_BATCH, T5_SRC, T5_TGT)
        out = {}
        for fn in (seq2seq_loss_fn, seq2seq_loss_fn_fused):
            model = T5ForConditionalGeneration(cfg, seed=seed)
            acc = Accelerator(mixed_precision="no")
            model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                            weight_decay=1e-4))
            step = acc.make_train_step(fn, max_grad_norm=1e30)
            reset_counts(fa)
            loss = step(data).item()
            out[fn.__name__] = (loss, step.grad_norm.item(), fused_ce_counts())
            del model, acc, step
            gc.collect()
            torch.cuda.empty_cache()
        (loss_p, norm_p, counts_p), (loss_f, norm_f, counts) = (out["seq2seq_loss_fn"],
                                                                out["seq2seq_loss_fn_fused"])
        rec = {"phase": f"fp32_t5_fused_ce_parity_{'tied' if tied else 'untied'}",
               "model": f"t5-v1_1-base width, {T5_PARITY_LAYERS} + {T5_PARITY_LAYERS} layers",
               "batch": T5_PARITY_BATCH, "src": T5_SRC, "tgt": T5_TGT,
               "ignored_labels": int((data["labels"] == -100).sum().item()),
               "loss_plain": loss_p, "loss_fused": loss_f, "loss_abs_diff": abs(loss_f - loss_p),
               "loss_atol": TRAIN_LOSS_ATOL, "grad_norm_plain": norm_p, "grad_norm_fused": norm_f,
               "grad_norm_rel_diff": abs(norm_f - norm_p) / norm_p,
               "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL, "launches": counts,
               "launches_plain": counts_p, "card": card}
        print(json.dumps(rec), flush=True)
        if not (abs(loss_f - loss_p) <= TRAIN_LOSS_ATOL and math.isfinite(loss_f)):
            raise AssertionError(f"{rec['phase']}: fused loss {loss_f} vs dense {loss_p}")
        if not abs(norm_f - norm_p) <= TRAIN_GRAD_NORM_RTOL * norm_p:
            raise AssertionError(f"{rec['phase']}: fused grad norm {norm_f} vs dense {norm_p}")
        if counts != {n: 1 for n in FUSED_CE_REPLACES} or any(counts_p.values()):
            raise AssertionError(f"{rec['phase']}: launches {counts} (dense {counts_p}), "
                                 "expected 1 each (0 each)")
        recs.append(rec)
    return recs


def train_t5(torch, np, seed: int, card: str, warmup: int = 2, steps: int = 10) -> dict:
    """Phase 31 (c): T5-v1.1-base uncut (`T5Config.base()`: 12 + 12 layers,
    untied head), fp32 masters, ``Accelerator(mixed_precision="bf16")``,
    AdamW (lr 1e-4, weight decay 1e-4), ``make_train_step(
    seq2seq_loss_fn_fused)`` on one seeded batch of 16 x (512 source, 128
    target) tokens with padded tails, repeated: ``warmup`` then ``steps``
    timed steps with the launch counts set to 0 just before them. The loss
    falls and each fused-CE kernel ran once a timed step; step ms, source
    and target tokens/s, MFU by `t5_train_flops`, peak memory; then a
    profiler window over 3 steps by kind (`T5_OP_CATEGORIES`)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.t5 import (
        T5Config,
        T5ForConditionalGeneration,
        seq2seq_loss_fn_fused,
    )

    cfg = T5Config.base()
    model = T5ForConditionalGeneration(cfg, seed=seed)
    acc = Accelerator(mixed_precision="bf16")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(seq2seq_loss_fn_fused)
    data = t5_batch(torch, cfg, seed, T5_TRAIN_BATCH, T5_SRC, T5_TGT)
    losses, wall = timed_steps(torch, step, data, warmup, steps)
    counts = fused_ce_counts()
    peak = torch.cuda.max_memory_allocated()
    flops = t5_train_flops(cfg, T5_TRAIN_BATCH, T5_SRC, T5_TGT)
    step_s = wall / steps
    rec = {"phase": "bf16_train_t5_base", "model": "t5-v1_1-base, 12 + 12 layers",
           "batch": T5_TRAIN_BATCH, "src": T5_SRC, "tgt": T5_TGT,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warmup, "steps": steps, "step_ms": step_s * 1e3,
           "src_tokens_per_s": T5_TRAIN_BATCH * T5_SRC / step_s,
           "tgt_tokens_per_s": T5_TRAIN_BATCH * T5_TGT / step_s,
           "train_flops_per_step": flops,
           "mfu": flops["total"] / step_s / bf16_peak(torch.cuda.get_device_name(0)),
           "peak_mem_bytes": peak, "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": counts, "tf32": False, "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"T5 training: the loss did not fall: {losses}")
    if counts != {n: steps for n in FUSED_CE_REPLACES}:
        raise AssertionError(f"T5 training launches {counts}, expected {steps} of each")
    prof = profile_by_op(torch, lambda: step(data), 3, categories=T5_OP_CATEGORIES,
                         kernel_kinds=T5_KERNEL_KINDS)
    del prof["layout_copies_ms_per_step_by_caller"]
    rec["profile"] = {"phase": "bf16_train_t5_base_profile", **prof, "card": card}
    print(json.dumps(rec["profile"]), flush=True)
    del model, acc, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def vit_card_and_training(torch, seed: int, card: str, steps: int = 10) -> dict:
    """Phase 31 (d): ViT-B/16 at 224 x 224 and 1000 labels, uncut. One fp32
    forward (TF32 off) of 4 images on the card against the CPU's from the
    same weights, within VIT_CARD_ATOL; then ``steps`` timed bf16 steps at
    batch 128 with AdamW and `vit_loss_fn` after 2 warm-up steps: images/s,
    MFU (3 x `ViTForImageClassification.forward_flops` an image), peak
    memory."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.vit import ViTConfig, ViTForImageClassification, vit_loss_fn

    cpu = ViTForImageClassification(ViTConfig.base(dtype=torch.float32), device="cpu", seed=seed)
    gpu = ViTForImageClassification(ViTConfig.base(dtype=torch.float32), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    images = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want, got = cpu(images), gpu(images.cuda()).cpu()
    err = (got - want).abs().max().item()
    parity = {"phase": "fp32_vit_b16_card_vs_cpu", "images": 4, "max_abs_err": err,
              "atol": VIT_CARD_ATOL, "logit_max_abs": want.abs().max().item(), "tf32": False,
              "card": card}
    print(json.dumps(parity), flush=True)
    if not (math.isfinite(err) and err <= VIT_CARD_ATOL):
        raise AssertionError(f"ViT-B/16 card against CPU: {err} > {VIT_CARD_ATOL}")
    del cpu, gpu

    acc = Accelerator(mixed_precision="bf16")
    model = ViTForImageClassification(ViTConfig.base(), seed=seed)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = acc.make_train_step(vit_loss_fn)
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"pixel_values": torch.randn(VIT_TRAIN_BATCH, 3, 224, 224, device="cuda", generator=g),
             "labels": torch.randint(0, 1000, (VIT_TRAIN_BATCH,), device="cuda", generator=g)}
    losses, wall = timed_steps(torch, step, batch, warmup=2, steps=steps)
    flops = 3 * model.module.forward_flops()
    images_per_s = VIT_TRAIN_BATCH * steps / wall
    rec = {"phase": "bf16_vit_b16_b128", "batch": VIT_TRAIN_BATCH, "steps": steps,
           "step_ms": wall / steps * 1e3, "images_per_s": images_per_s,
           "train_flops_per_image": flops,
           "mfu": images_per_s * flops / bf16_peak(torch.cuda.get_device_name(0)),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "losses": losses, "tf32": False,
           "card_vs_cpu": parity, "card": card}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ViT-B/16 training: a loss is not finite: {losses}")
    del acc, model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def inference_examples_on_card(card: str) -> dict:
    """Phase 31 (e): the port's `examples/inference/distributed/`
    `image_classification.py` and `batch_text_generation.py` at their
    defaults (CUDA), as ``python -m`` children started together: each exits
    0, the first prints 10 predictions, the second 5 generated rows."""
    names = ("image_classification", "batch_text_generation")
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, "-m",
                                  f"accelerate_tpu_torch.examples.inference.distributed.{n}"],
                                 cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for n in names}
    outs = {}
    for n, p in procs.items():
        try:
            outs[n] = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    lines = {n: outs[n][0].splitlines() for n in names}
    preds = json.loads(lines["image_classification"][1]) if len(
        lines["image_classification"]) > 1 else []
    rows = [line for line in lines["batch_text_generation"] if line.startswith("prompt ")]
    rec = {"phase": "inference_examples", "returncodes": {n: p.returncode for n, p in procs.items()},
           "predictions": preds, "generated_rows": rows, "wall_s": wall, "card": card}
    print(json.dumps(rec), flush=True)
    if any(p.returncode for p in procs.values()):
        raise AssertionError("an inference example failed: " + json.dumps(
            {n: outs[n][1][-2000:] for n, p in procs.items() if p.returncode}))
    if len(preds) != 10 or len(rows) != 5:
        raise AssertionError(f"inference examples: {len(preds)} predictions (10 expected), "
                             f"{len(rows)} generated rows (5 expected)")
    return rec


def t5_vit_phase(torch, np, seed: int, card: str) -> dict:
    """Phase 31: (a) the fused-CE kernels #8-#10 against their plain versions
    at T5-v1.1-base's head (bf16, N 2048, e 768, V 32128, every sixteenth
    label ignored); (b) `t5_fp32_parity`; (c) `train_t5`; (d)
    `vit_card_and_training`; (e) `inference_examples_on_card`. Returns the
    phase's #8-#10 launches (the parity steps' and the timed steps') and
    the kernel case."""
    t0 = time.perf_counter()
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fused = fused_ce_case(torch, "t5_base_head_n2048_bf16", n=T5_TRAIN_BATCH * T5_TGT, v=32128,
                          e=768, dtype=torch.bfloat16, ignore_every=16, seed=seed + 40,
                          flush=flush)
    del flush
    torch.cuda.empty_cache()
    parity = t5_fp32_parity(torch, np, seed, card)
    train = train_t5(torch, np, seed, card)
    vit = vit_card_and_training(torch, seed, card)
    examples = inference_examples_on_card(card)
    launches = {n: train["launches"][n] + sum(r["launches"][n] for r in parity)
                for n in FUSED_CE_REPLACES}
    print(json.dumps({"phase": "t5_vit_phase_s", "seconds": time.perf_counter() - t0,
                      "launches": launches, "t5_step_ms": train["step_ms"], "t5_mfu": train["mfu"],
                      "vit_images_per_s": vit["images_per_s"],
                      "examples_wall_s": examples["wall_s"], "card": card}), flush=True)
    return {"launches": launches, "fused_case": fused}


# phase 32: data-parallel training across processes, through the launcher.
# (a) one NCCL rank at phase 29's bf16 variant; (b) two ranks sharing the
# card over gloo against one process on the whole batch; (c) the collectives
# and the multi-process metrics example at two ranks.
DP_LR = 1e-4
DP_STEPS = 3
# (b), fp32 with TF32 off: 2 ranks of 4 x 512 against 1 process of 8 x 512.
# Only the order of the gradient mean's sum differs (and the fused loss's
# split over 2048 rows instead of 4096): every loss within 1e-5 relative;
# every parameter within 2 lr a step of the one-process run's (AdamW moves
# an element at most about lr a step: where a gradient nearly cancels, near
# eps, the other summation order changes its update by a large share of
# lr), and all but a millionth of them within 5% of lr
DP_LOSS_RTOL = 1e-5
DP_PARAM_SHARE = 1 - 1e-6
# the bf16 hook rounds each rank's gradient and their sum to 8 bits; where
# the ranks' gradients nearly cancel the rounded mean can change sign and
# AdamW moves that element by about lr either way: the loss within 1e-3
# relative, every parameter within 2 lr a step, 99% within 5% of lr
DP_BF16_LOSS_RTOL = 1e-3
DP_BF16_PARAM_SHARE = 0.99
DP_TIMEOUT_S = 300

DATA_PARALLEL_CHILD = r"""
import hashlib, json, math, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn_pallas
from accelerate_tpu_torch.ops import flash_attention as fa, fused_ce
from accelerate_tpu_torch.parallel.compression import CommHookConfig
from accelerate_tpu_torch.utils import operations as ops
from accelerate_tpu_torch.utils.dataclasses import InitProcessGroupKwargs

spec = json.loads(sys.argv[1])
seed = spec["seed"]
DP_LR, DP_STEPS = spec.get("lr"), spec.get("steps")
KERNELS = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv,
           fused_ce.fused_ce_fwd, fused_ce.fused_ce_dh, fused_ce.fused_ce_dw)


def emit(rec):
    print(json.dumps(rec), flush=True)


def nccl_world1():
    acc = Accelerator(mixed_precision="bf16")
    cfg = GPT2Config.small(dtype=torch.bfloat16, attention_impl="flash")
    model = GPT2LMHead(cfg, device=acc.device, seed=seed)
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn_pallas)
    rng = np.random.default_rng(seed)  # phase 29's two batches
    batches = [{"input_ids": torch.from_numpy(rng.integers(0, 50257, (8, 1024))).to(acc.device)}
               for _ in range(2)]
    losses = [step(batches[i % 2]).item() for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    timed = [step(batches[i % 2]) for i in range(10)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += [t.item() for t in timed]
    emit({"phase": "data_parallel_nccl_world1", "backend": acc.state.partial.backend,
          "world": acc.num_processes, "device": str(acc.device), "distributed_type":
          str(acc.distributed_type), "model": "gpt2-small", "batch": 8, "seq": 1024,
          "steps": 10, "step_ms": wall / 10 * 1e3, "tokens_per_s": 8 * 1024 * 10 / wall,
          "losses": losses, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": {k.__name__: k.launches for k in KERNELS}})


class AllReduceMeter:
    # bytes and host seconds of every all_reduce (gloo runs them on host copies)
    def __init__(self):
        self.bytes = self.calls = 0
        self.seconds = 0.0
        self.inner = dist.all_reduce
        dist.all_reduce = self

    def __call__(self, tensor, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.inner(tensor, *args, **kwargs)
        self.seconds += time.perf_counter() - t0
        self.bytes += tensor.numel() * tensor.element_size()
        self.calls += 1
        return out

    def take(self):
        out = (self.bytes, self.seconds, self.calls)
        self.bytes = self.calls = 0
        self.seconds = 0.0
        return out


def gloo_two_ranks():
    init = InitProcessGroupKwargs(backend="gloo", timeout_seconds=300)
    ref = torch.load(spec["reference"], weights_only=False)
    meter = AllReduceMeter()
    ids = np.random.default_rng(seed + 1).integers(0, 50257, (8, 512))  # one fixed global batch

    def run(hook, steps, start=2):
        acc = Accelerator(device="cuda:0", kwargs_handlers=[init])
        r, n = acc.process_index, acc.num_processes
        model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl="flash"),
                           device=acc.device, seed=seed)
        model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=DP_LR,
                                                          weight_decay=1e-4))
        cfg = None if hook is None else CommHookConfig(hook, start_powerSGD_iter=start)
        step = acc.make_train_step(lm_loss_fn_pallas, comm_hook=cfg)
        per = 8 // n
        losses, step_s, reduced = [], [], []
        meter.take()
        for i in range(steps):
            batch = {"input_ids": torch.from_numpy(ids[r * per:(r + 1) * per]).to(acc.device)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(batch).item())
            step_s.append(time.perf_counter() - t0)
            reduced.append(meter.take())
        digests = ops.gather_object([hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in model.module.parameters())).hexdigest()])
        params = {k: p.detach().cpu() for k, p in model.module.named_parameters()}
        return acc, losses, step_s, reduced, digests, params

    def against(params, losses, want):
        # the key third of each qkv bias apart: its gradient is zero in exact
        # arithmetic, so both runs move it by Adam-scaled rounding noise
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
        diffs, key = [], 0.0
        for k, p in params.items():
            d = (p - want["params"][k]).abs().reshape(-1)
            if k.endswith("attn.qkv.bias"):
                e = d.shape[0] // 3
                key = max(key, float(d[e:2 * e].max()))
                d = torch.cat([d[:e], d[2 * e:]])
            diffs.append(d)
        d = torch.cat(diffs)
        return {"loss_max_rel_diff": loss_rel, "param_max_abs_diff": float(d.max()),
                "param_share_within_lr_20th": float((d <= 0.05 * DP_LR).double().mean()),
                "qkv_key_bias_max_abs_diff": key}

    for hook, steps in ((None, DP_STEPS), ("bf16", DP_STEPS), ("power_sgd", 2 * DP_STEPS)):
        acc, losses, step_s, reduced, digests, params = run(hook, steps)
        name = hook or "plain"
        rec = {"phase": f"data_parallel_gloo_{name}", "backend": acc.state.partial.backend,
               "world": acc.num_processes, "device": str(acc.device), "model": "gpt2-small",
               "dtype": "float32", "global_batch": [8, 512], "steps": steps, "losses": losses,
               "step_ms": [t * 1e3 for t in step_s],
               "all_reduce_bytes_per_step": [b for b, _, _ in reduced],
               "all_reduce_ms_per_step": [t * 1e3 for _, t, _ in reduced],
               "all_reduce_calls_per_step": [c for _, _, c in reduced],
               "ranks_bit_equal": len(set(digests)) == 1}
        if hook == "power_sgd":
            rec.update({"rank": 1, "start_powerSGD_iter": 2,
                        "loss_falls": losses[-1] < losses[0]})
        else:
            rec.update({"one_process_losses": ref["losses"], **against(params, losses, ref)})
        if acc.is_main_process:
            emit(rec)
        del acc, params

    # the reference's test_multiprocess_ops checks, on CUDA tensors
    acc = Accelerator(device="cuda:0", kwargs_handlers=[init])
    r, n, dev = acc.process_index, acc.num_processes, acc.device
    checks = {
        "gather": ops.gather(torch.full((2,), float(r), device=dev)).tolist()
        == [float(i) for i in range(n) for _ in range(2)],
        "gather_ragged": ops.gather(torch.arange(r + 1, device=dev)).tolist()
        == [x for i in range(n) for x in range(i + 1)],
        "gather_object": ops.gather_object([f"proc{r}"]) == [f"proc{i}" for i in range(n)],
        "broadcast_last": ops.broadcast(torch.full((3,), float(r + 5), device=dev),
                                        from_process=n - 1).tolist() == [float(n + 4)] * 3,
        "broadcast_object_list_last": ops.broadcast_object_list([f"payload{r}", r * 10],
                                                                from_process=n - 1)
        == [f"payload{n - 1}", (n - 1) * 10],
        "pad_across_processes": ops.pad_across_processes(torch.arange(float(r + 1), device=dev)
                                                         ).tolist()
        == [float(x) for x in range(r + 1)] + [0.0] * (n - 1 - r),
        "reduce": ops.reduce(torch.tensor([1.0 + r], device=dev), reduction="sum").tolist()
        == [sum(1.0 + i for i in range(n))],
        "results_on_device": ops.gather(torch.zeros(1, device=dev)).device == dev,
    }
    everyone = ops.gather_object([checks])
    if acc.is_main_process:
        emit({"phase": "data_parallel_collectives", "backend": acc.state.partial.backend,
              "world": n, "device": str(dev), "checks": everyone,
              "ok": all(all(c.values()) for c in everyone)})
    acc.state.partial.shutdown()


{"nccl": nccl_world1, "gloo": gloo_two_ranks}[spec["mode"]]()
"""


def launch_child(args: list[str], timeout: float = DP_TIMEOUT_S) -> tuple[list[dict], str, float]:
    """``python -m accelerate_tpu_torch.commands.launch`` with ``args`` from the
    repository root: (the JSON lines it printed, its stdout, seconds); raises
    on a non-zero exit or past ``timeout``."""
    import os

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}  # for a script outside ROOT
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.launch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"launch {args[:6]} exited {out.returncode}:\n{out.stdout[-4000:]}\n"
                             f"{out.stderr[-8000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    return lines, out.stdout, seconds


def dp_one_process_reference(torch, np, seed: int, path: Path) -> dict:
    """Phase 32 (b)'s yardstick: GPT-2 small fp32 (TF32 off), flash and the
    fused loss, 3 AdamW steps in this process on the whole 8 x 512 batch
    (one, repeated); the losses and final parameters go to ``path``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn_pallas

    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32, attention_impl="flash"),
                       device="cuda", seed=seed)
    acc = Accelerator(mixed_precision="no", device="cuda")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=DP_LR,
                                                    weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn_pallas)
    ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, 50257, (8, 512)))
    losses = [step({"input_ids": ids.to("cuda")}).item() for _ in range(DP_STEPS)]
    ref = {"losses": losses,
           "params": {k: p.detach().cpu() for k, p in model.module.named_parameters()}}
    torch.save(ref, path)
    del model, acc, step
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def data_parallel_phase(torch, np, seed: int, card: str, bf16_step_ms: float) -> dict:
    """Phase 32: data-parallel training across processes through
    ``python -m accelerate_tpu_torch.commands.launch``. (a) one NCCL rank
    (``--num_processes 1``) runs phase 29's bf16 variant (GPT-2 small, 8 x
    1024, flash, `lm_loss_fn_pallas`, 2 untimed and 10 timed steps): backend,
    world, step ms beside phase 29's (the data-parallel path's cost at
    world 1), tokens/s, the launches of #2-#4 and #8-#10; the loss falls.
    (b) two ranks sharing the card over gloo (``--backend gloo``, CUDA
    tensors), GPT-2 small fp32 with TF32 off, one global batch 8 x 512 split
    4 + 4: 3 AdamW steps plainly and with the bf16 hook against one process
    on the whole batch (`DP_LOSS_RTOL`, `DP_BF16_LOSS_RTOL`), 6 with PowerSGD
    (rank 1, warm-up 2) whose loss falls; every run's ranks end bit for bit
    equal; all-reduce bytes and ms a step beside the step ms. (c) the
    reference's multi-process collective checks on CUDA tensors at 2 ranks,
    and `examples/by_feature/multi_process_metrics.py` at 2 ranks: its
    ragged eval set of 151 samples counted once. Returns (a)'s launches."""
    import tempfile

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        child = work / "dp_child.py"
        child.write_text(DATA_PARALLEL_CHILD)
        lines, _, seconds = launch_child(["--num_processes", "1", str(child),
                                          json.dumps({"mode": "nccl", "seed": seed})])
        world1 = lines[-1]
        world1.update({"phase29_bf16_step_ms": bf16_step_ms,
                       "step_ms_over_phase29": world1["step_ms"] / bf16_step_ms,
                       "child_s": seconds, "card": card})
        print(json.dumps(world1), flush=True)
        if world1["backend"] != "nccl" or world1["world"] != 1:
            raise AssertionError(f"phase 32 (a): {world1}")
        losses = world1["losses"]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"phase 32 (a): the loss did not fall: {losses}")
        launches = {**{n: world1["launches"][n] for n in FLASH_REPLACES},
                    **{n: world1["launches"][n] for n in FUSED_CE_REPLACES}}
        expected = {**{n: 12 * 10 for n in FLASH_REPLACES}, **{n: 10 for n in FUSED_CE_REPLACES}}
        if launches != expected:
            raise AssertionError(f"phase 32 (a): launches {launches}, expected {expected}")

        dp_one_process_reference(torch, np, seed, work / "reference.pt")
        lines, _, seconds = launch_child(["--num_processes", "2", "--backend", "gloo", str(child),
                                          json.dumps({"mode": "gloo", "seed": seed,
                                                      "reference": str(work / "reference.pt"),
                                                      "lr": DP_LR, "steps": DP_STEPS})])
        for rec in lines:
            rec.update({"card": card})
            print(json.dumps(rec), flush=True)
        runs = {rec["phase"]: rec for rec in lines}
        step_bound = 2 * DP_LR * DP_STEPS
        for name in ("plain", "bf16", "power_sgd"):
            rec = runs[f"data_parallel_gloo_{name}"]
            if not rec["ranks_bit_equal"] or rec["backend"] != "gloo" or rec["world"] != 2:
                raise AssertionError(f"phase 32 (b) {name}: {rec}")
            within = {
                "plain": rec.get("loss_max_rel_diff", 1) <= DP_LOSS_RTOL
                and rec.get("param_max_abs_diff", 1) <= step_bound
                and rec.get("param_share_within_lr_20th", 0) >= DP_PARAM_SHARE,
                "bf16": rec.get("loss_max_rel_diff", 1) <= DP_BF16_LOSS_RTOL
                and rec.get("param_max_abs_diff", 1) <= step_bound
                and rec.get("param_share_within_lr_20th", 0) >= DP_BF16_PARAM_SHARE,
                "power_sgd": True}[name]
            if not within or rec.get("qkv_key_bias_max_abs_diff", 0) > step_bound:
                raise AssertionError(f"phase 32 (b) {name}: beyond its bar against one process: "
                                     f"{rec}")
        if not runs["data_parallel_gloo_power_sgd"]["loss_falls"]:
            raise AssertionError(f"phase 32 (b) power_sgd: {runs['data_parallel_gloo_power_sgd']}")
        if not runs["data_parallel_collectives"]["ok"]:
            raise AssertionError(f"phase 32 (c): {runs['data_parallel_collectives']}")

        _, stdout, seconds = launch_child([
            "--num_processes", "2", "--backend", "gloo", "-m",
            "accelerate_tpu_torch.examples.by_feature.multi_process_metrics", "--device",
            "cuda:0", "--tiny"])
        metrics = {"phase": "data_parallel_multi_process_metrics", "world": 2, "backend": "gloo",
                   "stdout": stdout.strip().splitlines()[-1], "seconds": seconds, "card": card}
        print(json.dumps(metrics), flush=True)
        if "eval set 151 samples on 2 process(es)" not in stdout:
            raise AssertionError(f"phase 32 (c): multi_process_metrics printed {stdout[-2000:]}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"phase": "data_parallel_phase_s", "seconds": time.perf_counter() - t0,
                      "launches": launches, "card": card}), flush=True)
    return {"launches": launches}


def phase_done(name: str, t0: float) -> float:
    """Prints ``{name}_phase_s``, the seconds since ``t0``; returns the time
    now, where the next phase starts."""
    now = time.perf_counter()
    print(json.dumps({"phase": f"{name}_phase_s", "seconds": now - t0}), flush=True)
    return now


def main() -> int:
    t_script = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (ROOT / "accelerate_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (accelerate_tpu_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; capability {cap}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    print(f"peak rates used for bounds: {peak_rates(name)[2]}", flush=True)
    t_phase = phase_done("device", t_script)

    # 2. build
    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libraries = ("paged_decode", "flash_attention", "fused_ce", "nf4_matmul")
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, libraries))
    for lib_name in libraries:
        _build.load(lib_name)
    build_s = time.perf_counter() - t0
    for lib_name in libraries:
        log = _build.build_log(lib_name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spilling = [f"{m.group(1)}<{_MANGLED_DTYPES[m.group(2)]}>"
                    for m, res in ptxas_entries(log, _KERNEL_NAME)
                    if res["spill_store_bytes"] or res["spill_load_bytes"]]
        print(json.dumps({"phase": "build", "library": lib_name, "build_s": build_s,
                          "kernels": len(regs), "max_registers": max(regs, default=0),
                          "kernels_spilling": len(spilling), "spilling": spilling}), flush=True)
    flash_log = _build.build_log("flash_attention")
    for phase, found in (("build_flash_forward", forward_resources(flash_log)),
                         ("build_flash_dq", dq_resources(flash_log)),
                         ("build_flash_dkv", dkv_resources(flash_log))):
        print(json.dumps({"phase": phase, "kernels": found}), flush=True)
        if any(k["spill_store_bytes"] or k["spill_load_bytes"] for k in found):
            raise AssertionError(f"{phase}: a kernel spills: {found}")
    from accelerate_tpu_torch.ops import fused_ce as fc

    found = fused_ce_bwd_resources(_build.build_log("fused_ce"))
    found_fwd = fused_ce_fwd_resources(_build.build_log("fused_ce"))
    print(json.dumps({"phase": "build_fused_ce", "kernels": found, "forward": found_fwd,
                      "launch_e768": {"dH": fc.bwd_plan(False, 768), "dW": fc.bwd_plan(True, 768)},
                      "forward_launch_by_splits": {s: fc.fwd_launch(s) for s in fc.FWD_SPLITS}}),
          flush=True)
    if len(found) != 8 or len(found_fwd) != 1 or any(
            k["spill_store_bytes"] or k["spill_load_bytes"] for k in found + found_fwd):
        raise AssertionError(f"build_fused_ce: a bf16 forward, dH or dW kernel is missing or spills: "
                             f"{found_fwd} {found}")
    # the fp16 instances (scalar bodies): 5 head_dim bodies x 6 flash kernels
    # (the rectangular ones causal and not), 3 fused-CE kernels
    fp16 = {lib: fp16_resources(_build.build_log(lib)) for lib in ("flash_attention", "fused_ce")}
    print(json.dumps({"phase": "build_fp16_instances",
                      **{lib: {"kernels": len(found), "max_registers": max(
                          (k["registers"] for k in found), default=0),
                          "spilling": [k for k in found if k["spill_store_bytes"]
                                       or k["spill_load_bytes"]]} for lib, found in fp16.items()}}),
          flush=True)
    if len(fp16["flash_attention"]) != 45 or len(fp16["fused_ce"]) != 3 or any(
            k["spill_store_bytes"] or k["spill_load_bytes"] for found in fp16.values() for k in found):
        raise AssertionError(f"build_fp16_instances: an fp16 instance is missing or spills: {fp16}")
    for phase, found in (("build_paged_decode", paged_decode_resources(_build.build_log("paged_decode"))),
                         ("build_nf4", nf4_resources(_build.build_log("nf4_matmul")))):
        spilling = [k for k in found if k["spill_store_bytes"] or k["spill_load_bytes"]]
        if phase == "build_paged_decode":  # 65 instances: the register body's main one, and maxima
            summary = {"kernels": len(found),
                       "main": [k for k in found if (k["q"], k["pool"], k["d"], k["groups"])
                                == ("13__nv_bfloat16", "S1_", 64, 1)],
                       "max_registers_register_body": max(k["registers"] for k in found if k["d"]),
                       "max_registers_general_body": max(k["registers"] for k in found if not k["d"])}
        else:
            summary = {"kernels": found}
        print(json.dumps({"phase": phase, **summary, "spilling": spilling}), flush=True)
        if not found or spilling:
            raise AssertionError(f"{phase}: a kernel is missing or spills: {spilling}")
    t_phase = phase_done("build", t_phase)

    # 3. kernel against its plain version
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.flash_attention import paged_decode_attention

    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 64 MiB > L2
    ragged = [1, 15, 16, 17, 100, 255, 256, 257, 511, 512, 640, 767, 900, 1023, 1024, 40]
    gpt2 = dict(b=16, hq=12, kvh=12, d=64, bt=16, flush=flush)
    cases = [
        kernel_case(torch, "gpt2_small_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed, parked=(15,), **gpt2),
        kernel_case(torch, "gpt2_small_fp32", lengths=ragged[:-1] + [0], dtype=torch.float32,
                    quant=False, seed=args.seed + 1, **gpt2),
        kernel_case(torch, "gqa_32q_8kv_d128_bf16", lengths=ragged, dtype=torch.bfloat16,
                    quant=False, seed=args.seed + 2, parked=(15,),
                    **{**gpt2, "hq": 32, "kvh": 8, "d": 128}),
        kernel_case(torch, "gpt2_small_int8_pool", lengths=ragged, dtype=torch.bfloat16,
                    quant=True, seed=args.seed + 3, parked=(15,), **gpt2),
        # the general body: head_dims off 64 and 128, group counts off 1, 2, 4, 8
        kernel_case(torch, "d96_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 4, parked=(15,), **{**gpt2, "d": 96}),
        kernel_case(torch, "d256_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 5, parked=(15,), **{**gpt2, "hq": 16, "kvh": 16, "d": 256}),
        kernel_case(torch, "gqa3_6q_2kv_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 6, parked=(15,), **{**gpt2, "hq": 6, "kvh": 2}),
        kernel_case(torch, "gqa6_12q_2kv_bf16", lengths=ragged, dtype=torch.bfloat16, quant=False,
                    seed=args.seed + 7, parked=(15,), **{**gpt2, "hq": 12, "kvh": 2}),
        kernel_case(torch, "int8_pool_32q_8kv_d128", lengths=ragged, dtype=torch.bfloat16,
                    quant=True, seed=args.seed + 8, parked=(15,),
                    **{**gpt2, "hq": 32, "kvh": 8, "d": 128}),
    ]
    del flush
    torch.cuda.empty_cache()
    t_phase = phase_done("paged_decode_kernel", t_phase)

    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.kv_cache import tree_nbytes
    from accelerate_tpu_torch.serving import (
        FINISH_LENGTH,
        PagedKVConfig,
        Request,
        SamplingParams,
        ServingEngine,
    )

    rng = np.random.default_rng(args.seed)

    def prompts(n):
        return [rng.integers(0, 50257, int(k)).tolist() for k in rng.integers(16, 701, n)]

    # 4. fp32 slice: the graph engines == gather == generate, token for token
    model = GPT2LMHead(GPT2Config.small(dtype=torch.float32), device="cuda", seed=args.seed)
    n_layer = model.config.n_layer
    fp32_prompts = prompts(8)

    def fp32_requests():
        return [Request(prompt=p, params=SamplingParams(max_new_tokens=32)) for p in fp32_prompts]

    gather = ServingEngine(model, paged_kv=True, paged_attention="gather", max_concurrency=8,
                           prompt_buckets=BUCKETS)
    gather_out = [o.tokens for o in gather.run(fp32_requests())]
    del gather
    solos = [generate(model, torch.tensor([p]), 32)[0].tolist() for p in fp32_prompts]
    fp32 = {"phase": "fp32_slice", "requests": len(fp32_prompts), "pipeline_depth": 2,
            "gather_equal_generate": gather_out == solos}
    for sync in (1, 4):
        # the slot-pool engine (the default): one replay a step, no kernel in it
        slot = ServingEngine(model, max_concurrency=8, prompt_buckets=BUCKETS, pipeline_depth=2,
                             tokens_per_sync=sync)
        slot_out = [o.tokens for o in slot.run(fp32_requests())]
        fp32[f"slot_k{sync}"] = {"tokens_equal_generate": slot_out == solos,
                                 "tokens_equal_paged_gather": slot_out == gather_out,
                                 "decode_steps": slot.metrics.decode_steps.value,
                                 "decode_replays": slot.metrics.decode_dispatches.value,
                                 "graph_launches": slot.graph_launches}
        if slot_out != solos or slot._graph is None or any(slot.graph_launches.values()):
            raise AssertionError(f"fp32 slot engine (tokens_per_sync {sync}): streams differ from "
                                 f"generate's, or no graph, or kernels in it: {fp32}")
        del slot
        fused = ServingEngine(model, paged_kv=True, paged_attention="fused", max_concurrency=8,
                              prompt_buckets=BUCKETS, pipeline_depth=2, tokens_per_sync=sync)
        paged_decode_attention.launches = 0
        fused_out = [o.tokens for o in fused.run(fp32_requests())]
        steps = fused.metrics.decode_steps.value
        launches = replay_launches(fused, "paged_decode_attention", paged_decode_attention.launches)
        in_replay = graph_kernels(torch, fused, "paged_decode_kernel")
        fp32[f"k{sync}"] = {"tokens_equal_generate": fused_out == solos, "decode_steps": steps,
                            "decode_replays": fused.metrics.decode_dispatches.value,
                            "launches": launches, "launches_expected": n_layer * steps,
                            "paged_kernels_in_one_replay": in_replay,
                            "expected_in_one_replay": n_layer * sync}
        if fused_out != solos:
            raise AssertionError(f"fp32 graph engine (tokens_per_sync {sync}) streams differ "
                                 "from generate's")
        if launches != n_layer * steps or steps == 0:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"{n_layer * steps}")
        if in_replay != n_layer * sync:
            raise AssertionError(f"one replay ran {in_replay} paged-decode kernels, not "
                                 f"n_layer x tokens_per_sync = {n_layer * sync}")
        del fused
    print(json.dumps(fp32), flush=True)
    if gather_out != solos:
        raise AssertionError("fp32 token streams differ between the gather engine and generate")
    if any(len(t) != 32 for t in solos):
        raise AssertionError("an fp32 request did not emit its 32 tokens")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = phase_done("fp32_slice", t_phase)

    # 5. bf16 slice: serving through the fused engine
    model = GPT2LMHead(GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                       device="cuda", seed=args.seed)
    check = prompts(16)
    fused_logits = first_step_logits(torch, model, check, "fused")
    gather_logits = first_step_logits(torch, model, check, "gather")
    logit_err = (fused_logits - gather_logits).abs().max().item()
    if not (math.isfinite(logit_err) and logit_err <= BF16_LOGIT_ATOL):
        raise AssertionError(f"bf16 first-step logits: fused vs gather {logit_err} > {BF16_LOGIT_ATOL}")

    serve_prompts = prompts(48)

    def bf16_requests():
        return [Request(prompt=p, params=SamplingParams(
                    max_new_tokens=64, temperature=0.8 if i % 2 else 0.0,
                    top_k=50 if i % 2 else None, seed=i))
                for i, p in enumerate(serve_prompts)]

    def engine(depth=2, sync=1):
        return ServingEngine(model, paged_kv=PagedKVConfig(block_tokens=16),
                             paged_attention="fused", max_concurrency=16, prompt_buckets=BUCKETS,
                             pipeline_depth=depth, tokens_per_sync=sync)

    engine().run(bf16_requests()[:4])  # warm-up: cuBLAS handles, allocator pools
    streams, lines = {}, {}
    for depth, sync in ((1, 1), (2, 1), (2, 4)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the engine's pool, buffers and graph count
        eng = engine(depth, sync)
        admissions = count_admissions(eng)
        reset_counts(fa)
        t0 = time.perf_counter()
        outs = eng.run(bf16_requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = replay_launches(eng, "paged_decode_attention", paged_decode_attention.launches)
        steps = eng.metrics.decode_steps.value
        line = serving_line(eng, outs, wall, launches, torch.cuda.max_memory_allocated(), card,
                            max_new_tokens=64, admission_forwards=admissions[0],
                            admission_host_s=admissions[1],
                            admission_share_of_wall=admissions[1] / wall,
                            flash_launches=flash_counts(fa),
                            first_step_logit_max_abs_diff=logit_err, logit_atol=BF16_LOGIT_ATOL)
        print(json.dumps(line), flush=True)
        bad = [o.request_id for o in outs
               if o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64]
        if bad:
            raise AssertionError(f"requests {bad} did not finish with 64 tokens")
        if launches != n_layer * steps or steps == 0:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"{n_layer * steps}")
        streams[(depth, sync)], lines[(depth, sync)] = [o.tokens for o in outs], line
        del eng
    if not streams[(1, 1)] == streams[(2, 1)] == streams[(2, 4)]:
        raise AssertionError("bf16 streams differ across (depth, tokens_per_sync) (1, 1), (2, 1), "
                             "(2, 4)")
    serving = lines[(2, 1)]
    # the slot-pool engine (the default) at (2, 1): no kernel on its decode path
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slot = ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS, pipeline_depth=2)
    admissions = count_admissions(slot)
    reset_counts(fa)
    t0 = time.perf_counter()
    outs = slot.run(bf16_requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slot_streams = [o.tokens for o in outs]
    line = serving_line(slot, outs, wall, replay_launches(slot, "paged_decode_attention",
                                                          paged_decode_attention.launches),
                        torch.cuda.max_memory_allocated(), card, phase="bf16_serving_slot",
                        max_new_tokens=64, admission_forwards=admissions[0],
                        admission_host_s=admissions[1], admission_share_of_wall=admissions[1] / wall,
                        streams_equal_fused=sum(a == b for a, b in zip(slot_streams,
                                                                       streams[(2, 1)])),
                        kv_cache_bytes=tree_nbytes(slot._cache))
    print(json.dumps(line), flush=True)
    if any(o.finish_reason != FINISH_LENGTH or len(o.tokens) != 64 for o in outs):
        raise AssertionError("bf16 slot engine: a request did not finish with 64 tokens")
    if line["kernel_launches"] or slot.metrics.decode_steps.value == 0:
        raise AssertionError(f"bf16 slot engine ran {line['kernel_launches']} paged kernels")
    del slot
    long_requests = [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
                     for p in serve_prompts[:16]]
    decode_profiles = {}
    for depth, sync, steps in ((1, 1, 16), (2, 1, 16), (2, 4, 8)):
        decode_profiles[(depth, sync)] = profile_decode(torch, engine(depth, sync), long_requests,
                                                        steps=steps)
        print(json.dumps(decode_profiles[(depth, sync)]), flush=True)
    print(json.dumps(profile_decode(
        torch, ServingEngine(model, max_concurrency=16, prompt_buckets=BUCKETS, pipeline_depth=2),
        long_requests, phase="bf16_decode_profile_slot")), flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = phase_done("bf16_slice", t_phase)

    # 6. flash kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    small = dict(b=8, h=12, s=1024, d=64, flush=flush)
    flash_cases = [
        flash_case(torch, "gpt2_small_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed, **small),
        flash_case(torch, "gpt2_small_fp32_causal", dtype=torch.float32, causal=True,
                   seed=args.seed + 1, **small),
        flash_case(torch, "gpt2_small_bf16_full", dtype=torch.bfloat16, causal=False,
                   seed=args.seed + 2, **small),
        flash_case(torch, "d128_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 3, **{**small, "d": 128}),
        flash_case(torch, "ragged_s1000_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 4, **{**small, "s": 1000}),
        # head_dim 192 and 256 (the scalar bodies) at GPT-2 small's width,
        # 768 = h x d, and its training sequence
        flash_case(torch, "d192_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 5, **{**small, "h": 4, "d": 192}),
        flash_case(torch, "d256_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 6, **{**small, "h": 3, "d": 256}),
        # above 256: the run-time head_dim body at d 384 (what 300 pads to)
        flash_case(torch, "d320_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 8, **{**small, "h": 2, "d": 320}),
        flash_case(torch, "d384_bf16_causal", dtype=torch.bfloat16, causal=True,
                   seed=args.seed + 7, **{**small, "h": 2, "d": 384}),
    ]
    del flush
    torch.cuda.empty_cache()
    t_phase = phase_done("flash_kernels", t_phase)

    # 7. fp32 train-step parity, flash against plain attention
    train_parity(torch, np, args.seed)
    t_phase = phase_done("fp32_train_parity", t_phase)

    # 8. bf16 training: bench.py's path
    train, _ = train_bf16(torch, np, args.seed, card)
    t_phase = phase_done("bf16_train", t_phase)

    # 9. fused-CE kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    head = dict(n=8192, v=50257, e=768, flush=flush)
    fused_cases = [
        fused_ce_case(torch, "gpt2_small_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed, **head),
        fused_ce_case(torch, "gpt2_small_fp32", dtype=torch.float32, ignore_every=16,
                      seed=args.seed + 1, **head),
        fused_ce_case(torch, "ragged_n1000_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 2, **{**head, "n": 1000}),
        fused_ce_case(torch, "e1024_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 3, **{**head, "e": 1024}),
        fused_ce_case(torch, "mistral_head_e4096_bf16", dtype=torch.bfloat16, ignore_every=16,
                      seed=args.seed + 5, **{**head, "v": 32000, "e": 4096}),
        fused_ce_case(torch, "all_ignored_bf16", dtype=torch.bfloat16, ignore_every=1,
                      seed=args.seed + 4, **head),
    ]
    del flush
    torch.cuda.empty_cache()
    t_phase = phase_done("fused_ce_kernels", t_phase)

    # 10. fp32 train-step parity, fused CE against the plain loss
    fused_ce_parity(torch, np, args.seed)
    t_phase = phase_done("fp32_fused_ce_parity", t_phase)

    # 11. bf16 training with the fused loss: bench.py's BENCH_FUSED_CE=2 path
    fused_train, _ = train_bf16(torch, np, args.seed, card, fused_ce=True)
    if not fused_train["peak_mem_bytes"] < train["peak_mem_bytes"]:
        raise AssertionError(f"fused-CE training peak {fused_train['peak_mem_bytes']} B is not below "
                             f"the default loss's {train['peak_mem_bytes']} B")
    t_phase = phase_done("bf16_train_fused_ce", t_phase)

    # 12. band flash kernels against their plain versions
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    band_common = dict(flush=flush, card=card)
    band_cases = [
        band_case(torch, "mistral_bf16_w4096", b=1, hq=32, hkv=8, s=8192, d=128, window=4096,
                  dtype=torch.bfloat16, seed=args.seed, by_group=True, rms_tol=BAND_MAIN_RMS_TOL,
                  **band_common),
        band_case(torch, "gpt2_small_bf16_triangle", b=8, hq=12, hkv=12, s=1024, d=64,
                  window=None, dtype=torch.bfloat16, seed=args.seed + 1, rect=True, **band_common),
        band_case(torch, "ragged_fp32_w100_g4", b=2, hq=4, hkv=1, s=1000, d=64, window=100,
                  dtype=torch.float32, seed=args.seed + 2, **band_common),
        band_case(torch, "window1_bf16", b=1, hq=8, hkv=8, s=512, d=128, window=1,
                  dtype=torch.bfloat16, seed=args.seed + 3, **band_common),
        band_case(torch, "window_ge_seq_fp32_g2", b=1, hq=4, hkv=2, s=1024, d=128, window=2048,
                  dtype=torch.float32, seed=args.seed + 4, rect=True, **band_common),
        # what by_feature/sliding_window_long_context.py gives the kernels
        # (phase 28): its tiny Llama's head_dim 16 zero-padded to 128, fp32
        band_case(torch, "sliding_example_fp32_w32", b=2, hq=4, hkv=2, s=128, d=16, window=32,
                  dtype=torch.float32, seed=args.seed + 9, pad_to=128, **band_common),
        # head_dim 192 and 256 (the scalar bodies) at the Mistral sequence,
        # window and GQA ratio, 16 query heads over 4
        # (no main path launches them: 10 timed samples, not 30)
        band_case(torch, "d192_bf16_w4096", b=1, hq=16, hkv=4, s=8192, d=192, window=4096,
                  dtype=torch.bfloat16, seed=args.seed + 5, by_group=True, samples=10,
                  **band_common),
        band_case(torch, "d256_bf16_w4096", b=1, hq=16, hkv=4, s=8192, d=256, window=4096,
                  dtype=torch.bfloat16, seed=args.seed + 6, by_group=True, samples=10,
                  **band_common),
        # above 256: the run-time head_dim body at d 320 and 384, 5 samples
        band_case(torch, "d320_bf16_w4096", b=1, hq=16, hkv=4, s=8192, d=320, window=4096,
                  dtype=torch.bfloat16, seed=args.seed + 8, by_group=True, samples=5,
                  **band_common),
        band_case(torch, "d384_bf16_w4096", b=1, hq=16, hkv=4, s=8192, d=384, window=4096,
                  dtype=torch.bfloat16, seed=args.seed + 7, by_group=True, samples=5,
                  **band_common),
    ]
    del flush
    torch.cuda.empty_cache()
    t_phase = phase_done("flash_band_kernels", t_phase)

    # 13. fp32 Llama train-step parity, band kernels against plain attention
    llama_band_parity(torch, np, args.seed, card)
    t_phase = phase_done("fp32_llama_band_parity", t_phase)

    # 14. bf16 training of the Mistral-7B-width model: this slice's path
    mistral = train_mistral(torch, np, args.seed, card)
    t_phase = phase_done("bf16_train_mistral", t_phase)

    # 15. nf4 kernel against its plain version
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    nf4_cases = [nf4_case(torch, f"llama7b_{K}x{N}_m{M}_bf16", M=M, K=K, N=N,
                          dtype=torch.bfloat16, seed=args.seed + i, flush=flush)
                 for i, (K, N) in enumerate(LLAMA_NF4_SHAPES) for M in (1, 16)]
    gpt2_nf4 = [nf4_case(torch, f"gpt2_{K}x{N}_m{M}_bf16", M=M, K=K, N=N, dtype=torch.bfloat16,
                         seed=args.seed + i, flush=flush)
                for i, (K, N) in enumerate(GPT2_NF4_SHAPES) for M in (16, 512)]
    nf4_cases += gpt2_nf4 + [
        nf4_case(torch, "gpt2_768x2304_m16_fp32", M=16, K=768, N=2304, dtype=torch.float32,
                 seed=args.seed, flush=flush),
        nf4_case(torch, "lead_2x8_768x3072_bf16", M=16, K=768, N=3072, dtype=torch.bfloat16,
                 seed=args.seed, flush=flush, lead=(2,)),
        nf4_case(torch, "unsupported_n192_fp32", M=16, K=768, N=192, dtype=torch.float32,
                 seed=args.seed, flush=flush),
    ]
    del flush
    torch.cuda.empty_cache()
    t_phase = phase_done("nf4_kernels", t_phase)

    # 16. fp32 quantized-serving parity
    quant_parity(torch, args.seed, fp32_prompts)
    t_phase = phase_done("fp32_quant_parity", t_phase)

    # 17. bf16 quantized serving: this slice's path; then KV capacity
    quant = quant_serving(torch, args.seed, bf16_requests,
                          lambda: [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
                                   for p in serve_prompts[:16]], card)
    kv_capacity(torch, np, args.seed, card)
    t_phase = phase_done("bf16_quant_serving", t_phase)

    # 18. Llama decode parity at Llama-2-7B's width, 2 layers, fp32
    llama_decode_parity(torch, np, args.seed, card)
    t_phase = phase_done("fp32_llama_decode_parity", t_phase)

    # 19. big-model inference: the reference tool's flow at Llama-2-7B; and
    # an HF-named checkpoint against the reference-named one
    big_model_inference(torch, card)
    hf_checkpoint_parity(torch, card, args.seed)
    t_phase = phase_done("big_model_inference", t_phase)

    # 20. prefix-cached serving
    prefix_serving(torch, np, args.seed, card)
    t_phase = phase_done("prefix_serving", t_phase)

    # 21. speculative serving
    spec_serving(torch, np, args.seed, card)
    t_phase = phase_done("spec_serving", t_phase)

    # 22. the Llama loss with the untied head on the fused-CE kernels
    llama_fused_parity(torch, np, args.seed, card)
    mistral_fused = train_mistral(torch, np, args.seed, card, fused_ce=True)
    print(json.dumps({"phase": "mistral_loss_comparison", "step_ms": mistral["step_ms"],
                      "step_ms_fused_ce": mistral_fused["step_ms"],
                      "tokens_per_s": mistral["tokens_per_s"],
                      "tokens_per_s_fused_ce": mistral_fused["tokens_per_s"],
                      "mfu": mistral["mfu"], "mfu_fused_ce": mistral_fused["mfu"],
                      "peak_mem_bytes": mistral["peak_mem_bytes"],
                      "peak_mem_bytes_fused_ce": mistral_fused["peak_mem_bytes"],
                      "card": card}), flush=True)
    phase_done("llama_fused_ce", t_phase)

    # 23. reliability: crash-exact serving, the health flag, deadlines, drain
    reliability_serving(torch, np, args.seed, card, serve_prompts, decode_profiles[(2, 1)])

    # 24. observability: the tracer, the supervisor, brownout, the hooks' costs
    observability = observability_serving(torch, np, args.seed, card, serve_prompts)

    # 25. the training loop through the facade: the nlp example, GPT-2's loop
    t0 = time.perf_counter()
    nlp = {mp: nlp_example_phase(torch, card, mp) for mp in ("bf16", "fp16")}
    facade = facade_training(torch, np, args.seed, card)
    print(json.dumps({"phase": "training_loop_phase_s", "seconds": time.perf_counter() - t0,
                      "bf16_samples_per_s": nlp["bf16"]["samples_per_s"],
                      "fp16_samples_per_s": nlp["fp16"]["samples_per_s"]}), flush=True)

    # 26. the serving fleet and its front door
    fleet = fleet_serving(torch, np, args.seed, card, serve_prompts)

    # 27. the host-RAM KV tier and request hibernation
    kv_tier = kv_tier_serving(torch, np, args.seed, card, serve_prompts)

    # 28. ResNet-50 image classification and the rest of the one-process facade
    features = vision_and_facade(torch, np, card)

    # 29. precision on one card: fp8 training, remat, the fp16 kernel instances
    precision = precision_phase(torch, np, args.seed, card)

    # 30. big models on one card: placement, streaming, Mixtral-8x7B
    big = big_models_phase(torch, np, args.seed, card)

    # 31. T5-v1.1-base on the fused-CE kernels, ViT-B/16, the inference examples
    t5_vit = t5_vit_phase(torch, np, args.seed, card)

    # 32. data-parallel training across processes, through the launcher
    data_parallel = data_parallel_phase(torch, np, args.seed, card, precision["bf16_step_ms"])

    # 33. summary lines
    print(json.dumps({"phase": "chip_smoke_s", "seconds": time.perf_counter() - t_script}),
          flush=True)
    main_case = cases[0]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "accelerate_tpu/ops/flash_attention.py:734",
        "launches": (serving["kernel_launches"] + observability["launches"] + fleet["launches"]
                     + kv_tier["launches"]),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    for kname, replaces in FLASH_REPLACES.items():
        main_rec = flash_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": (train["launches"][kname] + facade["launches_loop"][kname]
                         + precision["launches"][kname] + big["launches"][kname]
                         + data_parallel["launches"][kname]),
            "max_abs_err": max(c[kname]["max_abs_err"] for c in
                               flash_cases + [precision["flash_case"], big["flash_case"]]),
            "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        })
    for kname, replaces in FUSED_CE_REPLACES.items():
        main_rec = fused_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/fused_ce.cu", "replaces": replaces,
            "launches": (fused_train["launches"][kname] + facade["launches_loop"][kname]
                         + precision["launches"][kname] + big["launches"][kname]
                         + t5_vit["launches"][kname] + data_parallel["launches"][kname]),
            "max_abs_err": max(c[kname]["max_abs_err"] for c in
                               fused_cases + [precision["fused_case"], big["fused_case"],
                                              t5_vit["fused_case"]]),
            "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        })
    nf4_main = next(c for c in gpt2_nf4 if c["K"] == 768 and c["N"] == 3072 and c["M"] == 16)
    kernels.append({
        "name": "nf4_matmul", "route": "cuda", "source": "accelerate_tpu_torch/ops/csrc/nf4_matmul.cu",
        "replaces": NF4_REPLACES, "launches": quant["nf4_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in nf4_cases),
        "ms": nf4_main["kernel_ms"], "plain_ms": nf4_main["plain_ms"],
        "bound_ms": nf4_main["bound_ms"], "bound_by": nf4_main["bound_by"],
        # no PyTorch call computes x @ dequantize_nf4(W); the dense bf16
        # product, another function, stands in the nf4_kernels lines
        "library_ms": None,
    })
    for kname, replaces in BAND_REPLACES.items():
        main_rec = band_cases[0][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": mistral["launches"][kname] + features["band_launches"][kname],
            "max_abs_err": max(c[kname]["max_abs_err"] for c in band_cases),
            "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
