#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ant_ray_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds, serves and trains
there, and that its runtime and object plane carry tensors of the card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the
final line is printed:

1. Setup: a CUDA device must exist; print the card's name and power
   limit (nvidia-smi); build every hand-written kernel from the sources
   in this checkout, timed, and print the registers and spill bytes
   ptxas reports for each tensor-core kernel (forward and backward, bf16
   and 3xTF32, at head_dim 64/128 and at 256); the 3xTF32 forward at 256
   must spill nothing.
2. Kernels: the flash-attention forward, through flash_attention_fwd_lse
   on the route it picks (told apart by the route counters: the
   tensor-core "sm90" kernel for bf16 at head_dim 64 and 128, the
   tensor-core "tf32x3" kernel for fp32 there, the tensor-core
   "sm90_d256" kernel for bf16 at head_dim 256, the tensor-core
   "tf32x3_d256" kernel for fp32 there), against its plain PyTorch
   version at the serving path's shapes (Llama-3-8B prefill: B=1, H=32,
   KVH=8, D=128, bf16, causal), at the training slice's (B=8, S=2048,
   H=8, KVH=4) and at others: llama3-1b's heads (D=64), ragged lengths
   192 and 320, fp32 at D=64 and at D=128 with GQA, ragged, non-causal
   and with Sq < Skv and Sq > Skv, non-causal without GQA, D=256 in bf16
   and in fp32 (B=1, S=512, H=8, KVH=2), GPT-2's
   (B=8, S=1024, H=KVH=12, D=64) in fp32 and bf16, and bf16 at
   Gemma-7B's and Gemma-2B's attention (B=4, S=2048, D=256, H=KVH=16 and
   H=8 KVH=1) and the head_dim-256 path's own (phase 17: B=2, S=2048,
   H=8, KVH=1; the sm90_d256 kernel's route), and that shape in fp32
   (phase 18's, the tf32x3_d256 kernel's route).  Tolerances: bf16
   out max abs error <= 2e-2 (bf16 rounds p and out at other points in
   the tiled loop), lse <= 1e-3; fp32 both <= 1e-4.  Times by CUDA
   events, median of 10 runs: the kernel launched directly (with its
   achieved TFLOP/s and share of its bound), the wrapper, the plain
   version, and torch's scaled_dot_product_attention as a yardstick the
   port never calls; the bound is the larger of FLOPs over the card's
   peak for the input type and bytes over 3.35 TB/s, tf32x3's and
   tf32x3_d256's at 3xTF32's rate (494.7/3 TFLOP/s) and also at the 67
   TFLOP/s of fp32 FMAs.  At S=4096 and at the training shape (sm90), at
   GPT-2's fp32 shape (tf32x3), at the three bf16 head_dim-256 shapes
   (sm90_d256) and at both fp32 head_dim-256 shapes (tf32x3_d256) the
   CUDA-core kernel, on no route now, is also checked and timed,
   launched directly, for a before-and-after on one card; at the fp32
   d256 path's a profile names SDPA's fp32 forward kernels.
3. Backward kernels: dQ and dK/dV through flash_attention_backward, on
   the route it picks (tensor-core "sm90" kernels for bf16 at head_dim
   64 and 128, tensor-core "tf32x3" kernels for fp32 there, tensor-core
   "sm90_d256" kernels for bf16 at head_dim 256, tensor-core
   "tf32x3_d256" kernels for fp32 there), against
   flash_attention_backward_ref at the training slice's shape and
   eighteen others: llama3-1b's heads (D=64), length 192 (ragged on
   128-row tiles), Sq != Skv, fp32 at D=64 and D=128 with GQA, ragged
   and with more keys, D=256 in fp32 and bf16, GPT-2's in fp32 and
   bf16, Gemma-7B's and Gemma-2B's attention and the head_dim-256
   path's (phase 17: B=2, S=2048, H=8, KVH=1) in bf16, and that path's
   in fp32 (phase 18) (BWD_TOL: max abs error over max |ref| per
   tensor).  Each line gives per kernel
   its route, time, achieved TFLOP/s and share of its bound (tf32x3's
   and tf32x3_d256's at 3xTF32's rate, 494.7/3 TFLOP/s, and also at the
   67 TFLOP/s of fp32 FMAs); then the whole backward, its plain version,
   and as a yardstick SDPA's backward (fwd+bwd through autograd minus
   fwd).  The bound counts 6*D (dQ), 8*D (dK/dV) and 10*D (the whole
   backward) FLOPs per (q, k) pair against the bytes each must move.
   At the training shape (sm90), at GPT-2's fp32 shape (tf32x3), at
   Gemma-7B's attention (sm90_d256) and at both fp32 head_dim-256
   shapes (tf32x3_d256) the CUDA-core pair, on no route now, is also
   checked and timed, launched directly, for a before-and-after on one
   card; at GPT-2's fp32 shape and the fp32 d256 path's a profile names
   SDPA's kernels.
4. Correctness of the model path on a small fp32 model with head_dim
   128: logits through the flash kernel against the plain reference
   attention on the card, and against the same model on the CPU; then
   the loss and every gradient leaf through the kernels (the 3xTF32
   forward and backward) against reference attention on the card and
   against the CPU, under each remat policy ("none", "full", "dots",
   "matmuls"; the forward kernel runs twice per layer under "full" and
   "dots", once where its out and lse are saved).  Then the same model
   in bf16: loss and every gradient leaf through the sm90 forward and
   backward against bf16 reference attention (BF16_GRAD_TOL, reason
   beside it), with each sm90 kernel run once per layer.
5. The serving slice: LLMEngine("llama3-8b", slots=8, max_seq=4096) with
   random weights from a fixed seed, five greedy prompts of 20, 100,
   700, 1500 and 3000 random token ids (buckets 32 to 4096) and one
   seeded sampled prompt of 300, 32 new tokens each.  The launch counts
   are reset just before and read just after: the sm90 forward must run
   n_layers times for every prefill with a bucket of 128 or more, with
   no other forward and no backward launch.
   The 8B logits through the kernel are checked against blockwise
   attention, then prefill time per bucket, decode tokens/s and peak
   memory are printed, and a torch.profiler trace of a short and a long
   prefill and of one decode step gives the device's busy share.
5b. Tensor-parallel serving (the parallel phase's first part) on the
   serving slice's weights: LLMEngine("llama3-8b", slots=8,
   max_seq=4096) on build_mesh(devices=["cuda:0"] * 2, tp=2), a
   virtual mesh of two cells of the card; every shard on cuda:0 at
   tp=2's local shapes, the slab split by KV heads.  Gates: greedy
   generation of the slice's five prompts launching the sm90 forward
   2 x 32 times for each bucket of 128 or more (each cell its 16
   heads, 4 KV heads) and nothing else; the TP prefill's last-token
   fp32 logits of each prompt and the first decode step's logits of
   every slot within TP_BF16_LOGIT_TOL (relative L2) of the unsharded
   model's on the same weights; the card's free memory back within
   CLUSTER_FREE_SLACK once the engine and its shards go.  Prints the
   greedy tokens' common prefix with the slice's and the prefill and
   decode times beside the slice's (not gated).
6. Sessions (chunked prefill, offload and restore) on the serving
   slice's 8B weights: LLMEngine(slots=4, max_seq=4096,
   prefill_chunk_tokens=512, profiler=StepProfiler()) with a store that
   keeps one slab in memory and spills the rest to a temporary
   directory in this checkout.  Six greedy sessions whose first turns
   are 300 to 1500 random token ids and second turns 50, 8 new tokens
   each, so that admission evicts idle sessions and their next turns
   restore them; a seventh, sampled, session evicted by force
   mid-generation; a restore held in flight (the store's get waits on an
   event) while an unrelated request runs start to finish.  Gates:
   every turn's tokens equal an engine of the same shape where each
   session runs alone and nothing is evicted; every slab bitwise equal
   (torch.equal) on the host after its offload and in its slot after
   its install; at least two pressure evictions and two restores, the
   forced restore, the held one, a restore from a spill file; no restore
   failure; no flash launch.  Prints the slab's bytes, offload ms and GB/s (host clock,
   into pinned memory), install ms on the card and on the host, step
   times of plain decode steps, of steps that install and of steps with
   a restore fetch in flight, restore_wait_s, peak memory and the
   profiler's summary.
7. EngineLoop on the same weights: four client threads submit eight
   requests of 90 to 600 tokens, half of them in sessions; every handle
   must finish within 120 s without error and stream exactly its final
   tokens; a second turn, then evict_session and end_session through the
   loop.  Prints TTFT per request and loop.stats(); no flash launch.
8. The runtime in local mode (ant_ray_tpu_torch.init(local_mode=True))
   on the same weights: an actor holding LLMEngine("llama3-8b", slots=2,
   max_seq=4096) answers greedy prompts of 20 and 1500 random token ids
   (32 new tokens each) after a warm-up round, each beside the same
   engine called directly; a task returns a CUDA tensor, put/get carry
   one, wait splits the actor's refs; then 1000 no-op actor calls and
   tasks in turns with the same method and function called directly.
   Gates: the actor's tokens equal the direct engine's token for token;
   every tensor on the card and bitwise equal; in the counted round the
   sm90 forward launched n_layers times for each prefill of a bucket of
   128 or more, directly and through the actor, and nothing else.
   Prints one "runtime" JSON line with the wall of each call beside the
   direct call's and, under "overhead", the runtime's own cost per call
   (medians, microseconds).  These launches stay out of the kernels line
   (phase 19), whose paths and counts are those of the phases it names.
9. The object plane on the card: one slot's KV slab of that direct
   engine (cache["k"][:, 0] and cache["v"][:, 0], 32 x 4096 x 8 x 128
   bf16 each, two non-contiguous views, 0.537 GB) goes through
   serialize -> ObjectStore.create_buffer -> write_into(view_unsealed)
   -> seal_buffer on the native arena in a directory of /dev/shm, and
   back through locate -> ArenaClient.view -> from_payload(pin_owner=)
   -> deserialize onto the card, once and then five times; then a mixed dict (a bf16
   non-contiguous view, fp32, int64, bool, a 0-dim tensor, a numpy
   array and an ObjectRef).  Gates: the native module builds and the
   store is on its arena (no fallback to files), /dev/shm and the store
   hold the slab (else it raises with the sizes; the payload is never
   shrunk), every round trip bitwise on the card, the ref recorded in
   contained_refs, no pin left.  Prints one "objects" JSON line: the
   card, /dev/shm's size, the store's capacity, the native build time,
   put and get ms of the first round trip, and ms and GB/s as the median
   of the five after it (put split into serialize, which holds the
   device-to-host copy, and the copy into the arena), beside a direct
   .cpu() and .to("cuda") of the same bytes, also past a first one.
   The directory is removed at the end, at exit and on SIGTERM.
   The 8B weights are freed after the next phase.
10. The runtime's processes on the card (ant_ray_tpu_torch.init(
   num_cpus=4): a GCS, a node daemon and worker processes, all of the
   port).  A num_gpus=1 actor builds LLMEngine("llama3-8b", slots=2,
   max_seq=4096, seed=0) in its own worker process and answers the
   runtime phase's prompts after a warm-up round, each beside the direct
   engine of phase 8; a second num_gpus=1 actor waits while the first
   lives and runs after its kill; a num_gpus=1 task returns a CUDA
   tensor; phase 9's slab goes through put, a task in a worker (which
   gets it onto its card, checks it and returns it) and get, once and
   then three times; 1000 no-op actor calls and tasks in turns with
   direct calls, over hot frames (hotframe.py); GPU placement and
   device objects (below); then shutdown().  The cluster starts with
   the chaos harness's preemption-notice file and a 0.1-s watch.
   Placement: the node's detected labels (gpu-generation h100,
   gpu-pod-type h100-<cards>, worker 0) and its GPU-<pod_type>-head
   resource, the detection's source printed ("cluster placement node"
   line); once the card is free, slice_placement_group("1x1", "H100")
   ready within 30 s with one bundle {"GPU": 1, head: 1} on this node,
   a num_gpus=1 task on bundle 0, the head back after the group's
   removal ("cluster placement slice").  Device objects, while the
   first actor lives: its bucketed prefill of the 1500-token prompt
   into its free slot (n_layers sm90 forward launches) puts the slot's
   k and v on its card (device_objects.put, transport "dma") and
   decodes 32 greedy tokens there; its own get is a local hit (same
   data_ptr); this process's get gives CUDA tensors bitwise the
   worker's, install_slot puts them into phase 8's engine's free slot,
   and greedy decode there gives the worker's 32 tokens exactly; a free
   empties the worker's device store within 5 s and a get after it
   raises ObjectLostError ("cluster handoff" line: fetch ms and GB/s,
   install ms, not gated).  A token stream, while the first actor
   lives: its num_returns="streaming" method yields each greedy id of
   engine.stream for the 1500-token prompt; the ids equal its
   generate's, this process holds item 0 before the generator ends (the
   actor's wall clock, this host), and the stream's prefill launches the
   sm90 forward n_layers times in the worker ("cluster stream" line:
   first item s, later item ms, the stream beside generate's wall).
   Lineage, after the task's CUDA tensor: every copy of it freed
   through the GCS's FreeObject, the next get re-runs the task (which
   logs its pid per run) and gives a CUDA tensor bitwise the first and
   the seeded regeneration, the task run twice; a put CUDA tensor freed
   so raises ObjectLostError ("cluster lineage" line: the second get's
   s, whether the re-run took the task's first worker).  Last, the
   notice armed: the node Draining within 5 s with its reason
   ("cluster drain").
   Gates: the node advertises GPU 1 (from the detector); the worker's weights' checksums (embedding,
   layer 0's wq, head) equal this process's; its engine on cuda; tokens
   equal the direct engine's; the worker counts n_layers sm90 forward
   launches for the 1500-token prefill and none for the 20-token one;
   the second actor not ready after 2 s; the card's free memory (this
   process's mem_get_info, its own cache emptied first) back within 1
   GB of its reading before the first actor, within 30 s of the kill; the tensor and every slab
   round trip bitwise on the card; every no-op call but the first on
   each connection sent as a hot frame; after shutdown no process of the
   session alive within 10 s, the session directory and the arena
   removed.  On a failed gate it prints the tail of every log of the
   session first.  Prints one "cluster" JSON line: the actor's start,
   each call's wall beside the direct one, nvidia-smi's memory per
   process while the engine lives and after the kill, the slab's put,
   round trip and get (ms and GB/s; the first alone, then the median of
   three), /dev/shm's size, the node store's capacity, and the runtime's
   cost per no-op call beside local mode's, with the hot-frame counts
   of those calls.  Its launches are the kernels line's "cluster" path.
11. Tracing and metrics through a cluster on the card
   (``init(num_cpus=2)``): a num_gpus=1 actor builds two LLMServers on
   Llama-3-8B's widths with its depth cut to TRACE_LAYERS (8) layers
   (random weights from seed 0, slots=2, max_seq=4096,
   kv_offload="auto": the object-plane store in the worker), one with
   bucketed prefill, one with the reference's chunks of 64.  Under one
   sampled trace context (the global trace_sample_rate left at its
   default; every other call of the phase under an unsampled one) the
   driver sends a completion of 1500 token ids, a session's two turns
   with its slab evicted to the object-plane store between them, and a
   stream, and records the request's root span.  Gates: the traced
   completion's tokens equal an untraced one's on the same actor; the
   worker launched the sm90 forward n_layers times for each bucketed
   prefill of 128 tokens or more and nothing else; the spans in the
   GCS and util.tracing.live_spans() are one trace with one root and
   no orphan, holding the driver's call spans, the worker's execution
   spans, llm:admission inside llm:generate, llm:stream and one
   llm:restore under the second turn
   whose bytes equal the evicted slab's, and task_spans() derives no
   span for a traced task; art.timeline(path) writes JSON with task
   slices for the actor calls and one request row per span; MetricsGet
   holds art_rpc_latency_s series (PushTask's client and worker stages)
   whose bucket counts sum to their count and whose exemplar names the
   trace, and the three art_llm_* gauges tagged deployment="llm";
   device_stats_gauges() here gives three series of cuda:0 whose limit
   is the card's total memory; shutdown leaves no process, session
   directory or arena.  Prints a "trace split" line (not gated): the
   medians, in µs, of 200 sampled no-op actor calls' stages (client
   serialize, wire, worker queue, execute) from their spans, beside the
   median wall of those calls and of 200 unsampled ones, in turns, with
   the card's name and power limit; then one "tracing" JSON line.  Its
   launches are the kernels line's "tracing" path.
12. Serve on the card (``init(num_cpus=4)``): build_llm_deployment
   serves Llama-3-8B's widths with its depth cut to DEPLOY_LAYERS (8)
   layers (random weights from seed 0, bf16, slots=2,
   max_seq=4096, max_ongoing_requests=8) from replicas in worker
   processes, deployed together: "llm", two replicas with bucketed
   prefill, and "sessions", one replica with chunks of 64,
   kv_idle_evict_s=1.0 and kv_offload="auto" (the object-plane store
   in a replica); a subclass of LLMServer defined here, deployed with
   build_llm_deployment's arguments, warms each replica up (one request
   per prefill bucket) and reports its launches, prompts and times.
   Through the DeploymentHandle one completion of 1500 token ids, a
   chat of 300 characters, a stream of 100 and a completion of 40 (16
   new tokens each) alone, then the same from four driver threads;
   over HTTP (aiohttp is installed on the card's machine) a completion
   and an SSE stream of 200; a session's turns around two idle
   evictions beside the same turns with none; a 0.134 GB slab (a slot
   of that model) through a KvVault actor and
   ObjectPlaneKvStore(vault=...).  Gates: greedy tokens equal whichever
   replica answered, over HTTP and SSE too;
   both replicas served; each "llm" replica launched the sm90 forward
   8 times per bucketed prefill of 128 tokens or more and nothing
   else, "sessions" nothing; the sessions replica's store is
   ObjectPlaneKvStore, each offload 134,217,728 bytes, the continued
   turns' tokens equal the unevicted ones; the vault's slab back
   bitwise; serve.shutdown() and shutdown() leave no process (pgrep),
   session directory or arena, and the card's free memory comes back.
   Prints "deployment up" (serve.run per deployment, each replica's
   build and warm-up), "deployment walls" (per request kind, alone and
   the median from the threads), "deployment session" (each offload's
   extract and put, each restore's get and restore_wait, each install
   on the host and the card) and one "deployment" JSON line (the
   vault's put and fetch ms and GB/s, requests and launches per
   replica).  Its launches are the kernels line's "deployment" path.
12b. Data and batch inference on the card (``init(num_cpus=4)``):
   build_llm_processor(<Llama-3-8B's widths, its depth cut to
   DATA_LAYERS (8) layers>, concurrency=2, slots=8, max_seq=4096,
   device="cuda") generates 16 greedy tokens for each of
   32 rows of 128-1500 token ids (default_rng(18)) from
   data.from_items(rows, parallelism=8), its two engine actors each in
   a worker process; then, with the actors killed,
   build_logprob_processor(<the same model>, batch_size=8, max_len=1024)
   scores 64 rows of 1024 token ids in the driver through the device
   feed, with prefetch_batches 2 and 0; then random_shuffle, sort and
   groupby().count() of 1,000,000 list-block ints in 16 blocks, which
   must load no pyarrow in the driver.  Gates: 32 rows back in order with
   their keys and "generated_text"; each actor 8 sm90 forward launches
   per prefill (256 together) and nothing else; the feed's card
   batches bitwise the collated host batches; NLL per row equal at
   both settings and within DATA_NLL_TOL of reference attention on the
   same weights; no flash launch while scoring (1023 tokens: blockwise,
   the reference's rule); the million-row results equal numpy's;
   nothing left after shutdown(); one LLMEngine in the driver
   generating the actors' token ids (16 a row) and texts row by row.
   Prints "data actors up" (each actor's start, the card's free
   memory), "data blocks" (each block's wall), "data score" (wall,
   starve fraction and stage times per prefetch setting), "data nll",
   "data table" (seconds and rows/s per operation), "data generation"
   (rows/s, generated tokens/s) and one "data" JSON line.  Its
   launches are the kernels line's "data" path.
12c. The operator's surface on the card (``init(num_cpus=4)`` with
   the dashboard, a node agent publishing the card's memory every 2 s
   and the CPU profiler at 67 Hz in every process): a placement group
   [{"CPU": 1, "GPU": 1}] (STRICT_PACK) holds one num_gpus=1 actor with
   LLMEngine("llama3-8b", slots=4, max_seq=2048) in its bundle, which
   generates 16 greedy tokens for 4 prompts of 256-1024 token ids
   (default_rng(19)) while POST /api/profile captures a 2-s trace.
   Gates, each on an "operations gate" line: 32 sm90 forward launches
   per prefill in the actor's process and nothing else; the group
   CREATED on the node, the GPU taken while the actor lives and free
   after the kill and the group's removal; the actor ALIVE in the state
   API and its worker's log listed and read; the agent's
   art_device_hbm_bytes_in_use >= 16.06e9 in /metrics, within 1 GiB of
   nvidia-smi's memory.used; CPU profiles of the driver, the GCS, the
   daemon, the worker and the agent (the engine's frames in the
   worker's), through /api/cpuprofile and the CLI, each profiler's mean
   cost per sample under 300 µs in the driver and the worker; the trace
   archive listed, served and holding a Chrome trace; the CLI's status
   and placement groups; nothing left after shutdown; the actor's token
   ids equal to a driver engine's.  Prints "operations io loops" (the
   GCS's and the daemon's io threads while the actor started) and one
   "operations" JSON line.  Its launches are the kernels line's
   "operations" path.
12d. Jobs, the client, runtime envs and export events on the card
   (``init(num_cpus=4)`` with the dashboard, a node agent and task
   events exported; a client server, ``python -m
   ant_ray_tpu_torch.util.client.server``, beside it): a job submitted
   through JobSubmissionClient with a working_dir and an env var naming
   ``art://<client server>``.  The job, a driver outside the cluster,
   creates through the client one num_gpus=1 actor with
   LLMEngine("llama3-8b", slots=4, max_seq=2048) under a runtime env of
   an env var and a py_module, generates 16 greedy tokens for the
   operations phase's 4 prompts, and puts a 256-MiB bf16 CUDA tensor
   through the client that the actor takes by ref and returns.  A
   second job (sleep 600) is stopped; a num_gpus=1 task runs in a pip
   venv built from a wheel made here.  Gates, each on a "jobs gate"
   line: the job SUCCEEDED and listed, its log holding its result;
   token ids equal to the operations phase's driver engine's row by
   row; 32 sm90 forward launches per prefill in the actor's process and
   nothing else; the env var and the py_module seen in the actor; the
   tensor bitwise equal after the round trip, on the card at both ends,
   the client server mapping no CUDA library; the stopped job STOPPED
   and its processes gone; EXPORT_DRIVER_JOB and the actor's ALIVE and
   DEAD in /api/export_events; the venv task on the venv's interpreter
   with the wheel, the sm90 forward's library loaded unbuilt and
   launched once at B=1 S=4096 H=32 KVH=8 D=128 within TOL of its plain
   version, a task without the env unable to import the wheel; nothing
   left after shutdown.  Prints each step's wall on a "jobs <step>"
   line and one "jobs" JSON line.  Its launches are the kernels line's
   "jobs" path.
13. Serving from a checkpoint directory: llama-400m at its published
   widths and depth (bf16, seed 0) written to a temporary directory of
   this checkout in the HF layout twice, as model.safetensors (a writer
   here: the format's header and raw buffers) and as pytorch_model.bin
   (torch.save); each loaded onto the card through LLMEngine(<dir>,
   slots=8, max_seq=4096, prefill_chunk_tokens=None).  Gates: every leaf
   bitwise equal to the weights in memory; greedy tokens of prompts of
   100, 700 and 1500 token ids equal to an engine on the weights in
   memory; one completion through LLMServer(<dir>) equal to the
   engine's; the sm90 forward launched 24 times per prefill (every bucket
   is 128 or more), nothing else.  Prints per format the file's bytes,
   write and load seconds and GB/s (host clock; the write ends in fsync,
   the load is the engine's construction), then the launches and peak
   memory.
14. LLMServer on Llama-3-8B's widths with its depth cut to
   SERVER_LAYERS (8) layers (random weights from seed 0, slots=8,
   max_seq=4096, the reference's serving defaults: chunks of 64,
   kv_offload="local").  Four client threads send four completions of
   100 to 1500 token ids (one opening a session), two chats, two streams
   (a completion and one of the chats) and the session's second turn;
   then end_session, load_signals, a request whose deadline has passed
   and one whose deadline (SERVER_DEADLINE: 0.2 s for 128 tokens) runs
   out mid-generation.  Gates: every
   greedy answer equal to the same request served alone afterwards; each
   stream carrying its answer's tokens, each chunk its token's text;
   chat usage matching the tokens; the expired request shed with the
   engine's stats and request ids untouched; the late one raising after
   its first token; no flash launch.  Prints TTFT per request
   (handle.ttft_s() through the server's loop), the wall time,
   load_signals, device_memory_stats() and peak memory.
15. The training slice: llama-400m at its published widths and all 24
   layers, bf16, random weights from seed 0, one fixed batch of 8 x 2049
   token ids, AdamW (make_optimizer), remat "none": 3 warm-up and 10
   timed train_step calls.  The launch counts are reset just before and
   read just after: every step must launch the forward, dQ and dK/dV
   once per layer, all on the sm90 route.  Prints the step time,
   tokens/s, MFU against the bf16 peak, peak memory and a torch.profiler
   line of one step.
15b. Sharded training (the parallel phase's second part) on the
   training slice's weights after its steps and its first 4 rows: one
   loss_fn(mesh=build_mesh(devices=["cuda:0"] * 4, fsdp=2, tp=2),
   remat="none") step with its backward against the unsharded step
   (the loss within BF16_LOSS_TOL, every gradient leaf within
   BF16_GRAD_TOL; the unsharded step with reference attention printed
   beside it), the sm90 forward, dQ and dK/dV each launched 4 cells x
   24 layers times; the loss through ring attention at sp=2 and
   through loss_fn_pp at pp=2 with 2 microbatches, each within
   BF16_LOSS_TOL of the unsharded loss.  ``python3 tools/phase.py
   parallel`` runs 5b and 15b alone.
16. Remat: the training slice again, from the same weights, under
   each remat policy ("none", "full", "dots", "matmuls"), 3 warm-up and
   2 timed steps each (REMAT_STEPS).  Gates: the forward kernel
   launched twice per layer and step under "full" and "dots" and once under "none" and
   "matmuls" (whose selective-checkpoint policy saves the flash
   forward's out and lse), the backward pair once; the losses of the
   first two steps equal across the policies within BF16_LOSS_TOL.
   Prints per policy the step time, tokens/s, MFU and peak memory, a
   profile, and the step on 1 x 128 tokens, where the host sets the
   time.
17. GPT-2: `gpt2` (124 M) at its published widths and depth, in its
   published fp32 (the 3xTF32 forward and backward) and in a
   bf16 copy (the sm90 kernels at head_dim 64, plain multi-head
   attention), random weights
   from seed 0, a fixed batch of 8 x 1025 token ids, AdamW, 3 warm-up
   and 10 timed steps; every block checkpointed, as in the reference.
   Gates: launches per step (forward twice per layer, backward pair
   once, on the dtype's route); the first loss within GPT2_LOSS_TOL of
   the plain fp32 loss (reference attention) on the same weights; the
   loss falling; the last-position logits of a 1024-token forward within
   GPT2_LOGIT_TOL of reference attention's and the greedy next tokens
   equal but for ties.  Prints step time, tokens/s, MFU against the
   peak of the dtype the step computes in, and peak memory.
18. Head_dim 256: a Llama at Gemma-2B's widths (hidden 2048, 8 heads
   of 256, 1 KV head, MLP 16384, vocab 256000, tied embeddings, 18
   layers; 2.51 B parameters; SwiGLU and no embedding scale, so not
   Gemma), bf16, random weights from seed 0, a fixed batch of 2 x 2049
   token ids, AdamW, remat "none".  First one step's loss and every
   gradient leaf through the kernels against reference attention on the
   card (D256_GRAD_TOL per leaf, max abs error over max |ref|;
   BF16_LOSS_TOL), then 3 warm-up and 10 timed steps.  Gates: per step
   the sm90_d256 forward, dQ and dK/dV once per layer, nothing else;
   the first step's loss within BF16_LOSS_TOL of reference
   attention's; the loss falling.  Prints
   step time, tokens/s, MFU, peak memory and a profile of one step with
   the attention kernels' share.
19. Head_dim 256 in fp32: the same Llama at Gemma-2B's widths and all
   18 layers in fp32 (TF32 off), remat D256_FP32_REMAT ("full": AdamW's
   state alone is 20 GB), the same weights' seed and batch.  First one
   step's loss and every gradient leaf through the kernels against fp32
   reference attention on the card (D256_FP32_GRAD_TOL per leaf,
   D256_FP32_LOSS_TOL), then D256_FP32_STEPS (2 warm-up, 2 timed)
   train_step calls.  Gates: per step the tf32x3_d256 dQ and dK/dV
   once per layer (18 pairs) and no other backward kernel, the
   tf32x3_d256 forward once per layer and recompute (36), nothing else;
   the loss falling.  Prints step time, tokens/s, MFU against fp32's 67
   TFLOP/s, peak memory and a profile of one step with the attention
   kernels' card time, the forward's and the backward pair's apart.
19b. Tune and the autoscaler on the card: a head-only Cluster (2 CPUs,
   no GPU) and the port's Autoscaler over a LocalSubprocessProvider
   with one node type, "h100" ({"CPU": 4, "GPU": 1}, max_workers=1,
   idle_timeout_s 3, rounds every 0.5 s, one heartbeat before anything
   is submitted).  A Tuner sweeps lr over 1e-6, 3e-4, 1e-3 and 1.0 under
   ASHA (max_t 8, grace period 2, reduction factor 2) with {"GPU":
   0.25} per trial, so the four trials wait for a node the autoscaler
   launches and share its card.  Each trial, a function trainable in a
   worker of that node, builds llama-400m at its published widths and
   depth (bf16, seed 0) on cuda (or raises), makes AdamW at its lr and
   runs train_step on one seed-0 batch of 1 x 2049 token ids, reporting
   each step's loss with the flash launch counters read in its process.
   Gates: no trial error; the autoscaler launched exactly ["h100"], and
   every trial ran on that node, on cuda:0; the step-0 losses bitwise
   equal across the trials and equal to (else within BF16_LOSS_TOL of)
   the driver's loss_fn on the same weights and batch; no trial stopped
   before the grace period, at least one before max_t, a fresh ASHA fed
   the recorded results in order gives the same decisions, each trial's
   history ending where ASHA stopped it; get_best_result names the lr
   whose trial reached max_t with the lowest last loss; each trial of s
   steps launched 24 s sm90 forwards and 24 s sm90 backward pairs and
   nothing else; the node terminated within TUNE_SCALE_DOWN_S of fit()'s
   return, the provider listing no node after, nvidia-smi listing no
   trial's process and none alive; nothing left after shutdown().
   Prints one "tune" JSON line: the node's launch seconds, each trial's
   start (import, CUDA init, parameter init, first step; its start after
   fit() began), steps and last loss, ASHA's stops, the best lr, fit()'s
   and the phase's wall, the scale-down seconds.  Its launches are the
   kernels line's "tune" path.
19c. Collectives: an NCCL group of one rank on the card
   (init_collective_group(1, 0, backend="nccl")).  Gates, bitwise: each
   per-rank verb (allreduce, reduce and reducescatter under every
   ReduceOp, broadcast, allgather, barrier) and each *_multidevice verb
   over the visible cards against its plain torch result; send and
   recv to itself raising ValueError; allreduce_coalesced and
   sync_pytree of a pytree of llama-400m's parameter shapes in bf16
   (12 leaves, 11 buckets) against the per-tensor verb; the int8
   transport on 2^20 + 37 fp32 values against a plain quantize and
   dequantize written out here, and within half a block's step of the
   input; the GradientSyncer fed by post-accumulate-grad hooks during
   a backward against the one-shot sync_pytree of the same gradients;
   every result on cuda in its dtype; the group gone after
   destroy_collective_group.  Prints one "collective" JSON line (the
   init's seconds, the pytree's bucket count and fusion_stats, three
   walls of one fused sync_pytree, the int8 error and wire bytes).  No
   flash kernel runs.
19d. The train plane: a TorchTrainer of TRAINER_WORKERS (2) ranks
   sharing the card (ScalingConfig(use_gpu=True, resources_per_worker=
   {"CPU": 1, "GPU": 0.5}), gang-scheduled through a placement group)
   in a Cluster of 4 CPUs and 1 GPU.  The driver makes llama-400m's
   seed-0 weights once, writes them with train.save_pytree and
   computes loss_fn over the train phase's 8 x 2049 tokens; each rank
   (trainer_loop, in a worker) loads them onto its card, takes its 4
   rows, and runs TRAINER_STEPS (2) steps of loss_fn, backward,
   train.sync_gradients over a gloo group it creates (NCCL refuses two
   ranks of one group on one card) and AdamW, logging each step's
   loss, launches, parameter checksums and times; rank 0's last step
   saves its parameters and optimizer state and reports that
   checkpoint.  Gates: no error, the last step reported; each rank
   launching the sm90 forward and backward pair once per layer and
   step and nothing else, on cuda:0; both ranks' checksums equal after
   every step; the step-0 mean loss within BF16_LOSS_TOL of the
   driver's; the mean loss falling; the checkpoint loading back onto
   cuda bitwise against rank 0's last checksums, with 12 optimizer
   states; nothing left after shutdown().  Prints one "trainer" JSON
   line (each rank's step, backward and sync seconds, the fusion
   stats, peak memory and start split).  Its launches are the kernels
   line's "trainer" path.
19e. RLlib on the card, in this process with no cluster up (the env
   runners inline, no process started): PPOConfig().environment(
   "CartPole-v1")...build().train() at the reference's learning
   configuration (tests/test_rllib.py:43-60: 2 runners x 8 envs x 128
   steps, lr 1e-3, 6 epochs, minibatch 256, RLLIB_ITERATIONS (12)
   iterations, seed 0).  Gates: the best episode_return_mean more than
   RLLIB_LEARNED (20) over the first, total_loss finite, every
   parameter leaf on cuda:0.  Then one update of each of PPO, IMPALA,
   APPO, DQN, SAC and BC (the algorithm's own step; BC's learner) from
   the same weights on one fixed batch or fragment set, on the card
   and on the CPU, every leaf within RLLIB_UPDATE_TOL (rtol 1e-4, atol
   1e-5).  Prints each iteration's sample and update seconds, env steps
   and Adam steps per second, the phase's wall time and one "rllib"
   JSON line; the phase is held to RLLIB_BUDGET_S (15 s).  The MLPs
   reach no flash kernel: the learning run's launches, all 0, are the
   kernels line's "rllib" path.
20. One line {"kernels": [...]} with the fifteen kernels (the sm90,
   tf32x3, sm90_d256, tf32x3_d256 and CUDA-core forward; the sm90, tf32x3,
   sm90_d256, tf32x3_d256 and CUDA-core dQ and dK/dV; launches by path,
   the main paths being serving, the tensor-parallel engine's two
   cells, sessions, the loop, the cluster's
   worker, the traced cluster's worker, the deployment's replicas, the
   data processor's actors, the operations and the jobs phases' actors,
   the checkpoint directory, the
   server, training, the sharded step's four cells, training under
   each remat policy, GPT-2 in fp32
   and bf16, the head_dim-256 Llama in bf16 and fp32, the tune
   trials, the trainer's ranks and RLlib's learning run; the older
   kernels' times also at GPT-2's shape, the sm90_d256 ones at Gemma-7B's and Gemma-2B's attention and
   at the head_dim-256 path's own, the tf32x3_d256 ones at the fp32
   path's and at FP32_D256_ATTN).  The CUDA-core forward, dQ and dK/dV
   kernels are on no route: they show 0 launches, and every other kernel
   must show some on a main path;
   then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

TF32 is switched off for matmuls and cuDNN, so fp32 comparisons are
made in full fp32.

Three more modes give the readings behind D256_GRAD_TOL and
D256_FP32_GRAD_TOL (one GPU):

    python3 chip_smoke.py --d256-gate-readings [CHECKOUT]
    python3 chip_smoke.py --d256-fp32-gate-readings [CHECKOUT]
    python3 chip_smoke.py --plant-d256-fault FAULT DIR

The first runs CHECKOUT's (default: this directory's) backward kernel
phase and its head_dim-256 gradient check with BWD_TOL["bfloat16"],
D256_GRAD_TOL and BF16_LOSS_TOL at infinity (launch and route gates
stay), then the gradient check twice more with the kernels' plain
versions patched in (the backward, then both directions), and prints
one JSON line.  The second does the same for fp32 (the forward's and
the backward's errors at FP32_D256_ATTN and the fp32 path's attention,
then the fp32 gradient check under D256_FP32_REMAT).  The third copies
this script and the package into DIR (new) with one of D256_FAULTS
planted in the sm90_d256 backward, the tf32x3_d256 forward or
backward, or the tf32x3 header.  tools/kernel_ab.py times the kernels
of several checkouts in turns, tools/d256_fp32_remat.py the fp32 d256
Llama under remat "none" and "full".
"""

from __future__ import annotations

import atexit
import dataclasses
import importlib.util
import itertools
import json
import os
import re
import shlex
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
# fp32-accurate products in 3xTF32: three TF32 tensor-core products (495
# TFLOP/s dense, 494.7 in NVIDIA's data sheet) for each fp32 one.
TF32X3_FLOPS = 494.7e12 / 3
PEAK_BYTES = 3.35e12
# Forward: max abs error of out and of lse.  fp32 readings
# (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): the 3xTF32
# forward up to 6.1e-6 (out) and 4.8e-6 (lse); the same kernel with one
# TF32 product 3.9e-4 to 1.8e-3 and 2.4e-4 to 1.1e-3, refused.  The
# tf32x3_d256 forward (--d256-fp32-gate-readings, same card) up to 4.0e-6
# and 1.9e-6.
TOL = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}
# Backward: max abs error over max |ref|, per tensor (dq, dk, dv).  bf16:
# both sides round p and ds to bf16 at the same points but sum in another
# order, so a value near a rounding boundary may land one bf16 ulp
# (2^-8 relative) away; fp32: summation order only (the 3xTF32 products
# keep ~22 mantissa bits).  fp32 readings (tools/fp32_gate_readings.py,
# H100 80GB HBM3 at 700 W): 3xTF32 up to 3.6e-5; the same kernels with
# one TF32 product 3.3e-4 to 9.3e-4, refused.
BWD_TOL = {"bfloat16": {"dq": 1e-2, "dk": 1e-2, "dv": 1e-2},
           "float32": {"dq": 1e-4, "dk": 1e-4, "dv": 1e-4}}
# fp32 model gradients, per leaf, over max |ref|: 7.9e-6 through the
# 3xTF32 backward, 5.3e-4 with one TF32 product (same readings).
GRAD_TOL = 1e-4
# bf16 model gradients through the sm90 kernels against bf16 reference
# attention, per leaf, over max |ref|.  The two paths round at different
# points (the kernels round p before P.V, and p and ds before every
# backward product; reference attention keeps its softmax in fp32), and
# each rounding is up to 2^-9 relative; two layers of bf16 matmuls carry
# that into every leaf.  5e-2 is about ten such roundings in a row, and
# far below what a wrong tile, mask or layout gives (order 1).
BF16_GRAD_TOL = 5e-2
BF16_LOSS_TOL = 1e-2   # the loss (~5.7) on fp32 logits of bf16 layers
# The head_dim-256 Llama's gradients (d256_phase) through the sm90_d256
# forward and backward against bf16 reference attention (softmax in
# fp32), per leaf, over max |ref|.  Readings (--d256-gate-readings, H100
# 80GB HBM3 at 700 W), taken while the forward still ran on the CUDA
# cores: the kernels 5.37e-2, their plain versions on the same path
# 5.50e-2 (backward only) and 5.34e-2 (both): 18 layers carry the bf16
# rounding of p and ds into every leaf, where BF16_GRAD_TOL's two layers
# read 1.2e-2.  With both directions on the tensor cores the kernels read
# 5.26e-2 (d256_phase, same card).  Faults planted in the backward: dQ's
# diagonal masked 0.163, dK/dV's 0.489, a cluster rank's partial dropped
# 0.702, the warpgroups' trade skipped 1.32.  The limit lies between.
D256_GRAD_TOL = 0.1
# The fp32 head_dim-256 path (d256_fp32_phase): remat "full" (AdamW's
# state alone is 20 GB at 2.51 B fp32 parameters; the peaks of both
# policies, tools/d256_fp32_remat.py, are in PERF.md), 2 warm-up and 2
# timed steps (5 until the collective and trainer phases came, 3 until
# the parallel phase came).
D256_FP32_REMAT = "full"
D256_FP32_STEPS = (2, 2)
# Its gradients through the tf32x3_d256 forward and backward against fp32
# reference attention, per leaf, over max |ref|.  Readings
# (--d256-fp32-gate-readings, H100 80GB HBM3 at 700 W): the kernels
# 8.95e-5 (embed), the forward kernel with the plain backward 4.98e-5,
# both plain versions 1.93e-5: eighteen layers carry the 3xTF32 rounding
# (~2^-22 a product) into every leaf.  Faults planted
# (--plant-d256-fault) in the forward: its causal mask one key ahead
# 0.790, a quarter of the partial scores dropped 1.47; in the backward
# pair (read with the CUDA-core forward): one TF32 product instead of
# three 4.88e-4, dQ's diagonal masked 0.151, dK/dV's 0.454, a cluster
# rank's partial dropped 0.724, a quarter of the partial scores dropped
# 0.613.  The limit lies between the sound reading and the one-product
# fault, ~2x from each.
D256_FP32_GRAD_TOL = 2e-4
# Its first loss (~12.9, where an fp32 ulp is 2^-20) against reference
# attention's.  Readings (--d256-fp32-gate-readings, H100 80GB HBM3 at
# 700 W): one ulp through the kernels (9.54e-7), 0 through their plain
# versions; the backward's faults leave it as it is (the loss is the
# forward's alone).  The limit is four ulps; the forward's faults read
# far above it: its causal mask one key ahead 7.22e-4, a quarter of the
# partial scores dropped 1.45e-2.
D256_FP32_LOSS_TOL = 4 * 2.0 ** -20
REPS = 10


def _median_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _pairs(q_len, kv_len, causal):
    """(q, k) pairs the inputs need: top-left causal, query i sees
    min(i + 1, kv_len) keys."""
    if causal:
        return sum(min(i + 1, kv_len) for i in range(q_len))
    return q_len * kv_len


def _roofline(flops, nbytes, dtype_name, peak_flops=None):
    t_ops = flops / (peak_flops or PEAK_FLOPS[dtype_name])
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name, causal,
           peak_flops=None):
    """Least time (ms) for the work these inputs need, what sets it, and
    the FLOPs counted (4*D per (q, k) pair: S = Q.K^T and P.V), at the
    dtype's peak unless ``peak_flops`` names another."""
    flops = 4.0 * batch * heads * dim * _pairs(q_len, kv_len, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (elt * batch * dim * (2 * q_len * heads + 2 * kv_len * kv_heads)
              + 4 * batch * heads * q_len)
    return (*_roofline(flops, nbytes, dtype_name, peak_flops), flops)


def _bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name,
                causal, peak_flops=None):
    """Least time (ms), what sets it, and the FLOPs counted, for the dQ
    kernel (S, dP, dS.K: 6*D FLOPs per pair; reads q, k, v, dO, lse,
    delta, writes dq), the dK/dV kernel (S, dP, P^T.dO, dS^T.Q: 8*D;
    reads the same, writes dk, dv) and the whole backward (five matmuls,
    10*D; reads q, k, v, out, dO, lse, writes dq, dk, dv), at the
    dtype's peak unless ``peak_flops`` names another."""
    per_dim = batch * heads * dim * _pairs(q_len, kv_len, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    q_bytes = elt * batch * q_len * heads * dim
    kv_bytes = elt * batch * kv_len * kv_heads * dim
    row_bytes = 4 * batch * heads * q_len
    work = {"dq": (6.0, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
            "dkv": (8.0, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
            "backward": (10.0, 4 * q_bytes + 4 * kv_bytes + row_bytes)}
    return {key: (*_roofline(per * per_dim, nbytes, dtype_name, peak_flops),
                  per * per_dim)
            for key, (per, nbytes) in work.items()}


def _shape(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name, causal):
    return (f"B={batch} Sq={q_len} Skv={kv_len} H={heads} KVH={kv_heads} "
            f"D={dim} {dtype_name} {'causal' if causal else 'full'}")


# Forward shapes at which the CUDA-core kernel (flash_attention_fwd.cu,
# on no route) is also launched and timed beside the sm90 one, as
# (batch, q_len, heads): the serving slice's largest prefill and the
# training slice.
FWD_BEFORE_AFTER = {(1, 4096, 32), (8, 2048, 8)}
# GPT-2's attention (B, Sq, Skv, H, KVH, D): the main path of the fp32
# forward and backward on the tf32x3 route and of the bf16 ones at
# head_dim 64; in fp32 the CUDA-core kernels are also timed there.
GPT2_ATTN = (8, 1024, 1024, 12, 12, 64)
# Gemma-7B's and Gemma-2B's attention (B, Sq, Skv, H, KVH, D) at a
# training batch of 4 x 2048: the shapes of the bf16 head_dim-256 kernels
# (the sm90_d256 forward and backward); there, and at the d256 path's
# own, the CUDA-core forward is also timed, and at Gemma-7B's the
# CUDA-core backward pair.
GEMMA7B_ATTN = (4, 2048, 2048, 16, 16, 256)
GEMMA2B_ATTN = (4, 2048, 2048, 8, 1, 256)
# fp32 at head_dim 256 (B, Sq, Skv, H, KVH, D), PERF.md's rows 1b-3b:
# the tf32x3_d256 forward's and backward's route, with the CUDA-core
# kernels timed beside them; both also timed at the fp32 d256 path's own
# attention.
FP32_D256_ATTN = (1, 512, 512, 8, 2, 256)
# The head_dim-256 path's batch of token ids (d256_phase): 2 sequences
# of 2048 tokens and the next one.
D256_TOKENS = (2, 2049)


def _d256_config():
    """A Llama at Gemma-2B's widths (google/gemma-2b's config.json: hidden
    2048, 8 heads of 256, 1 KV head, intermediate 16384, vocab 256000,
    tied embeddings, 18 layers, rope theta 10000, norm eps 1e-6): SwiGLU
    and no embedding scale, so a Llama with Gemma's widths, not Gemma;
    bf16."""
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415

    return llama.LlamaConfig(
        vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        mlp_dim=16384, max_seq=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True)


def _d256_attn():
    """The head_dim-256 path's attention (B, Sq, Skv, H, KVH, D), from
    _d256_config and D256_TOKENS."""
    cfg = _d256_config()
    batch, seq = D256_TOKENS[0], D256_TOKENS[1] - 1
    return (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _fwd_errors(out, lse, ref_out, ref_lse, name, shape, label):
    """Max abs error of out and of lse; raises beyond TOL."""
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol_out, tol_lse = TOL[name]
    if not (err_out <= tol_out and err_lse <= tol_lse):
        raise AssertionError(
            f"{label} disagrees with its plain version at {shape}: out err "
            f"{err_out} (tol {tol_out}), lse err {err_lse} (tol {tol_lse})")
    return err_out, err_lse


def _fwd_kernel_ms(torch, fa, name, q, k, v, causal):
    """Median ms of the forward kernel ``name``, launched directly (no
    count), and its (out, lse) from the last launch."""
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    ms = _median_ms(torch, lambda: fa._launch(
        name, (q, k, v, out, lse), q, k, q.shape[3] ** -0.5, causal))
    return ms, out, lse


def _shares(row):
    """A timed row's share of its bound; for tf32x3 at 3xTF32's rate and
    at the fp32 FMA rate."""
    if "share_of_fp32_fma_bound" not in row:
        return f"{row['share_of_bound']:.1%} of its bound"
    return (f"{row['share_of_bound']:.1%} of its 3xTF32 bound, "
            f"{row['share_of_fp32_fma_bound']:.1%} of the fp32 FMA one")


def kernel_phase(torch, fa):
    """The forward kernel, through the route the wrapper picks, against
    flash_attention_fwd_lse_ref; at FWD_BEFORE_AFTER (sm90), at GPT-2's
    fp32 shape (tf32x3), at Gemma-7B's, Gemma-2B's and the d256 path's
    attention (sm90_d256) and at both fp32 head_dim-256 shapes
    (tf32x3_d256) also the CUDA-core kernel, launched directly, for a
    before-and-after on one card."""
    import torch.nn.functional as F  # noqa: PLC0415

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal)
        (1, 128, 128, 32, 8, 128, bf16, True),
        (1, 512, 512, 32, 8, 128, bf16, True),
        (1, 1024, 1024, 32, 8, 128, bf16, True),
        (1, 2048, 2048, 32, 8, 128, bf16, True),
        (1, 4096, 4096, 32, 8, 128, bf16, True),
        (8, 2048, 2048, 8, 4, 128, bf16, True),    # the training slice
        (1, 2048, 2048, 32, 8, 64, bf16, True),    # llama3-1b's heads
        (2, 192, 192, 8, 2, 128, bf16, True),      # ragged on 128-row tiles
        (2, 320, 320, 8, 8, 64, bf16, False),
        (1, 1024, 1024, 32, 8, 64, fp32, True),
        (1, 1024, 1024, 32, 8, 128, fp32, True),   # fp32, D=128, GQA 4
        (2, 192, 192, 8, 2, 128, fp32, False),     # fp32, three 64-row tiles
        (1, 128, 256, 32, 8, 64, fp32, True),      # fp32, Sq < Skv
        (1, 256, 128, 32, 8, 128, fp32, True),     # fp32, Sq > Skv
        (1, 1024, 1024, 32, 32, 128, bf16, False),
        (1, 128, 256, 32, 8, 128, bf16, True),
        (1, 256, 128, 32, 8, 128, bf16, True),
        (1, 512, 512, 8, 2, 256, bf16, True),
        (*FP32_D256_ATTN, fp32, True),             # head_dim 256 (tf32x3_d256)
        (*_d256_attn(), fp32, True),               # the d256 fp32 path's
        (*GPT2_ATTN, fp32, True),                  # GPT-2, fp32 (tf32x3)
        (*GPT2_ATTN, bf16, True),                  # GPT-2, bf16 (sm90)
        (*GEMMA7B_ATTN, bf16, True),               # head_dim 256 (sm90_d256)
        (*GEMMA2B_ATTN, bf16, True),
        (*_d256_attn(), bf16, True),               # the d256 path's
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = rand(batch, q_len, heads, dim)
        k = rand(batch, kv_len, kv_heads, dim)
        v = rand(batch, kv_len, kv_heads, dim)
        name = str(dtype).removeprefix("torch.")
        shape = _shape(batch, q_len, kv_len, heads, kv_heads, dim, name,
                       causal)
        route = fa._route(dtype, dim, "fwd")
        before = (fa.fwd_sm90_launch_count, fa.fwd_tf32x3_launch_count,
                  fa.fwd_sm90_d256_launch_count,
                  fa.fwd_tf32x3_d256_launch_count)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        took = ("sm90" if fa.fwd_sm90_launch_count > before[0] else
                "tf32x3" if fa.fwd_tf32x3_launch_count > before[1] else
                "sm90_d256" if fa.fwd_sm90_d256_launch_count > before[2]
                else "tf32x3_d256"
                if fa.fwd_tf32x3_d256_launch_count > before[3] else "none")
        if took != route:
            raise AssertionError(f"forward at {shape} took route {took}, "
                                 f"expected {route}")
        ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                          causal=causal)
        err_out, err_lse = _fwd_errors(out, lse, ref_out, ref_lse, name,
                                       shape, f"{route} forward kernel")
        # At the dtype's peak: the CUDA-core kernel's ceiling (fp32 FMAs)
        # and the sm90 kernels' (bf16 tensor cores).  tf32x3 and
        # tf32x3_d256 do fp32-accurate products on the tensor cores, whose
        # ceiling for them is 3xTF32's rate; their bound is taken there.
        three_tf32 = route in ("tf32x3", "tf32x3_d256")
        fma_bound = _bound(batch, q_len, kv_len, heads, kv_heads, dim, name,
                           causal)
        bound = (_bound(batch, q_len, kv_len, heads, kv_heads, dim, name,
                        causal, TF32X3_FLOPS)
                 if three_tf32 else fma_bound)
        kernel = "flash_attention_fwd" + fa._SUFFIX[route]
        ms, _, _ = _fwd_kernel_ms(torch, fa, kernel, q, k, v, causal)
        simt = None
        attn = (batch, q_len, kv_len, heads, kv_heads, dim)
        if ((route == "sm90" and (batch, q_len, heads) in FWD_BEFORE_AFTER)
                or (route == "tf32x3" and attn == GPT2_ATTN)
                or (route == "sm90_d256" and attn in (
                    GEMMA7B_ATTN, GEMMA2B_ATTN, _d256_attn()))
                or route == "tf32x3_d256"):
            # The CUDA-core kernel on the same inputs, launched
            # directly: the wrapper no longer routes this dtype and
            # head_dim there.
            s_ms, s_out, s_lse = _fwd_kernel_ms(
                torch, fa, "flash_attention_fwd", q, k, v, causal)
            s_err_out, s_err_lse = _fwd_errors(
                s_out, s_lse, ref_out, ref_lse, name, shape,
                "CUDA-core forward kernel")
            simt = {"route": "simt", "max_abs_err": s_err_out,
                    "lse_err": s_err_lse, **_kernel_stats(s_ms, fma_bound),
                    "bound_ms": fma_bound[0], "bound_by": fma_bound[1]}
            del s_out, s_lse
        del ref_out, ref_lse
        wrapper_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse(
            q, k, v, causal=causal))
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse_ref(
            q, k, v, causal=causal))
        groups = heads // kv_heads
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        if route == "tf32x3_d256" and attn == _d256_attn():
            # Which kernels SDPA runs for this fp32 forward (their names
            # say which backend, and so whether the tensor cores do its
            # products).
            _profile(torch, f"SDPA forward at {shape}",
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=causal), top=8)
        row = {"shape": shape, "route": route, "max_abs_err": err_out,
               "lse_err": err_lse, **_kernel_stats(ms, bound),
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound[0],
               "bound_by": bound[1]}
        if three_tf32:
            row["fp32_fma_bound_ms"] = fma_bound[0]
            row["share_of_fp32_fma_bound"] = fma_bound[0] / ms
        if simt is not None:
            row["simt"] = simt
        print("kernel flash_attention_fwd " + json.dumps(row), flush=True)
        if simt is not None:
            print(f"forward at {shape}: {route} {ms:.3f} ms "
                  f"({_shares(row)}, {row['tflops']:.0f} TFLOP/s) against "
                  f"the CUDA-core kernel's {simt['ms']:.3f} ms "
                  f"({simt['ms'] / ms:.2f}x faster) and SDPA's "
                  f"{library_ms:.3f} ms ({ms / library_ms:.2f}x its time)",
                  flush=True)
        results.append(row)
        del q, k, v, out, lse, qt, kt, vt
    return results


def _bwd_errors(got, want, name, shape, label):
    """Max abs error and max abs error over max |ref| per tensor; raises
    beyond BWD_TOL."""
    abs_err, rel_err = {}, {}
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{key} is {g.dtype} {tuple(g.shape)}, "
                                 f"want {w.dtype} {tuple(w.shape)}")
        abs_err[key] = (g.float() - w.float()).abs().max().item()
        rel_err[key] = abs_err[key] / w.float().abs().max().item()
    if any(rel_err[key] > BWD_TOL[name][key] for key in rel_err):
        raise AssertionError(
            f"{label} disagree with their plain version at {shape}: max abs "
            f"error over max |ref| {rel_err} (tol {BWD_TOL[name]})")
    return abs_err, rel_err


def _kernel_times(torch, fa, suffix, q, k, v, do, lse, delta, causal):
    """Median ms of the dQ and dK/dV kernels named with ``suffix`` (a
    route's, "" for the CUDA-core pair), launched directly (no count),
    and their outputs from the last launch."""
    scale = q.shape[3] ** -0.5
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dq_ms = _median_ms(torch, lambda: fa._launch(
        "flash_attention_bwd_dq" + suffix, (q, k, v, do, lse, delta, dq), q,
        k, scale, causal))
    dkv_ms = _median_ms(torch, lambda: fa._launch(
        "flash_attention_bwd_dkv" + suffix,
        (q, k, v, do, lse, delta, dk, dv), q, k, scale, causal))
    return dq_ms, dkv_ms, (dq, dk, dv)


def _kernel_stats(ms, bound):
    """Per kernel: ms, achieved TFLOP/s of the FLOPs its bound counts, and
    its share of the bound."""
    bound_ms, _by, flops = bound
    return {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms}


def bwd_kernel_phase(torch, fa):
    """The dQ and dK/dV kernels, through the route the wrapper picks,
    against flash_attention_backward_ref; at the training shape (sm90),
    at GPT-2's fp32 shape (tf32x3), at Gemma-7B's attention (sm90_d256)
    and at both fp32 head_dim-256 shapes (tf32x3_d256) also the CUDA-core
    pair, launched directly, for a before-and-after on one card."""
    import torch.nn.functional as F  # noqa: PLC0415

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal)
        (8, 2048, 2048, 8, 4, 128, bf16, True),    # the training slice
        (1, 4096, 4096, 32, 8, 128, bf16, True),
        (1, 2048, 2048, 32, 8, 64, bf16, True),    # llama3-1b's heads
        (2, 192, 192, 8, 2, 128, bf16, True),      # ragged on 128-row tiles
        (2, 192, 192, 8, 8, 64, bf16, False),
        (1, 1024, 1024, 32, 8, 64, fp32, True),
        (1, 1024, 1024, 32, 8, 128, fp32, True),   # fp32, D=128, GQA 4
        (2, 192, 192, 8, 2, 128, fp32, False),     # fp32, three 64-row tiles
        (1, 128, 256, 32, 8, 64, fp32, True),      # fp32, Sq < Skv
        (1, 1024, 1024, 32, 32, 128, bf16, False),
        (1, 128, 256, 32, 8, 128, bf16, True),
        (*FP32_D256_ATTN, fp32, True),             # head_dim 256 (tf32x3_d256)
        (1, 512, 512, 8, 2, 256, bf16, True),
        (*GPT2_ATTN, fp32, True),                  # GPT-2, fp32 (tf32x3)
        (*GPT2_ATTN, bf16, True),                  # GPT-2, bf16 (sm90)
        (*GEMMA7B_ATTN, bf16, True),               # head_dim 256 (sm90_d256)
        (*GEMMA2B_ATTN, bf16, True),
        (*_d256_attn(), bf16, True),               # the d256 path's
        (*_d256_attn(), fp32, True),               # the d256 fp32 path's
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = []
    for batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = rand(batch, q_len, heads, dim)
        k = rand(batch, kv_len, kv_heads, dim)
        v = rand(batch, kv_len, kv_heads, dim)
        do = rand(batch, q_len, heads, dim)
        name = str(dtype).removeprefix("torch.")
        shape = _shape(batch, q_len, kv_len, heads, kv_heads, dim, name,
                       causal)
        route = fa._route(dtype, dim, "bwd")
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        before = (fa.bwd_sm90_launch_count, fa.bwd_tf32x3_launch_count,
                  fa.bwd_sm90_d256_launch_count,
                  fa.bwd_tf32x3_d256_launch_count)
        got = fa.flash_attention_backward(q, k, v, out, lse, do,
                                          causal=causal)
        torch.cuda.synchronize()
        took = ("sm90" if fa.bwd_sm90_launch_count > before[0] else
                "tf32x3" if fa.bwd_tf32x3_launch_count > before[1] else
                "sm90_d256" if fa.bwd_sm90_d256_launch_count > before[2]
                else "tf32x3_d256"
                if fa.bwd_tf32x3_d256_launch_count > before[3] else "none")
        if took != route:
            raise AssertionError(f"backward at {shape} took route {took}, "
                                 f"expected {route}")
        want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                               causal=causal)
        abs_err, rel_err = _bwd_errors(got, want, name, shape,
                                       f"{route} backward kernels")
        del got

        # At the dtype's peak: the CUDA-core pair's ceiling (fp32 FMAs) and
        # the sm90 kernels' (bf16 tensor cores).
        fma_bounds = _bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim,
                                 name, causal)
        # tf32x3 and tf32x3_d256 do fp32-accurate products on the tensor
        # cores, whose ceiling for them is 3xTF32's rate; their bound is
        # taken there.
        three_tf32 = route in ("tf32x3", "tf32x3_d256")
        bounds = (_bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim,
                              name, causal, TF32X3_FLOPS)
                  if three_tf32 else fma_bounds)
        delta = fa._delta(out, do).contiguous()
        dq_ms, dkv_ms, _ = _kernel_times(torch, fa, fa._SUFFIX[route], q, k,
                                         v, do, lse, delta, causal)
        kernels = {key: {"route": route, **_kernel_stats(ms, bounds[key])}
                   for key, ms in (("dq", dq_ms), ("dkv", dkv_ms))}
        if three_tf32:
            for key, row in kernels.items():
                row["fp32_fma_bound_ms"] = fma_bounds[key][0]
                row["share_of_fp32_fma_bound"] = (fma_bounds[key][0]
                                                  / row["ms"])
        simt = None
        attn = (batch, q_len, kv_len, heads, kv_heads, dim)
        gpt2 = attn == GPT2_ATTN
        if ((route == "sm90" and not results) or (route == "tf32x3" and gpt2)
                or (route == "sm90_d256" and attn == GEMMA7B_ATTN)
                or route == "tf32x3_d256"):
            # PR 2's CUDA-core pair on the same inputs, launched directly:
            # the wrapper routes no dtype and head_dim there any more.
            s_dq_ms, s_dkv_ms, s_got = _kernel_times(
                torch, fa, "", q, k, v, do, lse, delta, causal)
            s_abs, s_rel = _bwd_errors(s_got, want, name, shape,
                                       "CUDA-core backward kernels")
            simt = {"abs_err": s_abs, "rel_err": s_rel,
                    "dq": {"route": "simt", **_kernel_stats(s_dq_ms,
                                                            fma_bounds["dq"])},
                    "dkv": {"route": "simt", **_kernel_stats(
                        s_dkv_ms, fma_bounds["dkv"])}}
            del s_got
        del want, delta
        bwd_ms = _median_ms(torch, lambda: fa.flash_attention_backward(
            q, k, v, out, lse, do, causal=causal))
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_backward_ref(
            q, k, v, out, lse, do, causal=causal))

        # SDPA's backward as a yardstick: fwd+bwd through autograd minus
        # fwd, GQA without a head repeat, top-left causal as here.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        sdpa_fwd_ms = _median_ms(torch, sdpa)
        sdpa_both_ms = _median_ms(torch, sdpa_both)
        if (route == "tf32x3" and gpt2) or (route == "tf32x3_d256"
                                            and attn == _d256_attn()):
            # Which kernels SDPA runs for fp32 (their names say which
            # backend, and so whether the tensor cores do its products).
            _profile(torch, f"SDPA forward and backward at {shape}",
                     sdpa_both, top=8)
        row = {"shape": shape, "route": route, "abs_err": abs_err,
               "rel_err": rel_err, "tol": BWD_TOL[name], "kernels": kernels,
               "bwd_ms": bwd_ms,
               "bwd": _kernel_stats(bwd_ms, bounds["backward"]),
               "plain_ms": plain_ms,
               "library_ms": sdpa_both_ms - sdpa_fwd_ms,
               "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_both_ms,
               "bounds": bounds, "fma_bounds": fma_bounds}
        if simt is not None:
            row["simt"] = simt
        print("kernel flash_attention_bwd " + json.dumps(row), flush=True)
        if simt is not None:
            pair_ms = simt["dq"]["ms"] + simt["dkv"]["ms"]

            print(f"backward at {shape}: {route} dQ {dq_ms:.3f} ms "
                  f"({_shares(kernels['dq'])}), dK/dV {dkv_ms:.3f} ms "
                  f"({_shares(kernels['dkv'])}); "
                  f"pair {dq_ms + dkv_ms:.3f} ms, whole backward "
                  f"{bwd_ms:.3f} ms against the CUDA-core pair's "
                  f"{pair_ms:.3f} ms ({pair_ms / (dq_ms + dkv_ms):.2f}x "
                  f"faster) and SDPA's backward {row['library_ms']:.3f} ms "
                  f"({bwd_ms / row['library_ms']:.2f}x its time)",
                  flush=True)
        results.append(row)
        del q, k, v, do, out, lse, qt, kt, vt, dot
    return results


def model_check_phase(torch, llama):
    """Small fp32 model, head_dim 128: flash path against the plain
    reference attention on the card, and against the CPU."""
    cfg, params = _small_model(torch, llama)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)))
    with torch.inference_mode():
        flash = llama.forward(params, toks.cuda(), cfg, attn_impl="flash")
        ref = llama.forward(params, toks.cuda(), cfg, attn_impl="reference")
        cpu = llama.forward(_tree_map(lambda t: t.cpu(), params), toks,
                            cfg, attn_impl="flash")
    err_ref = (flash - ref).abs().max().item()
    err_cpu = (flash.cpu() - cpu).abs().max().item()
    print(f"model check (fp32, head_dim 128, S=256): flash vs reference "
          f"{err_ref:.3e}, card vs CPU {err_cpu:.3e} (tol 1e-3)", flush=True)
    if not (torch.isfinite(flash).all() and err_ref <= 1e-3
            and err_cpu <= 1e-3):
        raise AssertionError("model check failed")


def _small_model(torch, llama, dtype=None):
    """The small model of the correctness checks (head_dim 128), fp32
    unless ``dtype`` says otherwise."""
    cfg = dataclasses.replace(
        llama.CONFIGS["tiny"], dim=512, n_heads=4, n_kv_heads=2,
        mlp_dim=512, n_layers=2, max_seq=512,
        dtype=dtype or torch.float32)
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    return cfg, params


def _tree_map(fn, tree):
    """``fn`` of every tensor of a (nested) parameter dict."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _reset_counts(fa):
    fa.launch_count = fa.fwd_sm90_launch_count = fa.fwd_tf32x3_launch_count = 0
    fa.fwd_sm90_d256_launch_count = fa.fwd_tf32x3_d256_launch_count = 0
    fa.bwd_dq_launch_count = fa.bwd_dkv_launch_count = 0
    fa.bwd_sm90_launch_count = fa.bwd_tf32x3_launch_count = 0
    fa.bwd_sm90_d256_launch_count = fa.bwd_tf32x3_d256_launch_count = 0


def _counts(fa):
    """Launches since the last reset: the forward on any route, on the
    sm90, the tf32x3, the sm90_d256 and the tf32x3_d256 route, dQ and
    dK/dV on any route,
    and backward calls that took the sm90, the tf32x3, the sm90_d256 and
    the tf32x3_d256 pair."""
    return {"fwd": fa.launch_count, "fwd_sm90": fa.fwd_sm90_launch_count,
            "fwd_tf32x3": fa.fwd_tf32x3_launch_count,
            "fwd_sm90_d256": fa.fwd_sm90_d256_launch_count,
            "fwd_tf32x3_d256": fa.fwd_tf32x3_d256_launch_count,
            "dq": fa.bwd_dq_launch_count, "dkv": fa.bwd_dkv_launch_count,
            "sm90": fa.bwd_sm90_launch_count,
            "tf32x3": fa.bwd_tf32x3_launch_count,
            "sm90_d256": fa.bwd_sm90_d256_launch_count,
            "tf32x3_d256": fa.bwd_tf32x3_d256_launch_count}


def _by_kernel(counts):
    """Launches of each of the fifteen kernels from a _counts() dict."""
    tensor_cores = (counts["sm90"] + counts["tf32x3"] + counts["sm90_d256"]
                    + counts["tf32x3_d256"])
    return {"flash_attention_fwd_sm90": counts["fwd_sm90"],
            "flash_attention_fwd_tf32x3": counts["fwd_tf32x3"],
            "flash_attention_fwd_sm90_d256": counts["fwd_sm90_d256"],
            "flash_attention_fwd_tf32x3_d256": counts["fwd_tf32x3_d256"],
            "flash_attention_fwd": (counts["fwd"] - counts["fwd_sm90"]
                                    - counts["fwd_tf32x3"]
                                    - counts["fwd_sm90_d256"]
                                    - counts["fwd_tf32x3_d256"]),
            "flash_attention_bwd_dq_sm90": counts["sm90"],
            "flash_attention_bwd_dkv_sm90": counts["sm90"],
            "flash_attention_bwd_dq_tf32x3": counts["tf32x3"],
            "flash_attention_bwd_dkv_tf32x3": counts["tf32x3"],
            "flash_attention_bwd_dq_sm90_d256": counts["sm90_d256"],
            "flash_attention_bwd_dkv_sm90_d256": counts["sm90_d256"],
            "flash_attention_bwd_dq_tf32x3_d256": counts["tf32x3_d256"],
            "flash_attention_bwd_dkv_tf32x3_d256": counts["tf32x3_d256"],
            "flash_attention_bwd_dq": counts["dq"] - tensor_cores,
            "flash_attention_bwd_dkv": counts["dkv"] - tensor_cores}


# Forward-kernel launches per layer and training step under each remat
# policy: "full" and "dots" recompute the flash forward in the backward,
# "none" and "matmuls" keep its (out, lse).
FWD_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "matmuls": 1}


def grad_check_phase(torch, fa, llama):
    """Loss and every gradient leaf of the small fp32 model through the
    kernels, against reference attention on the card and against the
    CPU, under each remat policy.  Returns the launches and, per policy,
    the two gradient errors."""
    cfg, params = _small_model(torch, llama)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 257)))

    def loss_and_grads(params, toks, impl, remat):
        return _loss_and_grads(torch, llama, cfg, params, toks, impl, remat)

    cpu_params = _tree_map(lambda t: t.cpu(), params)
    total = dict.fromkeys(_counts(fa), 0)
    readings = {}
    for remat in FWD_PER_LAYER:
        _reset_counts(fa)
        loss, grads = loss_and_grads(params, toks.cuda(), "flash", remat)
        torch.cuda.synchronize()
        launches = _counts(fa)
        ref_loss, ref_grads = loss_and_grads(params, toks.cuda(),
                                             "reference", remat)
        cpu_loss, cpu_grads = loss_and_grads(cpu_params, toks, "flash",
                                             remat)
        err_ref = max((g - ref_grads[k]).abs().max().item()
                      / ref_grads[k].abs().max().item()
                      for k, g in grads.items())
        err_cpu = max((g.cpu() - cpu_grads[k]).abs().max().item()
                      / cpu_grads[k].abs().max().item()
                      for k, g in grads.items())
        fwd = cfg.n_layers * FWD_PER_LAYER[remat]
        want = {"fwd": fwd, "fwd_sm90": 0, "fwd_tf32x3": fwd,
                "fwd_sm90_d256": 0, "dq": cfg.n_layers, "dkv": cfg.n_layers,
                "sm90": 0, "tf32x3": cfg.n_layers, "sm90_d256": 0,
                "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}
        total = {key: total[key] + launches[key] for key in total}
        readings[remat] = {"vs_reference": err_ref, "vs_cpu": err_cpu}
        print(f"gradient check (fp32, head_dim 128, S=256, remat {remat}): "
              f"loss {loss:.6f}, reference {ref_loss:.6f}, CPU "
              f"{cpu_loss:.6f}; max grad error over max |ref| per leaf: vs "
              f"reference {err_ref:.3e}, vs CPU {err_cpu:.3e} (tol "
              f"{GRAD_TOL}); launches {launches} (expected {want})",
              flush=True)
        if not (abs(loss - ref_loss) <= 1e-5 and abs(loss - cpu_loss) <= 1e-5
                and err_ref <= GRAD_TOL and err_cpu <= GRAD_TOL
                and launches == want):
            raise AssertionError(f"gradient check failed under remat {remat}")
    return total, readings


def _loss_and_grads(torch, model, cfg, params, toks, impl, remat=None):
    """Loss and the gradient of every leaf (by name) of a fresh copy of
    ``params``, through ``model.loss_fn`` (llama's under ``remat``, or
    gpt2's, which checkpoints every block)."""
    leaves = {k: (v.detach().clone().requires_grad_() if k != "layers"
                  else {n: w.detach().clone().requires_grad_()
                        for n, w in v.items()})
              for k, v in params.items()}
    flat = {**{k: v for k, v in leaves.items() if k != "layers"},
            **{f"layers.{n}": w for n, w in leaves["layers"].items()}}
    kw = {} if remat is None else {"remat": remat}
    loss = model.loss_fn(leaves, {"tokens": toks}, cfg, attn_impl=impl, **kw)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def _rel_err(got, want):
    """Max abs error of ``got`` over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bf16_grad_check_phase(torch, fa, llama):
    """Loss and every gradient leaf of the small model in bf16 through
    the sm90 backward kernels, against reference attention on the card
    in bf16; the spread of bf16 reference attention around the same
    model in fp32 is printed beside it."""
    cfg, params = _small_model(torch, llama, torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if k != "layers" else
                    {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 257))).cuda()
    _reset_counts(fa)
    loss, grads = _loss_and_grads(torch, llama, cfg, params, toks, "flash",
                                  "none")
    torch.cuda.synchronize()
    launches = _counts(fa)
    ref_loss, ref_grads = _loss_and_grads(torch, llama, cfg, params, toks,
                                          "reference", "none")
    _, fp32_grads = _loss_and_grads(torch, llama, cfg32, params32, toks,
                                    "reference", "none")

    err = {k: _rel_err(g, ref_grads[k]) for k, g in grads.items()}
    spread = {k: _rel_err(g, fp32_grads[k]) for k, g in ref_grads.items()}
    worst = max(err, key=err.get)
    want = {"fwd": cfg.n_layers, "fwd_sm90": cfg.n_layers, "fwd_tf32x3": 0,
            "fwd_sm90_d256": 0, "dq": cfg.n_layers, "dkv": cfg.n_layers,
            "sm90": cfg.n_layers, "tf32x3": 0, "sm90_d256": 0,
            "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}
    print(f"gradient check (bf16, head_dim 128, S=256, remat none, sm90 "
          f"backward): loss {loss:.6f}, reference {ref_loss:.6f}; max grad "
          f"error over max |ref| per leaf vs bf16 reference "
          f"{err[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL}), bf16 reference "
          f"vs fp32 reference up to {max(spread.values()):.3e}; launches "
          f"{launches} (expected {want})", flush=True)
    print("bf16 gradient errors per leaf " + json.dumps(
        {k: [err[k], spread[k]] for k in err}), flush=True)
    if not (abs(loss - ref_loss) <= BF16_LOSS_TOL
            and err[worst] <= BF16_GRAD_TOL and launches == want):
        raise AssertionError("bf16 gradient check failed")
    return launches


def _train_steps(torch, fa, step, per_step, n_steps=13):
    """``n_steps`` calls of ``step`` (a train_step closure), host-timed
    to the loss's ``item()``, with the launch counts reset just before
    and every step's launches held to ``per_step``.  Returns the losses,
    the step times (ms), the launches of the whole run and the peak
    memory (GB)."""
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    losses, step_ms = [], []
    for i in range(n_steps):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step().item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = _counts(fa)
        delta = {key: after[key] - before[key] for key in after}
        if delta != per_step:
            raise AssertionError(f"step {i} launched {delta}, expected "
                                 f"{per_step}")
    launches = _counts(fa)
    return losses, step_ms, launches, torch.cuda.max_memory_allocated() / 1e9


def _llama_400m(torch, llama):
    """llama-400m at its published widths and depth, bf16, weights from
    seed 0, and one fixed batch of 8 x 2049 token ids."""
    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2049))).cuda()
    return cfg, params, tokens


def train_phase(torch, fa, llama, keep=None):
    """The training slice: llama-400m, batch 8 x 2048, AdamW, remat
    "none"; returns the kernels' launches over its 13 steps.  ``keep``
    (a dict) receives its config, trained weights and batch under
    "llama-400m", for the parallel phase."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    remat = "none"
    t0 = time.perf_counter()
    cfg, params, tokens = _llama_400m(torch, llama)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    optimizer = make_optimizer(params)
    torch.cuda.synchronize()
    print(f"llama-400m up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e6:.1f} M params, {cfg.dtype}, "
          f"{cfg.n_layers} layers)", flush=True)

    def step():
        return train_step(params, optimizer, tokens, cfg, remat=remat)

    per_step = {"fwd": cfg.n_layers, "fwd_sm90": cfg.n_layers,
                "fwd_tf32x3": 0, "fwd_sm90_d256": 0, "dq": cfg.n_layers,
                "dkv": cfg.n_layers, "sm90": cfg.n_layers, "tf32x3": 0,
                "sm90_d256": 0, "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}
    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
        "bfloat16"]
    print(f"train llama-400m batch {batch} x seq {seq} remat {remat}: "
          f"losses {[round(x, 4) for x in losses]}; step "
          f"{ms:.2f} ms (median of 10 after 3 warm-up; all "
          f"{[round(x, 1) for x in step_ms]}), {tokens_per_s:.0f} tokens/s, "
          f"MFU {mfu:.4f}, peak memory {peak_gb:.2f} GB; launches over 13 "
          f"steps {launches}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")
    _profile(torch, f"train step llama-400m {batch} x {seq}", step, top=16)
    if keep is not None:
        keep["llama-400m"] = (cfg, params, tokens)
    return launches


# Steps per remat policy (3 of them warm-up): 13 until the jobs phase
# came, 8 until the collective and trainer phases came, 6 until the
# parallel phase came, whose time this pays for in part.
REMAT_STEPS = 5


def remat_phase(torch, fa, llama):
    """llama-400m's training slice under each remat policy, each from the
    same weights: 3 warm-up and REMAT_STEPS - 3 timed steps, a profile,
    and the step on 1 x 128 tokens, where the host sets the time.  Gates:
    the forward kernel launched FWD_PER_LAYER[remat] times per layer and
    step, the backward pair once; the losses of the first two steps (the
    second after one update, so it carries the first step's gradients)
    equal across the policies within BF16_LOSS_TOL.  Returns the launches per
    policy, keyed "remat_<policy>"."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    paths, first = {}, {}
    # One init; each policy trains a copy (the seed-0 weights, bitwise).
    cfg, initial, tokens = _llama_400m(torch, llama)
    for remat, fwd in FWD_PER_LAYER.items():
        torch.cuda.empty_cache()
        params = _tree_map(torch.clone, initial)
        batch, seq = tokens.shape[0], tokens.shape[1] - 1
        optimizer = make_optimizer(params)

        def step():
            return train_step(params, optimizer, tokens, cfg, remat=remat)

        n = cfg.n_layers
        per_step = {"fwd": fwd * n, "fwd_sm90": fwd * n, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": n, "dkv": n, "sm90": n,
                    "tf32x3": 0, "sm90_d256": 0,
                    "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}
        losses, step_ms, launches, peak_gb = _train_steps(
            torch, fa, step, per_step, n_steps=REMAT_STEPS)
        ms = statistics.median(step_ms[3:])
        tokens_per_s = batch * seq / (ms / 1e3)
        mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
            "bfloat16"]
        print(f"remat {remat} llama-400m batch {batch} x seq {seq}: step "
              f"{ms:.2f} ms (median of {REMAT_STEPS - 3} after 3 warm-up; all "
              f"{[round(x, 1) for x in step_ms]}), {tokens_per_s:.0f} "
              f"tokens/s, MFU {mfu:.4f} (bf16 peak), peak memory "
              f"{peak_gb:.2f} GB; launches per step {per_step}; losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"remat {remat}: losses {losses} not "
                                 "finite or not falling")
        first[remat] = losses[:2]
        paths[f"remat_{remat}"] = launches
        if remat != "none":      # "none" is profiled by train_phase
            _profile(torch, f"train step llama-400m {batch} x {seq} remat "
                     f"{remat}", step, top=16)
        # The host's share: the same step on 1 x 128 tokens, where the
        # card's work is a few ms and the wall time is the host's dispatch
        # of every op (and, under "dots" and "matmuls", the selective-
        # checkpoint dispatch mode's handling of each).
        small = tokens[:1, :129]
        host_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(params, optimizer, small, cfg, remat=remat).item()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"remat {remat} llama-400m batch 1 x seq 128 (host-bound): "
              f"step {statistics.median(host_ms[2:]):.2f} ms (median of 5 "
              f"after 2 warm-up; all {[round(x, 1) for x in host_ms]})",
              flush=True)
        del params, optimizer
    del initial, tokens
    spread = [max(v[i] for v in first.values())
              - min(v[i] for v in first.values()) for i in range(2)]
    print(f"remat gates: losses of steps 1 and 2 per policy "
          f"{json.dumps(first)}; spread {spread} (tol {BF16_LOSS_TOL})",
          flush=True)
    if max(spread) > BF16_LOSS_TOL:
        raise AssertionError(f"remat policies disagree on the loss: {first}")
    return paths


# GPT-2's first loss on the card against the plain fp32 loss (reference
# attention) on the same weights.  Both losses are fp32 (log-softmax of
# fp32 logits); what differs is the forward in front of them.  At random
# init the final LayerNorm holds the loss near ln V whatever the hidden
# state, so attention faults move it little.  Readings at this phase's
# shapes (tools/gpt2_loss_faults.py, H100 80GB HBM3 at 700 W): sound runs
# 0 (fp32) and 1.05e-4 (bf16); planted faults, bf16 (fp32 alike):
# log-softmax in bf16 3.6e-4, softmax scale doubled 6.6e-4, no causal
# mask 2.1e-3, no attention 4.5e-3, K/V of the next head 1.6e-2, scale
# halved 7e-5 (bf16) and 2.7e-4 (fp32).  Each limit sits between the
# sound reading and the smallest fault above it (bf16: about their
# geometric mean); the halved scale in bf16 is left to the logit gate.
GPT2_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-4}
# Last-position logits of a 1024-token forward through the kernels
# against reference attention in the same dtype (max abs; the largest
# logits of the random model are ~2-4).  fp32: summation order and
# 3xTF32's ~22 bits per product.  bf16: both paths round every matmul and
# the residual stream to bf16 but at other points inside attention, so
# errors of a few ulps (0.016 at 2-4) pass through twelve layers.
# Readings on the initial weights (tools/gpt2_loss_faults.py): sound
# 4.4e-6 (fp32, the CUDA-core forward) and 0.033 (bf16); the faults
# above 0.17 (scale halved) to 3.2 in either dtype.  On the trained
# weights (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): fp32
# 2.0e-5 through the 3xTF32 forward, 2.3e-4 with one TF32 product; the
# fp32 limit sits between them.
GPT2_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
# GPT-2's fp32 gradients on the initial weights through the kernels
# against reference attention, per leaf, max abs error over max |ref|.
# Readings (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): 3.8e-5
# through the 3xTF32 kernels, 3.2e-4 with one TF32 product in both
# directions (2.9e-4 with it in the backward alone); the limit sits
# between them.  The first loss reads 0 and 9.5e-7 (one ulp at ~11), so
# GPT2_LOSS_TOL cannot tell them apart.
GPT2_GRAD_TOL = 1e-4
PEAK_NAME = {"float32": "fp32 outside the tensor cores (TF32 off)",
             "bfloat16": "bf16 dense"}


def gpt2_phase(torch, fa, dtype_name):
    """GPT-2 (124 M) at its published widths and depth in ``dtype_name``
    (its published fp32, or a bf16 copy), weights from seed 0, a fixed
    batch of 8 x 1025 token ids (T = 1024 = n_positions), AdamW: 3
    warm-up and 10 timed train_step calls.  Gates: every block
    checkpointed, so per step the forward kernel runs twice per layer and
    the backward pair once, on the routes of the dtype (tf32x3 in fp32,
    sm90 in bf16); in fp32, before training, every gradient leaf of the
    loss through the kernels within GPT2_GRAD_TOL of reference
    attention's (the only gate here that sees the backward); the first
    step's loss within GPT2_LOSS_TOL
    of gpt2.loss_fn in fp32 with reference attention on the same
    weights; the loss falling; then, on the trained weights, the
    last-position logits of each of the 8 rows of a 1024-token forward
    through the kernels within GPT2_LOGIT_TOL of the plain path's
    (reference attention, same dtype), and its greedy next tokens equal
    to the plain path's but for ties.  Returns the launches of the
    training steps and the gates' readings."""
    from ant_ray_tpu_torch.models import gpt2  # noqa: PLC0415
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    dtype = getattr(torch, dtype_name)
    cfg = dataclasses.replace(gpt2.CONFIGS["gpt2"], dtype=dtype)
    params = gpt2.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, cfg.n_positions + 1))).cuda()
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        params32 = {k: (v.float() if k != "layers" else
                        {n: w.float() for n, w in v.items()})
                    for k, v in params.items()}
        plain_loss = gpt2.loss_fn(params32, {"tokens": tokens}, cfg32,
                                  attn_impl="reference").item()
        del params32
    grad_err = None
    if dtype_name == "float32":
        _, grads = _loss_and_grads(torch, gpt2, cfg, params, tokens, "flash")
        _, ref_grads = _loss_and_grads(torch, gpt2, cfg, params, tokens,
                                       "reference")
        errs = {key: ((g - ref_grads[key]).abs().max()
                      / ref_grads[key].abs().max()).item()
                for key, g in grads.items()}
        worst = max(errs, key=errs.get)
        grad_err = errs[worst]
        del grads, ref_grads
        print(f"gpt2 {dtype_name} gradients on the initial weights through "
              f"the kernels against reference attention: max error over "
              f"max |ref| {grad_err:.3e} ({worst}; tol {GPT2_GRAD_TOL})",
              flush=True)
        if not grad_err <= GPT2_GRAD_TOL:
            raise AssertionError(f"gpt2 {dtype_name}: gradient error "
                                 f"{grad_err} at {worst}")
    optimizer = make_optimizer(params)

    def step():
        return train_step(params, optimizer, tokens, cfg)

    n = cfg.n_layers
    fwd, bwd = (fa._route(dtype, cfg.head_dim, d) for d in ("fwd", "bwd"))
    per_step = {"fwd": 2 * n, "fwd_sm90": 2 * n * (fwd == "sm90"),
                "fwd_tf32x3": 2 * n * (fwd == "tf32x3"),
                "fwd_sm90_d256": 2 * n * (fwd == "sm90_d256"), "dq": n,
                "dkv": n, "sm90": n * (bwd == "sm90"),
                "tf32x3": n * (bwd == "tf32x3"),
                "sm90_d256": n * (bwd == "sm90_d256"),
                "tf32x3_d256": n * (bwd == "tf32x3_d256"),
                "fwd_tf32x3_d256": 2 * n * (fwd == "tf32x3_d256")}
    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * gpt2.flops_per_token(cfg, seq) / PEAK_FLOPS[
        dtype_name]
    loss_err = abs(losses[0] - plain_loss)
    print(f"gpt2 {dtype_name} batch {batch} x seq {seq} "
          f"({cfg.num_params() / 1e6:.1f} M params, {n} layers, "
          f"{cfg.n_heads} heads of {cfg.head_dim}): step {ms:.2f} ms (median "
          f"of 10 after 3 warm-up; all {[round(x, 1) for x in step_ms]}), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} against "
          f"{PEAK_FLOPS[dtype_name] / 1e12:.0f} TFLOP/s "
          f"({PEAK_NAME[dtype_name]}), peak memory {peak_gb:.2f} GB; "
          f"launches per step {per_step}; losses "
          f"{[round(x, 4) for x in losses]}; first loss against plain fp32 "
          f"{plain_loss:.6f}: error {loss_err:.3e} (tol "
          f"{GPT2_LOSS_TOL[dtype_name]})", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and loss_err <= GPT2_LOSS_TOL[dtype_name]):
        raise AssertionError(f"gpt2 {dtype_name}: losses {losses}, plain "
                             f"{plain_loss}")
    _profile(torch, f"train step gpt2 {dtype_name} {batch} x {seq}", step,
             top=16)

    prompts = tokens[:, :seq]
    with torch.inference_mode():
        flash = gpt2.forward(params, prompts, cfg)[:, -1].float()
        plain = gpt2.forward(params, prompts, cfg,
                             attn_impl="reference")[:, -1].float()
    got, want = flash.argmax(-1), plain.argmax(-1)
    logit_err = (flash - plain).abs().max().item()
    # With every logit within GPT2_LOGIT_TOL of the plain path's, the
    # card can pick another token only where the plain path's logits of
    # the two lie within twice that: a tie at this precision.
    gap = plain.gather(-1, want[:, None]) - plain.gather(-1, got[:, None])
    tie = gap[:, 0] <= 2 * GPT2_LOGIT_TOL[dtype_name]
    differ = got != want
    print(f"gpt2 {dtype_name} greedy next tokens after {seq}: card "
          f"{got.tolist()}, plain {want.tolist()}; differ at "
          f"{differ.nonzero().flatten().tolist()} (plain logit gaps there "
          f"{gap[differ, 0].tolist()}); max logit difference "
          f"{logit_err:.3e} (tol {GPT2_LOGIT_TOL[dtype_name]})", flush=True)
    if logit_err > GPT2_LOGIT_TOL[dtype_name] or (differ & ~tie).any():
        raise AssertionError(f"gpt2 {dtype_name}: greedy tokens differ "
                             "beyond a tie")
    del params, optimizer, tokens
    return launches, {"loss_err": loss_err, "logit_err": logit_err,
                      "grad_err": grad_err}


# The fp32 seed-0 weights of _d256_config, kept on the card from the
# bf16 phase, which takes a bf16 copy of them, to the fp32 phase, which
# takes them: one init of 2.5 B parameters for both paths (init_params
# draws in fp32 and rounds into the leaf's dtype, so the copy is bitwise
# the weights it makes in bf16).
_D256_FP32_WEIGHTS = {}


def _llama_d256(torch, llama, dtype=None, keep_fp32=False):
    """_d256_config's Llama (in ``dtype`` if given), weights from seed 0,
    and one fixed batch of D256_TOKENS token ids.  ``keep_fp32`` keeps
    the fp32 weights for the next call (_D256_FP32_WEIGHTS)."""
    cfg = _d256_config()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    fp32 = _D256_FP32_WEIGHTS.pop("params", None)
    if fp32 is None:
        fp32 = llama.init_params(
            dataclasses.replace(cfg, dtype=torch.float32),
            generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    if cfg.dtype == torch.float32:
        params = fp32
    else:
        params = _tree_map(lambda t: t.to(cfg.dtype), fp32)
        if keep_fp32:
            _D256_FP32_WEIGHTS["params"] = fp32
        del fp32
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, D256_TOKENS)).cuda()
    return cfg, params, tokens


def _d256_grad_check(torch, fa, llama, cfg, params, tokens, remat="none"):
    """One step's loss and every gradient leaf of the head_dim-256 Llama
    through the kernels (under ``remat``) against reference attention on
    the card.  Returns the loss, the reference's, the per-leaf max abs
    error over max |ref| and the launches of the kernels' step."""
    ref_loss, ref_grads = _loss_and_grads(torch, llama, cfg, params, tokens,
                                          "reference", remat)
    _reset_counts(fa)
    loss, grads = _loss_and_grads(torch, llama, cfg, params, tokens, "flash",
                                  remat)
    torch.cuda.synchronize()
    launches = _counts(fa)
    err = {k: _rel_err(g, ref_grads[k]) for k, g in grads.items()}
    return loss, ref_loss, err, launches


def d256_phase(torch, fa, llama):
    """The head_dim-256 training path: _llama_d256 (2.51 B parameters),
    AdamW, remat "none".  First one step's loss and every gradient leaf
    through the kernels against reference attention on the card
    (D256_GRAD_TOL, BF16_LOSS_TOL); then 3 warm-up and 10 timed
    train_step calls.  Gates: per step the sm90_d256 forward and the
    sm90_d256 backward pair once per layer, no other flash kernel; the
    first step's loss within BF16_LOSS_TOL of reference attention's; the
    loss finite and falling.  Prints step time, tokens/s, MFU against
    the bf16 peak, peak memory and a profile of one step with the
    attention kernels' share.  Returns the launches of the 13 steps."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params, tokens = _llama_d256(torch, llama, keep_fp32=True)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    attn = (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if attn != _d256_attn():
        raise AssertionError(f"d256 attention {attn}, kernel phases checked "
                             f"{_d256_attn()}")
    print(f"d256 llama up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e9:.3f} B params, {cfg.dtype}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{cfg.n_kv_heads} KV head)", flush=True)

    n = cfg.n_layers
    fwd, bwd = (fa._route(cfg.dtype, cfg.head_dim, d) for d in ("fwd", "bwd"))
    if (fwd, bwd) != ("sm90_d256", "sm90_d256"):
        raise AssertionError(f"head_dim 256 in bf16 routes to {fwd} and "
                             f"{bwd}")
    per_step = {"fwd": n, "fwd_sm90": 0, "fwd_tf32x3": 0, "fwd_sm90_d256": n,
                "dq": n, "dkv": n, "sm90": 0, "tf32x3": 0, "sm90_d256": n,
                "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}
    loss, ref_loss, err, grad_launches = _d256_grad_check(
        torch, fa, llama, cfg, params, tokens)
    worst = max(err, key=err.get)
    print(f"d256 gradient check (bf16, {batch} x {seq}, remat none): loss "
          f"{loss:.6f}, reference attention {ref_loss:.6f}; max grad error "
          f"over max |ref| per leaf {err[worst]:.3e} ({worst}; tol "
          f"{D256_GRAD_TOL}); launches {grad_launches}", flush=True)
    print("d256 gradient errors per leaf " + json.dumps(err), flush=True)
    if not (abs(loss - ref_loss) <= BF16_LOSS_TOL
            and err[worst] <= D256_GRAD_TOL and grad_launches == per_step):
        raise AssertionError("d256 gradient check failed")
    torch.cuda.empty_cache()

    optimizer = make_optimizer(params)

    def step():
        return train_step(params, optimizer, tokens, cfg, remat="none")

    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
        "bfloat16"]
    loss_err = abs(losses[0] - ref_loss)
    print(f"train d256 llama batch {batch} x seq {seq} remat none: losses "
          f"{[round(x, 4) for x in losses]}; first loss against reference "
          f"attention {ref_loss:.6f}: error {loss_err:.3e} (tol "
          f"{BF16_LOSS_TOL}); step {ms:.2f} ms (median of 10 after 3 "
          f"warm-up; all {[round(x, 1) for x in step_ms]}), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}, peak memory "
          f"{peak_gb:.2f} GB; launches per step {per_step}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and loss_err <= BF16_LOSS_TOL):
        raise AssertionError(f"d256 training: losses {losses}, reference "
                             f"first loss {ref_loss}")
    by_name = _profile(torch, f"train step d256 llama {batch} x {seq}", step,
                       top=16)
    if by_name is not None:
        busy = sum(by_name.values())
        attn = {name: us for name, us in by_name.items()
                if re.search(r"flash_(fwd|bwd)", name)}
        print(f"d256 attention kernels: {sum(attn.values()) / 1e3:.2f} ms of "
              f"{busy / 1e3:.2f} ms busy ({sum(attn.values()) / busy:.1%}); "
              + json.dumps({name: round(us / 1e3, 3)
                            for name, us in attn.items()}), flush=True)
    del params, optimizer, tokens
    return launches


def d256_fp32_phase(torch, fa, llama):
    """The fp32 head_dim-256 training path: _llama_d256 in fp32 (2.51 B
    parameters), AdamW, remat D256_FP32_REMAT.  First one step's loss and
    every gradient leaf through the kernels against reference attention
    on the card (D256_FP32_GRAD_TOL, D256_FP32_LOSS_TOL); then
    D256_FP32_STEPS warm-up and timed train_step calls.  Gates: per step
    the tf32x3_d256 backward pair once per layer and the tf32x3_d256
    forward once per layer and recompute, no other flash kernel; the
    loss finite and falling.  Prints step time, tokens/s, MFU against
    fp32's 67 TFLOP/s (TF32 off, so the model's GEMMs run in fp32), peak
    memory and a profile of one step with the attention kernels' card
    time, the forward's and the backward pair's apart.  Returns the
    launches of the training steps."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    remat = D256_FP32_REMAT
    t0 = time.perf_counter()
    cfg, params, tokens = _llama_d256(torch, llama, torch.float32)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    print(f"d256 fp32 llama up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e9:.3f} B params, {cfg.dtype}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{cfg.n_kv_heads} KV head, remat {remat})", flush=True)

    n = cfg.n_layers
    fwd, bwd = (fa._route(cfg.dtype, cfg.head_dim, d) for d in ("fwd", "bwd"))
    if (fwd, bwd) != ("tf32x3_d256", "tf32x3_d256"):
        raise AssertionError(f"head_dim 256 in fp32 routes to {fwd} and "
                             f"{bwd}")
    per_step = {"fwd": FWD_PER_LAYER[remat] * n, "fwd_sm90": 0,
                "fwd_tf32x3": 0, "fwd_sm90_d256": 0, "dq": n, "dkv": n,
                "sm90": 0, "tf32x3": 0, "sm90_d256": 0, "tf32x3_d256": n,
                "fwd_tf32x3_d256": FWD_PER_LAYER[remat] * n}
    loss, ref_loss, err, grad_launches = _d256_grad_check(
        torch, fa, llama, cfg, params, tokens, remat)
    worst = max(err, key=err.get)
    loss_err = abs(loss - ref_loss)
    print(f"d256 fp32 gradient check ({batch} x {seq}, remat {remat}): loss "
          f"{loss:.6f}, reference attention {ref_loss:.6f}: error "
          f"{loss_err:.3e} (tol {D256_FP32_LOSS_TOL}); max grad error over "
          f"max |ref| per leaf {err[worst]:.3e} ({worst}; tol "
          f"{D256_FP32_GRAD_TOL}); launches {grad_launches}", flush=True)
    print("d256 fp32 gradient errors per leaf " + json.dumps(err),
          flush=True)
    if not (loss_err <= D256_FP32_LOSS_TOL
            and err[worst] <= D256_FP32_GRAD_TOL
            and grad_launches == per_step):
        raise AssertionError("d256 fp32 gradient check failed")
    torch.cuda.empty_cache()

    optimizer = make_optimizer(params)

    def step():
        return train_step(params, optimizer, tokens, cfg, remat=remat)

    warm, timed = D256_FP32_STEPS
    losses, step_ms, launches, peak_gb = _train_steps(
        torch, fa, step, per_step, n_steps=warm + timed)
    ms = statistics.median(step_ms[warm:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
        "float32"]
    print(f"train d256 fp32 llama batch {batch} x seq {seq} remat {remat}: "
          f"losses {[round(x, 4) for x in losses]}; step {ms:.2f} ms "
          f"(median of {timed} after {warm} warm-up; all "
          f"{[round(x, 1) for x in step_ms]}), {tokens_per_s:.0f} tokens/s, "
          f"MFU {mfu:.4f} against {PEAK_FLOPS['float32'] / 1e12:.0f} "
          f"TFLOP/s ({PEAK_NAME['float32']}), peak memory {peak_gb:.2f} GB; "
          f"launches per step {per_step}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"d256 fp32 training: losses {losses}")
    by_name = _profile(torch, f"train step d256 fp32 llama {batch} x {seq}",
                       step, top=16)
    if by_name is not None:
        busy = sum(by_name.values())
        attn = {name: us for name, us in by_name.items()
                if re.search(r"flash_(fwd|bwd)", name)}
        fwd_us = sum(us for name, us in attn.items()
                     if re.search(r"flash_fwd_tf32x3_d256", name))
        bwd_us = sum(us for name, us in attn.items()
                     if re.search(r"flash_bwd_d(q|kv)_tf32x3_d256", name))
        print(f"d256 fp32 attention kernels: {sum(attn.values()) / 1e3:.2f} "
              f"ms of {busy / 1e3:.2f} ms busy "
              f"({sum(attn.values()) / busy:.1%}), the forward "
              f"{fwd_us / 1e3:.2f} ms, the backward pair "
              f"{bwd_us / 1e3:.2f} ms; "
              + json.dumps({name: round(us / 1e3, 3)
                            for name, us in attn.items()}), flush=True)
    del params, optimizer, tokens
    return launches


# The tune phase: an ASHA learning-rate sweep of llama-400m trials (its
# published widths and depth, bf16, one seed-0 batch of 1 x 2049 token
# ids, AdamW, remat "none") on a GPU node that the port's autoscaler
# launches for them and removes after.  The head takes no trial (it has
# no GPU); the node type's four CPUs place the four trial actors (1 CPU
# each), which share the card a quarter each.
TUNE_LRS = (1e-6, 3e-4, 1e-3, 1.0)
TUNE_ASHA = {"max_t": 8, "grace_period": 2, "reduction_factor": 2}
TUNE_NODE = ("h100", {"CPU": 4.0, "GPU": 1.0})
TUNE_GPU_PER_TRIAL = 0.25
TUNE_BATCH = (1, 2049)
TUNE_IDLE_TIMEOUT_S = 3.0       # the autoscaler's idle_timeout_s
TUNE_INTERVAL_S = 0.5           # between its reconcile rounds
# The node must be gone this long after fit() returns: the idle timeout
# and a few rounds (the trials' workers exiting, the daemon's next view).
TUNE_SCALE_DOWN_S = TUNE_IDLE_TIMEOUT_S + 10 * TUNE_INTERVAL_S
TUNE_FIT_TIMEOUT_S = 300.0


def tune_trial(config):
    """One trial of the tune phase, in a worker of the autoscaled node:
    llama-400m from seed 0 on the card (it raises without one), AdamW at
    ``config["lr"]``, ``max_t`` steps on the seed-0 batch, each step's
    loss reported with this process's flash launch counters, its node
    and pid, and with the first report where the time to it went."""
    t0 = time.perf_counter()
    started = time.time()
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415
    from ant_ray_tpu_torch.tune import report  # noqa: PLC0415

    t_import = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("tune trial: no CUDA device in its worker")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter()
    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    optimizer = make_optimizer(params, lr=config["lr"])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TUNE_BATCH)).cuda()
    torch.cuda.synchronize()
    t_params = time.perf_counter()
    _reset_counts(fa)
    for step in range(TUNE_ASHA["max_t"]):
        loss = train_step(params, optimizer, tokens, cfg,
                          remat="none").item()
        result = {"loss": loss, "launches": _counts(fa),
                  "node_id": os.environ.get("ART_NODE_ID", ""),
                  "pid": os.getpid(),
                  "device": str(params["embed"].device)}
        if step == 0:
            result["start"] = {
                "started_at": started, "import_s": t_import - t0,
                "cuda_init_s": t_cuda - t_import,
                "param_init_s": t_params - t_cuda,
                "first_step_s": time.perf_counter() - t_params}
        report(result)


def _recording_asha(tune):
    """``tune``'s ASHA with TUNE_ASHA's rungs, recording each result the
    controller hands it (trial, iteration, loss) and its decision, in
    the controller's order."""

    class RecordingAsha(tune.AsyncHyperBandScheduler):
        def __init__(self):
            super().__init__(metric="loss", mode="min", **TUNE_ASHA)
            self.log = []

        def on_trial_result(self, trial_id, result):
            decision = super().on_trial_result(trial_id, result)
            self.log.append((trial_id, result["training_iteration"],
                             result["loss"], decision))
            return decision

    return RecordingAsha()


def _tune_reference_loss(torch, llama):
    """The driver's loss_fn on the trials' seed-0 weights and batch, as
    train_step computes it before its first update."""
    from ant_ray_tpu_torch.train.step import param_leaves  # noqa: PLC0415

    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    for leaf in param_leaves(params):
        leaf.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TUNE_BATCH)).cuda()
    loss = llama.loss_fn(params, {"tokens": tokens}, cfg,
                         remat="none").item()
    del params, tokens
    torch.cuda.empty_cache()
    return loss


def _tune_gates(grid, log, ref_loss, node_id, n_layers):
    """The sweep's gates: no trial error, every trial on the autoscaled
    node, the first losses bitwise equal and within BF16_LOSS_TOL of the
    driver's, ASHA's grace period kept and at least one trial stopped
    early, the decisions replayed by a fresh scheduler, the best result
    the lowest last loss at max_t, and n_layers sm90 forwards and
    backward pairs per step in every trial.  Returns the launches of all
    trials as a _counts() dict and the line's per-trial records."""
    from ant_ray_tpu_torch import tune  # noqa: PLC0415

    errors = [repr(r.error) for r in grid if r.error is not None]
    if errors or len(grid) != len(TUNE_LRS):
        raise AssertionError(f"tune: {len(grid)} trials, errors {errors}")
    trials, total = [], {}
    for r in grid:
        steps = len(r.history)
        first, last = r.history[0], r.history[-1]
        nodes = {h["node_id"] for h in r.history}
        devices = {h["device"] for h in r.history}
        per_step = {"fwd": n_layers, "fwd_sm90": n_layers, "dq": n_layers,
                    "dkv": n_layers, "sm90": n_layers}
        want = {k: per_step.get(k, 0) * steps for k in last["launches"]}
        if last["launches"] != want:
            raise AssertionError(f"tune: lr {r.config['lr']} launched "
                                 f"{last['launches']} in {steps} steps, "
                                 f"expected {want}")
        if nodes != {node_id} or devices != {"cuda:0"}:
            raise AssertionError(f"tune: lr {r.config['lr']} ran on "
                                 f"{nodes} {devices}, not {node_id}")
        for key, n in last["launches"].items():
            total[key] = total.get(key, 0) + n
        trials.append({"lr": r.config["lr"], "steps": steps,
                       "first_loss": first["loss"],
                       "last_loss": last["loss"], "pid": first["pid"],
                       "start": {k: round(v, 3) for k, v in
                                 first["start"].items()
                                 if k != "started_at"},
                       "started_at": first["start"]["started_at"]})
    firsts = {t["first_loss"] for t in trials}
    if len(firsts) != 1:
        raise AssertionError(f"tune: first losses differ: {firsts}")
    first = firsts.pop()
    if not (first == ref_loss or abs(first - ref_loss) <= BF16_LOSS_TOL):
        raise AssertionError(f"tune: first loss {first} against the "
                             f"driver's {ref_loss}")
    max_t = TUNE_ASHA["max_t"]
    steps = [t["steps"] for t in trials]
    if min(steps) < TUNE_ASHA["grace_period"] or max(steps) != max_t \
            or min(steps) >= max_t:
        raise AssertionError(f"tune: steps per trial {steps}: grace "
                             f"{TUNE_ASHA['grace_period']}, max_t {max_t}, "
                             "at least one stopped early")
    replay = tune.AsyncHyperBandScheduler(metric="loss", mode="min",
                                          **TUNE_ASHA)
    replayed = [replay.on_trial_result(tid, {"training_iteration": it,
                                             "loss": loss})
                for tid, it, loss, _ in log]
    if replayed != [d for *_, d in log]:
        raise AssertionError("tune: a fresh ASHA decides otherwise on the "
                             f"recorded results: {log} -> {replayed}")
    stopped_at = {}
    for tid, it, _loss, decision in log:
        if decision == "STOP":
            stopped_at[tid] = it
    if sorted(stopped_at.values()) != sorted(steps):
        raise AssertionError(f"tune: stops {stopped_at} against the "
                             f"histories' lengths {steps}")
    finished = [t for t in trials if t["steps"] == max_t
                and np.isfinite(t["last_loss"])]
    want_lr = min(finished, key=lambda t: t["last_loss"])["lr"]
    best = grid.get_best_result("loss", mode="min")
    if best.config["lr"] != want_lr or len(best.history) != max_t:
        raise AssertionError(f"tune: best result lr {best.config['lr']}, "
                             f"expected {want_lr}")
    return total, trials, first


def tune_phase(torch, llama, card):
    """Tune and the autoscaler on the card: a head-only Cluster (2 CPUs,
    no GPU), the port's Autoscaler over a LocalSubprocessProvider with
    one node type, TUNE_NODE, and a Tuner sweeping TUNE_LRS under ASHA
    with a quarter of the card per trial; returns the trials' launches
    (the kernels line's "tune" path)."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch import tune  # noqa: PLC0415
    from ant_ray_tpu_torch._private import services  # noqa: PLC0415
    from ant_ray_tpu_torch.autoscaler import (  # noqa: PLC0415
        Autoscaler,
        AutoscalerConfig,
        LocalSubprocessProvider,
        NodeTypeConfig,
    )
    from ant_ray_tpu_torch.cluster_utils import Cluster  # noqa: PLC0415

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama-400m"]
    t0 = time.perf_counter()
    ref_loss = _tune_reference_loss(torch, llama)
    out = {"card": card, "model": "llama-400m",
           "reference_loss_s": round(time.perf_counter() - t0, 3)}
    free_before = torch.cuda.mem_get_info()[0]
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0,
                                      "_system_config": QUIET})
    session_dir = cluster._session_dir
    provider = LocalSubprocessProvider(cluster.gcs_address, session_dir)
    autoscaler = Autoscaler(cluster.gcs_address, provider, AutoscalerConfig(
        node_types=[NodeTypeConfig(TUNE_NODE[0], dict(TUNE_NODE[1]),
                                   max_workers=1)],
        idle_timeout_s=TUNE_IDLE_TIMEOUT_S, interval_s=TUNE_INTERVAL_S))
    rounds, stop = [], threading.Event()
    store_dirs = set()      # the autoscaled node's arena, checked after

    def reconcile():
        # The autoscaler's loop (Autoscaler.start()) with each round's
        # launches, terminations and times kept.
        while not stop.is_set():
            t = time.perf_counter()
            result = autoscaler.run_once()
            rounds.append((t, time.perf_counter(), result))
            for pid in provider.non_terminated_nodes():
                store_dirs.update(services.store_dir_of(a) for a in
                                  provider.node_addresses(pid) or ())
            stop.wait(TUNE_INTERVAL_S)

    driver = None
    try:
        cluster.connect()
        pids = [p.pid for p, _ in cluster._gcs_procs] + \
            [p.pid for p in cluster._node_procs]
        head_store = services.store_dir_of(cluster._node_addresses[0])
        autoscaler.run_once()   # a heartbeat first: infeasible now waits
        driver = threading.Thread(target=reconcile, daemon=True)
        driver.start()
        scheduler = _recording_asha(tune)
        tuner = tune.Tuner(
            tune_trial, param_space={"lr": tune.grid_search(TUNE_LRS)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=scheduler,
                resources_per_trial={"GPU": TUNE_GPU_PER_TRIAL}))
        fitted = {}
        t_fit, t_fit_wall = time.perf_counter(), time.time()
        fit = threading.Thread(
            target=lambda: fitted.setdefault("grid", tuner.fit()),
            daemon=True)
        fit.start()
        fit.join(TUNE_FIT_TIMEOUT_S)
        t_fitted = time.perf_counter()
        if "grid" not in fitted:
            raise AssertionError(f"tune: fit() not done in "
                                 f"{TUNE_FIT_TIMEOUT_S} s")
        grid = fitted["grid"]
        out["fit_s"] = round(t_fitted - t_fit, 3)
        nodes = [n for n in art.nodes()
                 if (n["Labels"] or {}).get("art/node-type") == TUNE_NODE[0]]
        if len(nodes) != 1:
            raise AssertionError(f"tune: autoscaled nodes {nodes}")
        total, trials, first = _tune_gates(grid, scheduler.log, ref_loss,
                                           nodes[0]["NodeID"], cfg.n_layers)
        # Scale-down: the idle node terminated within TUNE_SCALE_DOWN_S.
        deadline = time.monotonic() + TUNE_SCALE_DOWN_S + 30
        while time.monotonic() < deadline and not any(
                r["terminated"] for _, _, r in rounds):
            time.sleep(0.05)
        stop.set()
        driver.join(timeout=30)
        launched = [(t, e, n) for t, e, r in rounds for n in r["launched"]]
        terminated = [(e, n) for t, e, r in rounds for n in r["terminated"]]
        out["launched"] = [n for _, _, n in launched]
        out["terminated"] = [n for _, n in terminated]
        if out["launched"] != [TUNE_NODE[0]] or \
                out["terminated"] != [TUNE_NODE[0]]:
            raise AssertionError(f"tune: launched {out['launched']}, "
                                 f"terminated {out['terminated']}")
        out["node_launch_s"] = round(launched[0][1] - launched[0][0], 3)
        out["node_up_after_fit_start_s"] = round(launched[0][1] - t_fit, 3)
        out["scale_down_s"] = round(terminated[0][0] - t_fitted, 3)
        if out["scale_down_s"] > TUNE_SCALE_DOWN_S:
            raise AssertionError(f"tune: node terminated "
                                 f"{out['scale_down_s']} s after fit, over "
                                 f"{TUNE_SCALE_DOWN_S}")
        left = provider.non_terminated_nodes()
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split()
        trial_pids = {t["pid"] for t in trials}
        out["smi_pids"] = apps
        if left or trial_pids & {int(p) for p in apps if p.isdigit()} or \
                any(_pid_alive(p) for p in trial_pids):
            raise AssertionError(f"tune: after scale-down nodes {left}, "
                                 f"nvidia-smi pids {apps}, trial pids "
                                 f"{trial_pids}")
        for record in trials:
            record["started_after_fit_s"] = round(
                record.pop("started_at") - t_fit_wall, 3)
            record["start_to_first_report_s"] = round(
                sum(record["start"].values()), 3)
        out["trials"] = trials
        out["first_loss"] = first
        out["reference_loss"] = ref_loss
        out["first_loss_minus_reference"] = first - ref_loss
        out["asha_decisions"] = [
            [tid, it, d] for tid, it, _loss, d in scheduler.log
            if d == "STOP"]
        out["best_lr"] = grid.get_best_result("loss", mode="min").config["lr"]
        out["launches"] = total
    except BaseException:
        stop.set()
        _print_worker_logs(session_dir)
        for pid in list(provider.non_terminated_nodes()):
            provider.terminate_node(pid)
        art.shutdown()
        cluster.shutdown()
        raise
    t_down = time.perf_counter()
    art.shutdown()
    cluster.shutdown()
    _after_shutdown(torch, out, t_down, pids, session_dir, head_store,
                    free_before)
    out["autoscaled_arena_left"] = any(os.path.exists(d)
                                       for d in store_dirs)
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    print("tune " + json.dumps(out), flush=True)
    _gate_nothing_left(out)
    if out["autoscaled_arena_left"]:
        raise AssertionError("tune: the autoscaled node left its arena")
    return total


# The collective phase: an NCCL group at world size 1 on the card, every
# verb against its plain torch result.
COLLECTIVE_GROUP = "smoke-nccl"
COLLECTIVE_INT8 = 1 << 20           # elements of the int8 transport check


def _plain_reduce(torch, tensors, op):
    """The plain torch reduction over a list of same-shaped tensors."""
    stacked = torch.stack(tensors)
    return {"SUM": lambda: stacked.sum(0),
            "PRODUCT": lambda: stacked.prod(0),
            "MIN": lambda: stacked.amin(0),
            "MAX": lambda: stacked.amax(0),
            "AVERAGE": lambda: stacked.sum(0) / len(tensors)}[op.name]()


def _plain_q8(torch, x, block=256):
    """Blockwise int8 quantize then dequantize, written out in torch."""
    flat = x.reshape(-1).float()
    n = -(-flat.numel() // block)
    grid = torch.zeros(n * block, device=x.device)
    grid[:flat.numel()] = flat
    grid = grid.view(n, block)
    scale = grid.abs().amax(1) / 127.0
    scale[scale == 0] = 1.0
    q = torch.clamp(torch.round(grid / scale[:, None]), -127, 127)
    return (q * scale[:, None]).reshape(-1)[:flat.numel()].view(x.shape)


def _llama_400m_tree(torch, llama, dtype, seed):
    """A pytree of llama-400m's parameter shapes, random values from
    ``seed`` (drawn whole: not the model's initialiser)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(shapes):
        return {k: make(v) if isinstance(v, dict) else
                torch.randn(v, generator=gen, device="cuda").to(dtype)
                for k, v in shapes.items()}

    return make(llama.param_shapes(llama.CONFIGS["llama-400m"]))


def collective_phase(torch, llama, card):
    """Collectives on the card: an NCCL group at world size 1; every
    per-rank verb and the *_multidevice verbs over the visible cards
    against the plain torch result (bitwise); the fused allreduce and
    sync_pytree of a pytree of llama-400m's shapes in bf16 against the
    per-tensor verb (bitwise); the int8 transport against a plain
    quantize and dequantize (bitwise) and its error bound; the
    GradientSyncer driven by post-accumulate-grad hooks against the
    one-shot sync_pytree (bitwise).  No flash kernel runs; returns
    nothing for the kernels line."""
    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415
    from ant_ray_tpu_torch.util.collective import ReduceOp, fusion  # noqa: PLC0415
    from ant_ray_tpu_torch.util.collective.collective import _group_mgr  # noqa: PLC0415

    def same(a, b):
        return (a.device.type == "cuda" and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))

    out = {"card": card}
    bad = []
    g = COLLECTIVE_GROUP
    t0 = time.perf_counter()
    col.init_collective_group(1, 0, backend="nccl", group_name=g)
    out["init_s"] = round(time.perf_counter() - t0, 3)
    group = _group_mgr.get_group(g)
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(1024, 257, generator=gen, device="cuda")
    for op in ReduceOp:
        if not same(col.allreduce(x.clone(), g, op),
                    _plain_reduce(torch, [x], op)):
            bad.append(f"allreduce {op.name}")
        if not same(col.reduce(x.clone(), 0, g, op),
                    _plain_reduce(torch, [x], op)):
            bad.append(f"reduce {op.name}")
        if not same(col.reducescatter(x.clone(), g, op),
                    _plain_reduce(torch, [x], op)):
            bad.append(f"reducescatter {op.name}")
    if not same(col.broadcast(x.clone(), 0, g), x):
        bad.append("broadcast")
    gathered = col.allgather(x.clone(), g)
    if len(gathered) != 1 or not same(gathered[0], x):
        bad.append("allgather")
    col.barrier(g)
    for verb, call in (("send", lambda: col.send(x, 0, g)),
                       ("recv", lambda: col.recv(x, 0, g))):
        try:
            call()
            bad.append(f"{verb} to itself did not raise")
        except ValueError:
            pass
    n_cards = torch.cuda.device_count()
    per_card = [torch.randn(64, 33, generator=gen, device="cuda").to(
        f"cuda:{i}") for i in range(n_cards)]
    for op in (ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX, ReduceOp.AVERAGE):
        want = _plain_reduce(torch, [t.to("cuda:0") for t in per_card], op)
        for t in col.allreduce_multidevice(per_card, g, op):
            if not same(t, want.to(t.device)):
                bad.append(f"allreduce_multidevice {op.name}")
        for i, t in enumerate(col.reducescatter_multidevice(per_card, g, op)):
            chunk = want.shape[0] // n_cards
            if not same(t, want[i * chunk:(i + 1) * chunk].to(t.device)):
                bad.append(f"reducescatter_multidevice {op.name}")
    for t in col.broadcast_multidevice(per_card, 0, g):
        if not same(t, per_card[0].to(t.device)):
            bad.append("broadcast_multidevice")
    for pieces in col.allgather_multidevice(per_card, g):
        if len(pieces) != n_cards or not all(
                same(p, per_card[i].to(p.device))
                for i, p in enumerate(pieces)):
            bad.append("allgather_multidevice")

    # Fused: llama-400m's parameter shapes in bf16.
    tree = _llama_400m_tree(torch, llama, torch.bfloat16, 25)
    leaves, _ = fusion.flatten_pytree(tree)
    naive = [col.allreduce(t.clone(), g, ReduceOp.AVERAGE) for t in leaves]
    stats0 = col.fusion_stats(g)
    fused = col.allreduce_coalesced([t.clone() for t in leaves], g,
                                    ReduceOp.AVERAGE)
    if not all(same(a, b) for a, b in zip(fused, naive)):
        bad.append("allreduce_coalesced against the per-tensor verb")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synced = col.sync_pytree(tree, g)
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    synced_leaves, _ = fusion.flatten_pytree(synced)
    if not all(same(a, b) for a, b in zip(synced_leaves, naive)):
        bad.append("sync_pytree against the per-tensor verb")
    stats = col.fusion_stats(g)
    out["pytree"] = {"leaves": len(leaves),
                     "bytes": sum(t.numel() * 2 for t in leaves),
                     "buckets": stats["last"]["buckets"],
                     "calls": stats["calls"] - stats0["calls"],
                     "sync_pytree_ms": walls,
                     "last": {k: (round(v, 6) if isinstance(v, float) else v)
                              for k, v in stats["last"].items()}}

    # int8 transport: one fp32 bucket.
    q_in = torch.randn(COLLECTIVE_INT8 + 37, generator=gen, device="cuda")
    q_in[:256] = 0.0                    # an all-zero block keeps scale 1
    got = col.allreduce_coalesced([q_in], g, ReduceOp.SUM,
                                  transport_dtype="int8")[0]
    want = _plain_q8(torch, q_in)
    scale = torch.nn.functional.pad(q_in.abs(), (0, (-q_in.numel()) % 256)
                                    ).view(-1, 256).amax(1) / 127.0
    bound = float((scale / 2).max())
    err = float((got - q_in).abs().max())
    out["int8"] = {"elements": q_in.numel(), "max_abs_err": err,
                   "bound": bound,
                   "wire_bytes": col.fusion_stats(g)["last"]["wire_bytes"]}
    if not same(got, want):
        bad.append("int8 transport against the plain quantize/dequantize")
    if err > bound:
        bad.append(f"int8 transport error {err} over {bound}")

    # GradientSyncer on post-accumulate-grad hooks.
    params = _llama_400m_tree(torch, llama, torch.bfloat16, 26)
    p_leaves, _ = fusion.flatten_pytree(params)
    for p in p_leaves:
        p.requires_grad_()
    syncer = col.gradient_syncer(g)
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: syncer.ready(i, p.grad)) for i, p in enumerate(
            p_leaves)]
    syncer.begin(params)
    loss = sum((p.float() * (k + 1)).square().mean()
               for k, p in enumerate(p_leaves))
    loss.backward()
    hooked = syncer.wait()
    for h in hooks:
        h.remove()
    one_shot = col.sync_pytree({k: v for k, v in _grads_of(params).items()},
                               g)
    hooked_leaves = fusion.flatten_pytree(hooked)[0]
    if not all(same(a, b) for a, b in zip(
            hooked_leaves, fusion.flatten_pytree(one_shot)[0])):
        bad.append("GradientSyncer against sync_pytree")
    out["syncer"] = {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in col.fusion_stats(g)["last"].items()}
    col.destroy_collective_group(g)
    if col.is_group_initialized(g) or not group.destroyed:
        bad.append("the group outlived destroy_collective_group")
    out["bad"] = bad
    print("collective " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"collective: {bad}")
    del tree, params, naive, fused, synced, hooked, one_shot
    torch.cuda.empty_cache()


def _grads_of(params):
    return {k: _grads_of(v) if isinstance(v, dict) else v.grad
            for k, v in params.items()}


# The trainer phase: a TorchTrainer of two ranks sharing the card.
TRAINER_WORKERS = 2
TRAINER_BATCH = (8, 2049)           # the train phase's batch, split by rank
TRAINER_STEPS = 2                   # 3 until the parallel phase came
TRAINER_FIT_TIMEOUT_S = 300.0


def _tree_checksums(torch, tree, prefix=""):
    """Every tensor leaf's bits summed as int64, on its device, by
    name."""
    sums = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sums.update(_tree_checksums(torch, v, f"{prefix}{k}."))
        else:
            sums[f"{prefix}{k}"] = int(torch.sum(
                v.detach().contiguous().view(torch.int16),
                dtype=torch.int64))
    return sums


def trainer_loop(config):
    """One rank of the trainer phase, in a worker: llama-400m from the
    driver's seed-0 weights on the card (it raises without one), AdamW,
    this rank's 4 of the 8 sequences; each step the loss and backward
    through the flash kernels, the gradients averaged over the gang by
    ``train.sync_gradients`` over a gloo group this loop creates (NCCL
    refuses two ranks of one group on one card, and both ranks share
    the H100), then the update.  Each step's loss, launches, parameter
    checksums and times go to this rank's log file; the last step of
    rank 0 saves its parameters and optimizer state through
    ``train.save_pytree`` and reports that checkpoint."""
    t0 = time.perf_counter()
    started = time.time()
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch import train  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415
    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415

    t_import = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("trainer: no CUDA device in its worker")
    ctx = train.get_context()
    rank, world = ctx.world_rank, ctx.world_size
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter()
    cfg = llama.CONFIGS["llama-400m"]
    # The driver writes the weights while the ranks start (save_pytree
    # renames the complete directory into place).
    deadline = time.monotonic() + TRAINER_FIT_TIMEOUT_S
    while not os.path.isdir(config["weights"]):
        if time.monotonic() > deadline:
            raise TimeoutError("trainer: no weights from the driver")
        time.sleep(0.05)
    t_wait = time.perf_counter()
    params = train.load_pytree(config["weights"])
    t_load = time.perf_counter()
    params = _tree_map(lambda t: t.to("cuda"), params)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter()
    optimizer = train.make_optimizer(params)
    t_opt = time.perf_counter()
    per_rank = TRAINER_BATCH[0] // world
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TRAINER_BATCH)[rank * per_rank:
                                         (rank + 1) * per_rank]).cuda()
    torch.cuda.synchronize()
    t_params = time.perf_counter()
    group = f"trainer-gloo-a{ctx.attempt}"
    col.init_collective_group(world, rank, backend="gloo", group_name=group)
    t_group = time.perf_counter()
    log = open(os.path.join(config["log_dir"], f"rank{rank}.jsonl"), "w")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    for step in range(TRAINER_STEPS):
        before = _counts(fa)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss = llama.loss_fn(params, {"tokens": tokens}, cfg, remat="none")
        loss.backward()
        torch.cuda.synchronize()
        t_bwd = time.perf_counter()
        synced = train.sync_gradients(_grads_of(params), group_name=group)
        _set_grads(params, synced)
        torch.cuda.synchronize()
        t_sync = time.perf_counter()
        optimizer.step()
        value = loss.item()
        t_end = time.perf_counter()
        after = _counts(fa)
        record = {"step": step, "loss": value,
                  "launches": {k: after[k] - before[k] for k in after},
                  "checksums": _tree_checksums(torch, params),
                  "step_s": round(t_end - ts, 4),
                  "backward_s": round(t_bwd - ts, 4),
                  "sync_s": round(t_sync - t_bwd, 4),
                  "fusion": {k: round(v, 4) for k, v in
                             col.fusion_stats(group).items()
                             if k in ("pack_s", "transfer_s",
                                      "collective_s", "unpack_s",
                                      "buckets", "wire_bytes")},
                  "device": str(params["embed"].device)}
        if step == 0:
            record["start"] = {
                "started_at": started, "import_s": t_import - t0,
                "cuda_init_s": t_cuda - t_import,
                "weights_wait_s": t_wait - t_cuda,
                "weights_load_s": t_load - t_wait,
                "weights_to_card_s": t_h2d - t_load,
                "optimizer_s": t_opt - t_h2d,
                "tokens_s": t_params - t_opt,
                "group_s": t_group - t_params,
                "first_step_s": t_end - ts}
        checkpoint = None
        if step == TRAINER_STEPS - 1:
            record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if rank == 0:
                path = os.path.join(ctx.storage_path, "final")
                train.save_pytree({"params": params,
                                   "optimizer": optimizer.state_dict()},
                                  path)
                checkpoint = train.Checkpoint.from_directory(path)
        log.write(json.dumps(record) + "\n")
        log.flush()
        train.report({"step": step, "loss": value}, checkpoint=checkpoint)
    log.close()
    col.destroy_collective_group(group)


def _set_grads(params, grads):
    for k, v in params.items():
        if isinstance(v, dict):
            _set_grads(v, grads[k])
        else:
            v.grad = grads[k]


def _trainer_reference(torch, llama, weights):
    """The driver's loss_fn over the 8 sequences on the seed-0 weights,
    after writing them to ``weights`` for the ranks; returns the loss
    and the seconds of init and write."""
    from ant_ray_tpu_torch import train  # noqa: PLC0415
    from ant_ray_tpu_torch.train.step import param_leaves  # noqa: PLC0415

    cfg = llama.CONFIGS["llama-400m"]
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    train.save_pytree(params, weights)
    t_write = time.perf_counter()
    for leaf in param_leaves(params):
        leaf.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TRAINER_BATCH)).cuda()
    loss = llama.loss_fn(params, {"tokens": tokens}, cfg,
                         remat="none").item()
    del params, tokens
    torch.cuda.empty_cache()
    return loss, t_init - t0, t_write - t_init


def _trainer_gates(records, ref_loss, n_layers, out):
    """The trainer's gates over each rank's step records; returns the
    launches of both ranks as a _counts() dict."""
    per_step = {"fwd": n_layers, "fwd_sm90": n_layers, "dq": n_layers,
                "dkv": n_layers, "sm90": n_layers}
    total = {}
    for rank, recs in records.items():
        if [r["step"] for r in recs] != list(range(TRAINER_STEPS)):
            raise AssertionError(f"trainer: rank {rank} logged steps "
                                 f"{[r['step'] for r in recs]}")
        for r in recs:
            want = {k: per_step.get(k, 0) for k in r["launches"]}
            if r["launches"] != want or r["device"] != "cuda:0":
                raise AssertionError(
                    f"trainer: rank {rank} step {r['step']} launched "
                    f"{r['launches']} on {r['device']}, expected {want}")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    for step in range(TRAINER_STEPS):
        sums = [records[rank][step]["checksums"] for rank in records]
        if any(s != sums[0] for s in sums):
            raise AssertionError(f"trainer: parameter checksums differ "
                                 f"between the ranks after step {step}")
    first = statistics.mean(records[r][0]["loss"] for r in records)
    out["step0_mean_loss"] = first
    out["reference_loss"] = ref_loss
    if abs(first - ref_loss) > BF16_LOSS_TOL:
        raise AssertionError(f"trainer: step-0 mean loss {first} against "
                             f"the driver's {ref_loss}")
    losses = [statistics.mean(records[r][s]["loss"] for r in records)
              for s in range(TRAINER_STEPS)]
    out["mean_losses"] = losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"trainer: losses {losses}: not finite or "
                             "not falling")
    return total


def trainer_phase(torch, llama, card):
    """A TorchTrainer on the card: two ranks of llama-400m sharing it
    ({"CPU": 1, "GPU": 0.5} each, gang-scheduled through a placement
    group), gradients averaged every step; returns both ranks' launches
    (the kernels line's "trainer" path)."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch import train  # noqa: PLC0415
    from ant_ray_tpu_torch._private import services  # noqa: PLC0415
    from ant_ray_tpu_torch.cluster_utils import Cluster  # noqa: PLC0415

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama-400m"]
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="trainer_smoke_", dir=root)
    weights = os.path.join(workdir, "weights")
    log_dir = os.path.join(workdir, "logs")
    os.makedirs(log_dir)
    out = {"card": card, "model": "llama-400m", "ranks": TRAINER_WORKERS,
           "batch_per_rank": [TRAINER_BATCH[0] // TRAINER_WORKERS,
                              TRAINER_BATCH[1]]}
    free_before = torch.cuda.mem_get_info()[0]
    cluster = Cluster(head_node_args={"num_cpus": 4, "num_gpus": 1,
                                      "_system_config": QUIET})
    session_dir = cluster._session_dir
    try:
        cluster.connect()
        pids = [p.pid for p, _ in cluster._gcs_procs] + \
            [p.pid for p in cluster._node_procs]
        head_store = services.store_dir_of(cluster._node_addresses[0])
        out["cluster_s"] = round(time.perf_counter() - t0, 3)
        trainer = train.TorchTrainer(
            trainer_loop,
            train_loop_config={"weights": weights, "log_dir": log_dir},
            scaling_config=train.ScalingConfig(
                num_workers=TRAINER_WORKERS, use_gpu=True,
                resources_per_worker={"CPU": 1, "GPU": 0.5}),
            run_config=train.RunConfig(
                name="smoke-trainer",
                storage_path=os.path.join(workdir, "runs"),
                checkpoint_config=train.CheckpointConfig(replicate=False)))
        fitted = {}
        t_fit, t_fit_wall = time.perf_counter(), time.time()
        fit = threading.Thread(
            target=lambda: fitted.setdefault("result", trainer.fit()),
            daemon=True)
        fit.start()
        # The weights and the reference loss while the ranks start.
        ref_loss, init_s, write_s = _trainer_reference(torch, llama,
                                                       weights)
        out["weights_init_s"] = round(init_s, 3)
        out["weights_write_s"] = round(write_s, 3)
        out["reference_s"] = round(time.perf_counter() - t_fit, 3)
        fit.join(TRAINER_FIT_TIMEOUT_S)
        out["fit_s"] = round(time.perf_counter() - t_fit, 3)
        if "result" not in fitted:
            raise AssertionError(f"trainer: fit() not done in "
                                 f"{TRAINER_FIT_TIMEOUT_S} s")
        result = fitted["result"]
        records = {}
        for rank in range(TRAINER_WORKERS):
            with open(os.path.join(log_dir, f"rank{rank}.jsonl")) as f:
                records[rank] = [json.loads(line) for line in f]
        attempt_ok = result.error is None and \
            result.metrics.get("step") == TRAINER_STEPS - 1
        if not attempt_ok or not os.path.basename(
                result.checkpoint.path) == "final":
            raise AssertionError(f"trainer: result {result}")
        total = _trainer_gates(records, ref_loss, cfg.n_layers, out)
        restored = result.checkpoint.to_pytree(device="cuda")
        last = records[0][-1]["checksums"]
        got = _tree_checksums(torch, restored["params"])
        devices = {str(t.device) for t in
                   _flat_tensors(restored["params"])}
        out["checkpoint_bitwise"] = got == last and devices == {"cuda:0"}
        out["checkpoint_optimizer_leaves"] = len(
            restored["optimizer"]["state"])
        if not out["checkpoint_bitwise"] or \
                out["checkpoint_optimizer_leaves"] != 12:
            raise AssertionError("trainer: the checkpoint did not load back "
                                 f"onto cuda bitwise ({devices})")
        del restored
        torch.cuda.empty_cache()
        out["ranks_detail"] = {
            rank: {"steps_s": [r["step_s"] for r in recs],
                   "backward_s": [r["backward_s"] for r in recs],
                   "sync_s": [r["sync_s"] for r in recs],
                   "fusion": recs[-1]["fusion"],
                   "peak_gb": round(recs[-1]["peak_gb"], 3),
                   "start": {k: round(v, 3) for k, v in
                             recs[0]["start"].items()
                             if k != "started_at"},
                   "started_after_fit_s": round(
                       recs[0]["start"]["started_at"] - t_fit_wall, 3)}
            for rank, recs in records.items()}
        out["launches"] = total
    except BaseException:
        _print_worker_logs(session_dir)
        art.shutdown()
        cluster.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    t_down = time.perf_counter()
    art.shutdown()
    cluster.shutdown()
    shutil.rmtree(workdir, ignore_errors=True)
    _after_shutdown(torch, out, t_down, pids, session_dir, head_store,
                    free_before)
    out["card_free_gb"] = {
        "before": round(free_before / 1e9, 3),
        "after": round(torch.cuda.mem_get_info()[0] / 1e9, 3),
        "driver_allocated": round(torch.cuda.memory_allocated() / 1e9, 3),
        "driver_reserved": round(torch.cuda.memory_reserved() / 1e9, 3),
        "smi_apps": subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split("\n")}
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    print("trainer " + json.dumps(out), flush=True)
    _gate_nothing_left(out)
    return total


# The reference's PPO learning test (tests/test_rllib.py:43-60): its
# runners, rollout, optimizer, epochs, minibatch, iterations and seed.
RLLIB_RUNNERS = {"num_env_runners": 2, "num_envs_per_env_runner": 8,
                 "rollout_fragment_length": 128}
RLLIB_TRAINING = {"lr": 1e-3, "num_epochs": 6, "minibatch_size": 256,
                  "seed": 0}
RLLIB_ITERATIONS = 12
RLLIB_LEARNED = 20.0            # best episode_return_mean over the first
RLLIB_BUDGET_S = 15.0           # the phase's wall time, gates included
# One update on the card against the same update on the CPU: the
# reference's own DDP tolerance (tests/test_rllib_depth.py:91).
RLLIB_UPDATE_TOL = {"rtol": 1e-4, "atol": 1e-5}
RLLIB_ALGORITHMS = ("ppo", "impala", "appo", "dqn", "sac", "bc")


def _rllib_batch(name, fragments, rng):
    """The fixed input of one ``name`` update, as numpy: for PPO 256
    rows drawn from the learning run's last fragments (GAE and the flat
    layout of ``Algorithm.train``), IMPALA's and APPO's whole fragment
    set, and for DQN, SAC and BC a seeded batch at their configs'
    batch sizes (64, 128, 128)."""
    from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

    def cat(key, axis=1):
        return np.concatenate([f[key] for f in fragments], axis=axis)

    if name == "ppo":
        adv, returns = ppo.compute_gae(
            cat("rewards"), cat("values"), cat("dones"),
            cat("last_values", 0), gamma=0.99, lam=0.95)
        rows = rng.permutation(adv.size)[:RLLIB_TRAINING["minibatch_size"]]
        return {"obs": cat("obs").reshape(-1, 4)[rows],
                "actions": cat("actions").reshape(-1)[rows],
                "logp_old": cat("logp").reshape(-1)[rows],
                "advantages": adv.reshape(-1)[rows],
                "returns": returns.reshape(-1)[rows]}
    if name in ("impala", "appo"):
        return {"obs": cat("obs"), "actions": cat("actions"),
                "behavior_logp": cat("logp"), "rewards": cat("rewards"),
                "dones": cat("dones"), "bootstrap_obs": cat("last_obs", 0)}
    n = {"dqn": 64, "sac": 128, "bc": 128}[name]
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int64)}
    if name != "bc":
        batch.update(
            rewards=np.ones(n, np.float32),
            next_obs=rng.standard_normal((n, 4)).astype(np.float32),
            dones=(rng.random(n) < 0.05).astype(np.float32))
    return batch


def _rllib_one_update(rllib, name, device, weights, batch):
    """Weights (numpy) after one update of ``name``'s own step on
    ``device``, from ``weights`` on ``batch``; no runner is made."""
    from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

    if name == "bc":
        bc = rllib.BC(obs_dim=4, n_actions=2, device=device)
        bc.learners.set_weights(weights)
        bc.learners.update_from_batch(batch)
        return bc.get_weights()
    config = {"ppo": rllib.PPOConfig, "impala": rllib.IMPALAConfig,
              "appo": rllib.APPOConfig, "dqn": rllib.DQNConfig,
              "sac": rllib.SACConfig}[name](device=device)
    algo = config.env_runners(num_env_runners=0).build()
    algo.set_weights(weights)
    on = ppo.to_device(batch, algo.device)
    if name == "dqn":
        algo._update(algo.params, algo._opt_state, algo._target_params, on)
    else:
        algo._update(algo.params, algo._opt_state, on)
    return algo.get_weights()


def rllib_phase(torch, card):
    """RLlib on the card, in this process with no cluster (the runners
    inline, no process started): PPO learning CartPole-v1 at the
    reference's learning configuration, then one update of each of the
    six algorithms on the card against the same update on the CPU.
    Returns the learning run's launches (the kernels line's "rllib"
    path: the MLPs reach no flash kernel)."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch import rllib  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415
    from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

    if art.is_initialized():
        raise AssertionError("rllib phase: a cluster is up; its runners "
                             "would start actors")
    t_phase = time.perf_counter()
    algo = (rllib.PPOConfig().environment("CartPole-v1")
            .env_runners(**RLLIB_RUNNERS).training(**RLLIB_TRAINING)
            .build())
    # Time the runners' sampling and count Adam's steps around the
    # algorithm's own calls; what is left of train() is the update.
    iters = []
    runner_call, update = algo._runner_call, algo._update
    fragments = []

    def timed_runner_call(method, *args):
        t = time.perf_counter()
        out = runner_call(method, *args)
        if method == "sample":
            iters[-1]["sample_s"] += time.perf_counter() - t
            fragments[:] = out
        return out

    def counted_update(*args):
        iters[-1]["adam_steps"] += 1
        return update(*args)

    algo._runner_call, algo._update = timed_runner_call, counted_update
    returns, result = [], None
    _reset_counts(fa)
    for i in range(RLLIB_ITERATIONS):
        iters.append({"sample_s": 0.0, "adam_steps": 0})
        t = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        it = iters[-1]
        it["update_s"] = time.perf_counter() - t - it["sample_s"]
        it["env_steps"] = result["num_env_steps_sampled"]
        it["return_mean"] = result["episode_return_mean"]
        print(f"rllib iteration {i}: sample {it['sample_s']:.3f} s, update "
              f"{it['update_s']:.3f} s ({it['adam_steps']} Adam steps), "
              f"episode_return_mean {it['return_mean']:.1f}", flush=True)
        if not np.isnan(it["return_mean"]):
            returns.append(it["return_mean"])
    counts = _counts(fa)
    learn_s = time.perf_counter() - t_phase
    if not returns or max(returns) <= returns[0] + RLLIB_LEARNED:
        raise AssertionError(f"rllib: PPO did not learn: {returns}")
    if not np.isfinite(result["learner"]["total_loss"]):
        raise AssertionError(f"rllib: total_loss {result['learner']}")
    devices = {str(t.device) for t in ppo.tree_leaves(algo.params)}
    if devices != {"cuda:0"}:
        raise AssertionError(f"rllib: parameters on {devices}")
    sample_s = sum(it["sample_s"] for it in iters)
    update_s = sum(it["update_s"] for it in iters)
    env_steps = sum(it["env_steps"] for it in iters)
    adam_steps = sum(it["adam_steps"] for it in iters)
    print(f"rllib PPO on {card}: {env_steps / sample_s:.1f} env steps/s "
          f"({env_steps} in {sample_s:.3f} s), {adam_steps / update_s:.1f} "
          f"Adam steps/s ({adam_steps} in {update_s:.3f} s)", flush=True)

    # One update on the card against the CPU, from the same weights on
    # the same batch, every leaf.
    rng = np.random.default_rng(0)
    policy = algo.get_weights()
    start = {"ppo": policy, "impala": policy, "appo": policy,
             "dqn": rllib.DQNConfig(device="cpu").env_runners(
                 num_env_runners=0).build().get_weights(),
             "sac": rllib.SACConfig(device="cpu").env_runners(
                 num_env_runners=0).build().get_weights(),
             "bc": rllib.BC(obs_dim=4, n_actions=2,
                            device="cpu").get_weights()}
    update_err = {}
    for name in RLLIB_ALGORITHMS:
        batch = _rllib_batch(name, fragments, rng)
        got, want = (_rllib_one_update(rllib, name, device, start[name],
                                       batch)
                     for device in ("cuda", "cpu"))
        got, want = ppo.tree_leaves(got), ppo.tree_leaves(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, err_msg=f"rllib {name}",
                                       **RLLIB_UPDATE_TOL)
        update_err[name] = max(float(np.abs(g - w).max())
                               for g, w in zip(got, want))
    wall_s = time.perf_counter() - t_phase
    print(json.dumps({"rllib": {
        "card": card, "config": {**RLLIB_RUNNERS, **RLLIB_TRAINING,
                                 "iterations": RLLIB_ITERATIONS},
        "returns": returns, "total_loss": result["learner"]["total_loss"],
        "env_steps_per_s": env_steps / sample_s,
        "adam_steps_per_s": adam_steps / update_s,
        "sample_s": [it["sample_s"] for it in iters],
        "update_s": [it["update_s"] for it in iters],
        "learn_s": learn_s, "update_max_abs_err_card_vs_cpu": update_err,
        "wall_s": wall_s}}), flush=True)
    print(f"rllib phase: {wall_s:.2f} s (learning {learn_s:.2f} s)",
          flush=True)
    if wall_s > RLLIB_BUDGET_S:
        raise AssertionError(f"rllib phase took {wall_s:.1f} s, over "
                             f"{RLLIB_BUDGET_S} s")
    return counts


def _flat_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_tensors(v)
        else:
            yield v


def slice_phase(torch, fa, llama):
    """The serving slice; returns the launches of its main path, the 8B
    weights, which the parallel, sessions and loop phases reuse (the
    engine and its cache go when this returns), and its greedy tokens
    and prefill and decode times, which the parallel phase prints beside
    its own."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415

    t0 = time.perf_counter()
    engine = LLMEngine("llama3-8b", slots=8, max_seq=4096, seed=0)
    torch.cuda.synchronize()
    cfg = engine.config
    print(f"llama3-8b engine up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e9:.2f} B params, {cfg.dtype}, slab "
          f"{2 * engine.cache['k'].numel() * 2 / 1e9:.2f} GB)", flush=True)
    prompts, sampled_prompt = _slice_prompts(cfg)
    lengths = tuple(len(p) for p in prompts)
    greedy = SamplingParams(max_tokens=32)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=1234)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, greedy)
    outs += engine.generate([sampled_prompt], sampled)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = _counts(fa)

    all_lengths = (*lengths, len(sampled_prompt))
    kernel_prefills = sum(1 for n in all_lengths
                          if _bucket(n, engine.max_seq) >= 128)
    for n, out in zip(all_lengths, outs):
        print(f"request prompt={n} bucket={_bucket(n, engine.max_seq)} "
              f"tokens={len(out.token_ids)} finish={out.finish_reason}",
              flush=True)
        if out.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request finished with {out.finish_reason}")
    expected = cfg.n_layers * kernel_prefills
    print(f"main path: {len(outs)} requests in {main_s:.2f} s, flash "
          f"forward launches {launches['fwd']}, of them sm90 "
          f"{launches['fwd_sm90']} (expected {expected} and {expected}), "
          f"backward kernel launches {launches['dq']} and {launches['dkv']} "
          f"(expected 0)", flush=True)
    if launches != {"fwd": expected, "fwd_sm90": expected, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0,
                    "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}:
        raise AssertionError(f"serving launched {launches}, expected "
                             f"{expected} sm90 forward and no other launches")

    # Is the 8B path right?  Last-token logits of the 1500-token prompt
    # through the flash kernel against the same model with blockwise
    # attention (the kernel's arithmetic in plain PyTorch).  bf16
    # activations through 32 random layers drift by rounding alone, so the
    # tolerance is measured in this run: the kernel may be at most twice
    # as far from blockwise as the full-softmax reference attention is
    # (two plain versions that differ only in where bf16 rounds).
    n = 1500
    bucket = _bucket(n, engine.max_seq)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    toks[0, :n] = torch.tensor(prompts[3], device="cuda")
    with torch.inference_mode():
        got, _ = llama.prefill_into_cache(engine.params, toks, engine.cache,
                                          0, n, cfg)
        want, alt = (llama.forward(engine.params, toks, cfg, attn_impl=impl,
                                   logits_at=n - 1)[0]
                     for impl in ("blockwise", "reference"))

    err, noise = _rel_l2(got, want), _rel_l2(alt, want)
    tol = 2 * noise + 1e-3
    print(f"8B logits check: shape {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}, relative L2 error vs "
          f"blockwise {err:.3e}, reference vs blockwise {noise:.3e} "
          f"(tol {tol:.3e})", flush=True)
    if not (got.shape == (cfg.vocab_size,) and torch.isfinite(got).all()
            and err <= tol):
        raise AssertionError("8B logits check failed")

    prefill_ms = {}
    with torch.inference_mode():
        for n in lengths:
            bucket = _bucket(n, engine.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            toks[0, :n] = torch.tensor(prompts[lengths.index(n)],
                                       device="cuda")
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                llama.prefill_into_cache(engine.params, toks, engine.cache,
                                         0, n, cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            prefill_ms[bucket] = statistics.median(times)
        context = 1024
        engine.cache["length"].fill_(context)
        last = torch.zeros((engine.slots,), dtype=torch.int64, device="cuda")

        def step():
            engine.cache["length"].fill_(context)
            llama.decode_step(engine.params, last, engine.cache, cfg)

        decode_ms = _median_ms(torch, step)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print("prefill ms per bucket " + json.dumps(prefill_ms), flush=True)
        print(f"decode: {decode_ms:.2f} ms per step of {engine.slots} slots "
              f"at context {context} = "
              f"{engine.slots / decode_ms * 1e3:.1f} tokens/s; peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        for n in (20, 3000):
            bucket = _bucket(n, engine.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            toks[0, :n] = torch.tensor(prompts[lengths.index(n)],
                                       device="cuda")
            _profile(torch, f"prefill bucket {bucket}",
                     lambda t=toks, n=n: llama.prefill_into_cache(
                         engine.params, t, engine.cache, 0, n, cfg))
        _profile(torch, f"decode step, {engine.slots} slots, context "
                 f"{context}", step)
    return launches, engine.params, {
        "tokens": [o.token_ids for o in outs[:len(prompts)]],
        "prefill_ms": {b: round(ms, 2) for b, ms in prefill_ms.items()},
        "decode_ms": round(decode_ms, 2)}


# The parallel phase (queue A item 8): a tensor-parallel Llama-3-8B
# engine on a virtual mesh of two cells of the card, beside the serving
# slice, and a sharded llama-400m step beside the training slice.
PARALLEL_CELLS = "cuda:0"       # every cell of the phase's virtual meshes
PARALLEL_ROWS = 4               # the train phase's rows in the sharded step
PARALLEL_TOKENS = 32            # greedy tokens printed against the slice's
# The TP engine's last-token logits (prefill) and first-decode-step logits
# against the unsharded model's on the same weights, relative L2 error,
# in bf16.  Each cell's attention is the same kernel on the same heads;
# only where bf16 rounds moves: a psum of two bf16 partial products after
# wo and w_down in place of one product over the full K, carried through
# 32 random layers.  Readings (tools/phase.py parallel --readings, NVIDIA
# H100 80GB HBM3, 700.00 W, the same in PR 25's and PR 26's runs): 5.07e-2
# to 5.69e-2 at the five prompts, 3.81e-2 to 5.70e-2 at the decode step's
# slots; the unsharded model's own spread, reference attention against
# the flash kernel at the 1500-token prompt, 5.25e-2.  That the spread is
# rounding, _tp_c4_check shows on llama-400m (TP_LOGIT_TOL below).
# Faults planted in the TP prefill: wq's shards swapped between the
# cells 1.40, wo's 1.41, the psum dropped 1.40.  The limit is 1.75x the
# largest sound reading (5.70e-2) and a fourteenth of the faults'.
TP_BF16_LOGIT_TOL = 0.1


# ROADMAP §C C4: is the tp engine's bf16 spread rounding?  On the train
# phase's llama-400m weights (8 heads, 4 KV heads: 2 a cell), the tp=2
# engine's last-token prefill logits against the unsharded model's, in
# fp32 (the tf32x3 route, TF32 off), and in bf16 with reference attention
# on both sides and with the kernels on both sides; beside them the
# unsharded bf16 model's own spread (reference attention against the
# kernel).  Readings (tools/phase.py parallel --readings, NVIDIA H100
# 80GB HBM3, 700.00 W, at 1500 tokens): fp32 3.46e-6; bf16 2.14e-2 with
# reference attention, 1.95e-2 with the kernels, the unsharded model's
# own spread 2.02e-2.  The sharding is exact to fp32's rounding, and the
# bf16 spread is the unsharded model's own.  TP_LOGIT_TOL gates the fp32
# reading at ~29x its value (a sharding fault moves the logits by O(1):
# 1.40 in bf16 at 8B, TP_BF16_LOGIT_TOL above); the bf16 readings are
# held to TP_BF16_LOGIT_TOL.
TP_C4_PROMPT = 1500             # prompt tokens (bucket 2048)
TP_LOGIT_TOL = 1e-4


def _tp_c4_check(torch, llama, cfg, params, readings=False):
    """The C4 readings (relative L2 of the logits, tp=2 against
    unsharded) as a dict; unless ``readings``, gates the fp32 one at
    TP_LOGIT_TOL and the bf16 ones at TP_BF16_LOGIT_TOL."""
    from ant_ray_tpu_torch.llm import LLMEngine  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.parallel import build_mesh, spmd  # noqa: PLC0415

    t0 = time.perf_counter()
    n = TP_C4_PROMPT
    bucket = _bucket(n, cfg.max_seq)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    toks[0, :n] = torch.from_numpy(np.random.default_rng(26).integers(
        0, cfg.vocab_size, n)).cuda()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            for dtype, impls in ((torch.float32, ("auto",)),
                                 (torch.bfloat16, ("reference", "auto"))):
                c = dataclasses.replace(cfg, dtype=dtype)
                tree = _tree_map(lambda t: t.detach().to(dtype), params)
                tp = LLMEngine(c, params=tree, slots=1, max_seq=bucket,
                               mesh=build_mesh(
                                   devices=[PARALLEL_CELLS] * 2, tp=2))
                cache = llama.init_kv_cache(c, 1, bucket, device="cuda")
                name = str(dtype).removeprefix("torch.")
                unsharded = {}
                for impl in impls:
                    got = llama.prefill_into_cache(
                        tp.params, toks, tp.cache, 0, n, c,
                        attn_impl=impl)[0]
                    unsharded[impl] = llama.prefill_into_cache(
                        tree, toks, cache, 0, n, c, attn_impl=impl)[0]
                    out[f"{name}_{impl}"] = _rel_l2(got, unsharded[impl])
                if len(impls) == 2:
                    out[f"{name}_unsharded_reference_vs_kernel"] = _rel_l2(
                        unsharded["auto"], unsharded["reference"])
                elif readings:      # a sharding fault, as the fp32 gate sees it
                    psum, spmd.psum = spmd.psum, (
                        lambda values, mesh, axes: list(values))
                    try:
                        out[f"{name}_psum_dropped"] = _rel_l2(
                            llama.prefill_into_cache(
                                tp.params, toks, tp.cache, 0, n, c)[0],
                            unsharded["auto"])
                    finally:
                        spmd.psum = psum
                del tp, cache, tree, got, unsharded
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    print(f"parallel tp c4 llama-400m, prompt {n} (bucket {bucket}), tp=2 "
          f"against unsharded, last-token logits relative L2 "
          + json.dumps(out) + f" (tol fp32 {TP_LOGIT_TOL}, bf16 "
          f"{TP_BF16_LOGIT_TOL}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not readings and not (
            out["float32_auto"] <= TP_LOGIT_TOL
            and out["bfloat16_reference"] <= TP_BF16_LOGIT_TOL
            and out["bfloat16_auto"] <= TP_BF16_LOGIT_TOL):
        raise AssertionError(f"tp=2 logits off the unsharded model's: "
                             f"{out}")
    return out


def _slice_prompts(cfg):
    """The serving slice's five greedy prompts (20 to 3000 token ids) and
    its sampled one (300), from default_rng(0)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 100, 700, 1500, 3000)]
    return prompts, rng.integers(0, cfg.vocab_size, 300).tolist()


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _tp_logit_readings(torch, llama, engine, params, toks, n, cfg, want):
    """The TP prefill's logits error at faults planted for one call, and
    the unsharded model's own spread (reference attention against the
    flash kernel), each as relative L2 against ``want`` (the unsharded
    logits of ``toks``)."""
    from ant_ray_tpu_torch.parallel import spmd  # noqa: PLC0415

    def tp_logits(tree):
        return llama.prefill_into_cache(tree, toks, engine.cache, 7, n,
                                        cfg)[0]

    def swapped(name):
        leaf = engine.params["layers"][name]
        return dict(engine.params, layers=dict(
            engine.params["layers"], **{name: spmd.ShardedTensor(
                leaf.shards[::-1], leaf.sharding, leaf.shape)}))

    out = {f"{name}_swapped": _rel_l2(tp_logits(swapped(name)), want)
           for name in ("wq", "wo")}
    psum = spmd.psum
    spmd.psum = lambda values, mesh, axes: list(values)   # no reduction
    try:
        out["psum_dropped"] = _rel_l2(tp_logits(engine.params), want)
    finally:
        spmd.psum = psum
    out["unsharded_reference_vs_flash"] = _rel_l2(llama.forward(
        params, toks, cfg, attn_impl="reference", logits_at=n - 1)[0], want)
    return out


def parallel_serve_phase(torch, fa, llama, params, want=None,
                         readings=False):
    """Tensor-parallel serving: LLMEngine("llama3-8b", params=params,
    slots=8, max_seq=4096) on build_mesh(devices=["cuda:0"] * 2, tp=2),
    the serving slice's weights laid out over the two cells.  Gates: every
    shard on cuda:0 at tp=2's local shapes, the slab split by KV heads;
    greedy generation of the slice's five prompts launching the sm90
    forward 2 x 32 times for each bucket of 128 or more and nothing else;
    the TP prefill's last-token logits of each prompt, and the first
    decode step's logits of every slot, within TP_BF16_LOGIT_TOL of the
    unsharded model's; the card's memory back after the engine and its
    shards go.  ``want``: the slice phase's tokens and times, printed
    beside this phase's (not gated).  ``readings``: the logits gate is
    left out, and the readings TP_BF16_LOGIT_TOL is set from are printed
    (_tp_logit_readings at the 1500-token prompt).  Returns the
    generation's launches."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.parallel import build_mesh  # noqa: PLC0415

    cfg = llama.CONFIGS["llama3-8b"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    t_phase = time.perf_counter()
    mesh = build_mesh(devices=[PARALLEL_CELLS] * 2, tp=2)
    engine = LLMEngine("llama3-8b", params=params, slots=8, max_seq=4096,
                       mesh=mesh)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t_phase
    wq, slab = engine.params["layers"]["wq"], engine.cache["k"]
    devices = {str(s.device) for leaf in _flat_tensors(engine.params)
               for s in leaf.shards}
    devices |= {str(s.device) for st in (slab, engine.cache["v"])
                for s in st.shards}
    layout = {"wq": [tuple(s.shape) for s in wq.shards],
              "slab": [tuple(s.shape) for s in slab.shards]}
    print(f"parallel tp engine: mesh {mesh.shape}, cells {mesh.size}, "
          f"is_virtual {mesh.is_virtual}, shards on {sorted(devices)}; "
          f"per cell wq {layout['wq']} (spec {tuple(wq.spec)}), slab "
          f"{layout['slab']} (spec {tuple(slab.spec)}); up in {up_s:.2f} "
          f"s; card free {torch.cuda.mem_get_info()[0] / 1e9:.2f} GB (was "
          f"{free_before / 1e9:.2f})", flush=True)
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    if not (mesh.is_virtual and devices == {PARALLEL_CELLS}
            and layout == {"wq": [(cfg.n_layers, cfg.dim,
                                   cfg.n_heads * hd // 2)] * 2,
                           "slab": [(cfg.n_layers, 8, 4096, kv // 2,
                                     hd)] * 2}):
        raise AssertionError(f"tp engine layout {layout} on {devices}")

    prompts = _slice_prompts(cfg)[0]
    kernel_buckets = sum(1 for p in prompts
                         if _bucket(len(p), engine.max_seq) >= 128)
    per_prefills = 2 * cfg.n_layers * kernel_buckets
    only_fwd = {"fwd": per_prefills, "fwd_sm90": per_prefills,
                "fwd_tf32x3": 0, "fwd_sm90_d256": 0, "dq": 0, "dkv": 0,
                "sm90": 0, "tf32x3": 0, "sm90_d256": 0, "tf32x3_d256": 0,
                "fwd_tf32x3_d256": 0}
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, SamplingParams(max_tokens=PARALLEL_TOKENS))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = _counts(fa)
    tokens = [o.token_ids for o in outs]

    got, ref, prefill_ms = [], [], {}
    with torch.inference_mode():
        _reset_counts(fa)
        padded = []
        for slot, p in enumerate(prompts):
            n, bucket = len(p), _bucket(len(p), engine.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            toks[0, :n] = torch.tensor(p, device="cuda")
            padded.append(toks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = llama.prefill_into_cache(engine.params, toks,
                                              engine.cache, slot, n, cfg)[0]
            torch.cuda.synchronize()
            prefill_ms[bucket] = round((time.perf_counter() - t0) * 1e3, 2)
            got.append(logits)
        prefill_launches = _counts(fa)
        ref_cache = llama.init_kv_cache(cfg, 8, 4096, device="cuda")
        for slot, (p, toks) in enumerate(zip(prompts, padded)):
            ref.append(llama.prefill_into_cache(params, toks, ref_cache,
                                                slot, len(p), cfg)[0])
        prefill_err = [_rel_l2(g, r) for g, r in zip(got, ref)]
        if readings:
            at = [len(p) for p in prompts].index(1500)
            print("parallel tp logit readings " + json.dumps(
                _tp_logit_readings(torch, llama, engine, params, padded[at],
                                   1500, cfg, ref[at])), flush=True)
        # The first decode step of every slot, from the same state: the
        # slots past the prompts start empty on both sides.
        engine.cache["length"][len(prompts):] = 0
        last = torch.zeros((8,), dtype=torch.int64, device="cuda")
        last[:len(prompts)] = torch.stack([r.argmax() for r in ref])
        tp_step = llama.decode_step(engine.params, last, engine.cache,
                                    cfg)[0]
        ref_step = llama.decode_step(params, last, ref_cache, cfg)[0]
        decode_err = [_rel_l2(a, b) for a, b in zip(tp_step, ref_step)]
        del ref_cache
        context = 1024

        def step():
            engine.cache["length"].fill_(context)
            llama.decode_step(engine.params, last, engine.cache, cfg)

        decode_ms = _median_ms(torch, step, reps=5)
    agree = ([_first_difference(t, w) for t, w in zip(tokens,
                                                       want["tokens"])]
             if want else None)
    print(f"parallel tp serving: {len(prompts)} greedy requests of "
          f"{[len(p) for p in prompts]} tokens in {gen_s:.2f} s, launches "
          f"{launches} (expected {per_prefills} sm90 forward); TP prefill "
          f"logits relative L2 error vs unsharded per prompt "
          f"{[f'{e:.3e}' for e in prefill_err]}, first decode step per "
          f"slot {[f'{e:.3e}' for e in decode_err]} (tol {TP_BF16_LOGIT_TOL}); "
          f"greedy {PARALLEL_TOKENS}-token prefix shared with the serving "
          f"slice {agree} (not gated)", flush=True)
    print("parallel tp timing: prefill ms per bucket " + json.dumps(
        prefill_ms) + f" (slice: {json.dumps(want['prefill_ms']) if want else None}); "
          f"decode {decode_ms:.2f} ms per step of 8 slots at context "
          f"{context} (slice: {want['decode_ms'] if want else None})",
          flush=True)
    del engine, wq, slab, got, ref, tp_step, ref_step
    back = _card_free_back(torch, free_before)
    print(f"parallel tp engine freed: card free "
          f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB (allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f}, reserved "
          f"{torch.cuda.memory_reserved() / 1e9:.2f}), back within "
          f"{CLUSTER_FREE_SLACK / 1e9:.2f} GB: {back}; the part took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if launches != only_fwd or prefill_launches != only_fwd:
        raise AssertionError(f"tp serving launched {launches} and "
                             f"{prefill_launches}, expected {only_fwd}")
    if not ((readings or (max(prefill_err) <= TP_BF16_LOGIT_TOL
                          and max(decode_err) <= TP_BF16_LOGIT_TOL))
            and back):
        raise AssertionError("tp serving logits or memory gate failed")
    return launches


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def parallel_train_phase(torch, fa, llama, cfg, params, tokens,
                         readings=False):
    """Sharded training on the train phase's llama-400m weights and its
    first PARALLEL_ROWS rows: one loss_fn(mesh=build_mesh(devices=
    ["cuda:0"] * 4, fsdp=2, tp=2), remat="none") step with its backward
    against the unsharded step (the loss within BF16_LOSS_TOL, every
    gradient leaf within BF16_GRAD_TOL over max |ref|, the sm90 forward,
    dQ and dK/dV each launched 4 cells x 24 layers times), the unsharded
    step with reference attention printed beside it; then, without
    gradients, the loss through ring attention at sp=2 and through
    loss_fn_pp at pp=2 with 2 microbatches, each within BF16_LOSS_TOL of
    the unsharded loss.  Then the C4 readings on the same weights
    (_tp_c4_check; ``readings``: printed, not gated).  Returns the
    sharded step's launches."""
    from ant_ray_tpu_torch.parallel import build_mesh, device_put  # noqa: PLC0415

    t_phase = time.perf_counter()
    batch = {"tokens": tokens[:PARALLEL_ROWS]}
    leaves = _tree_map(lambda p: p.detach().requires_grad_(), params)
    ref_loss = llama.loss_fn(leaves, batch, cfg, remat="none")
    ref_loss.backward()
    ref_grads = {}
    for name, leaf in _named_leaves(leaves):
        ref_grads[name], leaf.grad = leaf.grad, None
    # The unsharded model's own spread: reference attention (softmax in
    # fp32) in place of the kernels, printed beside the sharded errors.
    llama.loss_fn(leaves, batch, cfg, attn_impl="reference",
                  remat="none").backward()
    spread = {}
    for name, leaf in _named_leaves(leaves):
        spread[name], leaf.grad = _rel_err(leaf.grad, ref_grads[name]), None
    mesh = build_mesh(devices=[PARALLEL_CELLS] * 4, fsdp=2, tp=2)
    torch.cuda.synchronize()
    _reset_counts(fa)
    t0 = time.perf_counter()
    placed = device_put(leaves, llama.param_shardings(cfg, mesh))
    loss = llama.loss_fn(placed, batch, cfg, mesh=mesh, remat="none")
    loss.backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _counts(fa)
    err = {name: _rel_err(leaf.grad, ref_grads[name])
           for name, leaf in _named_leaves(leaves)}
    worst = max(err, key=err.get)
    cells = mesh.size * cfg.n_layers
    want = {"fwd": cells, "fwd_sm90": cells, "fwd_tf32x3": 0,
            "fwd_sm90_d256": 0, "dq": cells, "dkv": cells, "sm90": cells,
            "tf32x3": 0, "sm90_d256": 0, "tf32x3_d256": 0,
            "fwd_tf32x3_d256": 0}
    del placed, leaves, ref_grads
    with torch.no_grad():
        ring_mesh = build_mesh(devices=[PARALLEL_CELLS] * 2, sp=2)
        t0 = time.perf_counter()
        ring_loss = llama.loss_fn(params, batch, cfg, mesh=ring_mesh).item()
        ring_s = time.perf_counter() - t0
        pp_mesh = build_mesh(devices=[PARALLEL_CELLS] * 2, pp=2)
        t0 = time.perf_counter()
        pp_loss = llama.loss_fn_pp(params, batch, cfg, mesh=pp_mesh,
                                   num_microbatches=2).item()
        pp_s = time.perf_counter() - t0
    base = ref_loss.item()
    print(f"parallel train llama-400m {PARALLEL_ROWS} x "
          f"{batch['tokens'].shape[1] - 1} on mesh {mesh.shape} ({mesh.size} "
          f"cells of {PARALLEL_CELLS}): loss {loss.item():.6f}, unsharded "
          f"{base:.6f} (tol {BF16_LOSS_TOL}); max grad error over max |ref| "
          f"{err[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL}); step with "
          f"backward {step_s:.2f} s; launches {launches} (expected {want}); "
          f"ring sp=2 loss {ring_loss:.6f} in {ring_s:.2f} s; GPipe pp=2, "
          f"2 microbatches loss {pp_loss:.6f} in {pp_s:.2f} s; the part "
          f"took {time.perf_counter() - t_phase:.1f} s", flush=True)
    print("parallel train gradient errors per leaf, sharded and the "
          "unsharded model with reference attention " + json.dumps(
              {k: [err[k], spread[k]] for k in err}), flush=True)
    if not (abs(loss.item() - base) <= BF16_LOSS_TOL
            and err[worst] <= BF16_GRAD_TOL and launches == want
            and abs(ring_loss - base) <= BF16_LOSS_TOL
            and abs(pp_loss - base) <= BF16_LOSS_TOL):
        raise AssertionError("sharded training gate failed")
    _tp_c4_check(torch, llama, cfg, params, readings=readings)
    return launches


def parallel_phase(torch, llama, card, readings=False):
    """Both parts alone (tools/phase.py parallel): the 8B weights from
    seed 0 as the serving slice makes them, an unsharded engine's greedy
    tokens and times as the slice's stand-in, then llama-400m from seed 0
    and its batch as _llama_400m makes them.  ``readings``: as for
    parallel_serve_phase."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    engine = LLMEngine("llama3-8b", slots=8, max_seq=4096, seed=0)
    prompts = _slice_prompts(engine.config)[0]
    want = {"tokens": [o.token_ids for o in engine.generate(
        prompts, SamplingParams(max_tokens=PARALLEL_TOKENS))],
            "prefill_ms": None, "decode_ms": None}
    params = engine.params
    del engine
    launches = parallel_serve_phase(torch, fa, llama, params, want,
                                    readings=readings)
    del params
    torch.cuda.empty_cache()
    cfg, params, tokens = _llama_400m(torch, llama)
    train = parallel_train_phase(torch, fa, llama, cfg, params, tokens,
                                 readings=readings)
    return {k: launches[k] + train[k] for k in launches}


# Sessions phase: Llama-3-8B, 4 slots of 4096 positions, 512-token chunks.
FIRST_TURNS = (300, 560, 820, 1080, 1340, 1500)  # prompt tokens, turn 1
SECOND_TURN = 50                                  # prompt tokens, turns 2-3
SESSION_TOKENS = 8                                # new tokens per turn
FORCED_TURN = (400, 16)         # the force-evicted session: prompt, new
SESSION_DEADLINE_S = 300


def _restore_state(engine) -> str:
    """"fetch" while a restore fetch of ``engine`` runs, "pending" while
    a fetched slab waits for a slot, else "none"."""
    if any(not t["done"] for t in engine._restoring.values()):
        return "fetch"
    return "pending" if engine._restoring else "none"


def _drive(engine, deadline_s=SESSION_DEADLINE_S, after_step=None):
    """Step ``engine`` until it has nothing left; returns its outputs by
    request id.  Raises on a request that finished with an error and on
    a run past ``deadline_s``.  ``after_step(state)`` runs after each
    step, given the _restore_state when it began."""
    outs = {}
    deadline = time.monotonic() + deadline_s
    while engine.has_unfinished():
        inflight = _restore_state(engine)
        if inflight == "fetch" and not (engine._waiting or engine._active
                                        or engine._prefilling):
            time.sleep(0.001)     # only a fetch to wait for: no empty steps
            continue
        for out in engine.step():
            if out.finish_reason == "error":
                raise AssertionError(f"request {out.request_id} failed: "
                                     f"{out.error}")
            outs[out.request_id] = out
        if after_step is not None:
            after_step(inflight)
        if time.monotonic() > deadline:
            raise AssertionError(f"engine still busy after {deadline_s} s")
    return outs


def _first_difference(got, want):
    """Index of the first token where two streams differ."""
    got = got or []
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def _session_turn(engine, sid, prompt, sampling):
    rid = engine.add_request(prompt, sampling, admit=False, session_id=sid)
    return _drive(engine)[rid].token_ids


class _SlabLog:
    """Times and checks every slab that moves between the card and the
    host while installed: wraps ``llama.extract_slot`` and
    ``llama.install_slot``, the two functions the engine moves slabs
    with.  Each offload clones the slot on the card first and is timed
    alone (host clock; it returns once the bytes are on the host); each
    install is timed on the host and by CUDA events, then the slot is
    cloned on the card (two queued copies, inside the engine's
    restore_install phase).  The comparisons run in ``check()``, after
    the step: the host slab against the slot before its offload, and the
    slot after its install against the slot before that session's last
    offload, all with torch.equal."""

    def __init__(self, torch, llama, engine):
        self.torch, self.llama, self.engine = torch, llama, engine
        self.real = (llama.extract_slot, llama.install_slot)
        self.offload_ms, self.install_host_ms, self.install_ms = [], [], []
        self.pending = []
        self.before = {}          # session -> (k, v) on the host
        self.checked = {"offload": 0, "install": 0}
        self.clone_bytes = self.clone_peak = 0

    def __enter__(self):
        self.llama.extract_slot = self._extract
        self.llama.install_slot = self._install
        return self

    def __exit__(self, *exc):
        self.llama.extract_slot, self.llama.install_slot = self.real
        return False

    def _clone(self, cache, slot):
        pair = (cache["k"][:, slot].clone(), cache["v"][:, slot].clone())
        self.clone_bytes += 2 * pair[0].nbytes
        self.clone_peak = max(self.clone_peak, self.clone_bytes)
        return pair

    def _extract(self, cache, slot):
        torch = self.torch
        sid = next(s.session_id for s in self.engine._sessions.values()
                   if s.slot == slot)
        before = self._clone(cache, slot)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v, length = self.real[0](cache, slot)
        self.offload_ms.append((time.perf_counter() - t0) * 1e3)
        self.pending.append(("offload", sid, before, (k, v)))
        return k, v, length

    def _install(self, cache, k, v, length, slot):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = self.real[1](cache, k, v, length, slot)
        self.install_host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        self.pending.append(("install", slot, self._clone(cache, slot),
                             (start, end)))
        return out

    def check(self):
        torch = self.torch
        for kind, key, pair, extra in self.pending:
            host = tuple(x.cpu() for x in pair)
            self.clone_bytes -= 2 * pair[0].nbytes
            if kind == "offload":
                if not all(torch.equal(a, b) for a, b in zip(host, extra)):
                    raise AssertionError(f"offload of session {key}: the "
                                         "host slab differs from the slot")
                self.before[key] = host
            else:
                sid = next(s.session_id
                           for s in self.engine._sessions.values()
                           if s.slot == key)
                if not all(torch.equal(a, b)
                           for a, b in zip(host, self.before[sid])):
                    raise AssertionError(f"restore of session {sid}: the "
                                         "slot differs from the slot "
                                         "before its offload")
                self.install_ms.append(extra[0].elapsed_time(extra[1]))
            self.checked[kind] += 1
        self.pending = []


def sessions_phase(torch, fa, llama, params):
    """Sessions on Llama-3-8B: six greedy conversations of two turns on
    4 slots, so that admission evicts idle sessions to host memory
    (all but the latest spilled to disk) and their next turns restore
    them; a seventh,
    sampled, session evicted by force mid-generation; and a restore held
    in flight while an unrelated request runs start to finish.  Every
    turn's tokens must equal an engine of the same shape where each
    session runs alone and nothing is evicted, and every slab must come
    back bit for bit.  Returns the launches (none: chunked prefill and
    decode run no flash kernel)."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import StepProfiler  # noqa: PLC0415

    class HeldStore(LocalKvStore):
        """A store whose get() waits while ``release`` is clear, and
        which times the puts that spill a slab and the gets that read
        one back from its file."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.release = threading.Event()
            self.release.set()
            self.spill_ms, self.unspill_ms = [], []

        def put(self, key, slab):
            spills, t0 = self.spills, time.perf_counter()
            out = super().put(key, slab)
            if self.spills > spills:
                self.spill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def get(self, handle):
            if not self.release.wait(SESSION_DEADLINE_S):
                raise TimeoutError("restore never released")
            spilled, t0 = handle not in self._mem, time.perf_counter()
            out = super().get(handle)
            if spilled:
                self.unspill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(5)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    first = {f"s{i}": tokens(n) for i, n in enumerate(FIRST_TURNS)}
    second = {sid: tokens(SECOND_TURN) for sid in first}
    third = tokens(SECOND_TURN)                 # s0's held turn
    forced_prompt = tokens(FORCED_TURN[0])
    other_prompt = tokens(200)                  # runs under the held restore
    greedy = SamplingParams(max_tokens=SESSION_TOKENS)
    sampled = SamplingParams(max_tokens=FORCED_TURN[1], temperature=0.8,
                             top_k=50, top_p=0.95, seed=77)

    def engine(**kw):
        return LLMEngine(cfg, params, slots=4, max_seq=4096,
                         prefill_chunk_tokens=512, **kw)

    _reset_counts(fa)
    # The uninterrupted run: each session alone, its turns back to back,
    # then ended, so nothing is ever evicted.
    t0 = time.perf_counter()
    base = engine()
    want = {}
    for sid in first:
        want[sid, 1] = _session_turn(base, sid, first[sid], greedy)
        want[sid, 2] = _session_turn(base, sid, second[sid], greedy)
        if sid == "s0":
            want[sid, 3] = _session_turn(base, sid, third, greedy)
        base.end_session(sid)
    want["forced", 1] = _session_turn(base, "forced", forced_prompt,
                                      sampled)
    want["other", 1] = base.generate([other_prompt], greedy)[0].token_ids
    if base.stats["offloads"]:
        raise AssertionError("the uninterrupted run evicted a session")
    base_s = time.perf_counter() - t0
    del base
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as spill:
        store = HeldStore(spill_dir=spill, capacity_slabs=1)
        prof = StepProfiler(history=4096)
        eng = engine(kv_offload_store=store, profiler=prof)
        # Per step: the _restore_state when it began ("held" while the
        # held store keeps a fetch waiting); its profiler record; the
        # offloads so far.
        steps = []
        torch.cuda.reset_peak_memory_stats()
        with _SlabLog(torch, llama, eng) as log:
            def after_step(state):
                log.check()
                steps.append((state, prof.last, len(log.offload_ms)))

            t0 = time.perf_counter()
            got = {}
            for turn, prompts in ((1, first), (2, second)):
                rids = {eng.add_request(p, greedy, admit=False,
                                        session_id=sid): sid
                        for sid, p in prompts.items()}
                outs = _drive(eng, after_step=after_step)
                got.update({(sid, turn): outs[rid].token_ids
                            for rid, sid in rids.items()})
            pressure = eng.stats["pressure_evictions"]
            restores = eng.stats["restores"]

            # Forced eviction mid-generation, sampled.
            rid = eng.add_request(forced_prompt, sampled, admit=False,
                                  session_id="forced")
            seq = None
            while seq is None or len(seq.generated) < 4:
                eng.step()
                log.check()
                seq = next((s for s in eng._active.values()
                            if s.request_id == rid), None)
            if not eng.evict_session("forced", force=True):
                raise AssertionError("forced eviction refused")
            log.check()
            got["forced", 1] = _drive(eng, after_step=after_step)[
                rid].token_ids
            forced_restores = eng.stats["restores"] - restores

            # A restore held in flight while another request runs.
            if eng._sessions["s0"].state == "resident":
                eng.evict_session("s0")
                log.check()
            store.release.clear()
            rid = eng.add_request(third, greedy, admit=False,
                                  session_id="s0")
            other = eng.add_request(other_prompt, greedy, admit=False)
            held_restores = eng.stats["restores"]
            outs = {}
            deadline = time.monotonic() + SESSION_DEADLINE_S
            while other not in outs:
                state = "held" if _restore_state(eng) == "fetch" else "none"
                outs.update({o.request_id: o for o in eng.step()})
                after_step(state)
                if time.monotonic() > deadline:
                    raise AssertionError("request under the held restore "
                                         "never finished")
            held_ok = (eng.stats["restores"] == held_restores
                       and eng._sessions["s0"].state == "restoring")
            store.release.set()
            outs.update(_drive(eng, after_step=after_step))
            got["s0", 3] = outs[rid].token_ids
            got["other", 1] = outs[other].token_ids
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        slab_bytes = 2 * eng.cache["k"][:, 0].numel() * 2
    launches = _counts(fa)

    stats = eng.stats
    print(f"sessions llama3-8b slots 4 max_seq 4096 chunk 512: slab "
          f"{slab_bytes} B; first turns {list(FIRST_TURNS)} tokens, second "
          f"{SECOND_TURN}, {SESSION_TOKENS} new each; uninterrupted run "
          f"{base_s:.1f} s, this run {run_s:.1f} s; stats "
          + json.dumps(stats), flush=True)
    mismatched = {str(key): _first_difference(got.get(key), want[key])
                  for key in want if got.get(key) != want[key]}
    # Host ms of steps that only decode and offload nothing, by whether
    # a restore fetch was in flight; of steps that install a slab and
    # otherwise only decode; and the decode phase of every step, by
    # whether a fetch was in flight.
    decode_ms = {state: [] for state in ("none", "fetch", "pending", "held")}
    phase_ms = {state: [] for state in decode_ms}
    installs, quiet_installs = [], []
    offloads_before = 0
    for state, rec, offloads in steps:
        ran = set(rec.phases) - {"compute"}
        offloaded = offloads != offloads_before
        offloads_before = offloads
        if "decode" in ran:
            phase_ms[state].append(rec.phases["decode"] * 1e3)
        if "restore_install" in ran:
            installs.append(rec)
            if ran == {"restore_install", "decode"} and not offloaded:
                quiet_installs.append(rec.total_s * 1e3)
        elif ran == {"decode"} and not offloaded:
            decode_ms[state].append(rec.total_s * 1e3)
    plain = decode_ms["none"]

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    gbps = [slab_bytes / (ms * 1e6) for ms in log.offload_ms]
    print(f"offload: {len(log.offload_ms)} slabs, median "
          f"{med(log.offload_ms):.2f} ms = {med(gbps):.2f} GB/s (host clock, "
          f"into pinned memory; all "
          f"{[round(x, 2) for x in log.offload_ms]}); store spills "
          f"{store.spills}", flush=True)
    print(f"install: {len(log.install_ms)} slabs, median device "
          f"{med(log.install_ms):.2f} ms = "
          f"{slab_bytes / (med(log.install_ms) * 1e6):.2f} GB/s, host call "
          f"{med(log.install_host_ms):.3f} ms (all "
          f"{[round(x, 3) for x in log.install_host_ms]}); steps that "
          f"install {[round(r.total_s * 1e3, 1) for r in installs]} ms "
          f"(restore_install phase "
          f"{[round(r.phases['restore_install'] * 1e3, 3) for r in installs]}"
          f" ms), of them install and decode only {quiet_installs} ms, "
          f"against plain decode steps {med(plain):.2f} ms ({len(plain)} "
          f"steps)", flush=True)
    print("restore in flight: decode-only steps (median ms, count) "
          + json.dumps({k: [med(v), len(v)] for k, v in decode_ms.items()})
          + "; decode phase of every step "
          + json.dumps({k: [med(v), len(v)] for k, v in phase_ms.items()})
          + f" (none: no restore; fetch: a fetch running; pending: a "
          f"fetched slab waiting for a slot; held: the held fetch); spills "
          f"{[round(x, 1) for x in store.spill_ms]} ms on the step thread, "
          f"reads of spilled slabs {[round(x, 1) for x in store.unspill_ms]}"
          f" ms on the fetch thread; restore_wait_s "
          f"{stats['restore_wait_s']:.3f}; peak memory {peak_gb:.2f} GB "
          f"(of it at most {log.clone_peak / 1e9:.2f} GB of the check's "
          f"clones)", flush=True)
    print("profiler summary " + json.dumps(prof.summary()), flush=True)
    print(f"sessions gates: mismatched turns (first differing token) "
          f"{mismatched} of {len(want)}; "
          f"slabs checked {log.checked}; pressure evictions {pressure} and "
          f"restores {restores} in turns 1-2, forced restores "
          f"{forced_restores}, held restore pending while the other request "
          f"ran {held_ok}; launches {launches}", flush=True)
    if mismatched:
        raise AssertionError(f"turns {sorted(mismatched)} differ from the "
                             "uninterrupted run")
    if not (log.checked["offload"] == stats["offloads"] > 0
            and log.checked["install"] == stats["restores"] > 0):
        raise AssertionError(f"slab checks {log.checked} do not cover "
                             f"{stats['offloads']} offloads and "
                             f"{stats['restores']} restores")
    if not (pressure >= 2 and restores >= 2 and forced_restores == 1
            and held_ok and stats["restore_failures"] == 0
            and store.unspill_ms):
        raise AssertionError("the sessions run did not exercise pressure "
                             "eviction, restores, a forced eviction, a held "
                             "restore and a restore from a spill file as it "
                             "must")
    if any(launches.values()):
        raise AssertionError(f"the sessions path launched {launches}, "
                             "expected no flash kernel")
    return launches


def loop_phase(torch, fa, llama, params):
    """EngineLoop on Llama-3-8B: four client threads submit eight
    requests, half of them in sessions; every handle must finish without
    error within its timeout, streaming exactly its final tokens; then
    one session is evicted and every session ended through the loop."""
    from ant_ray_tpu_torch.llm import EngineLoop, LLMEngine, SamplingParams  # noqa: PLC0415

    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(9)
    lengths = (120, 480, 250, 600, 90, 360, 530, 200)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    greedy = SamplingParams(max_tokens=SESSION_TOKENS)
    sids = {j: f"loop-{j}" for j in range(len(prompts)) if j % 2}
    engine = LLMEngine(cfg, params, slots=4, max_seq=4096,
                       prefill_chunk_tokens=512)
    _reset_counts(fa)
    loop = EngineLoop(engine, metrics_interval_s=0.5)
    handles, errors = {}, []
    try:
        def client(c):
            try:
                for j in (2 * c, 2 * c + 1):
                    handles[j] = loop.submit(prompts[j], greedy,
                                             session_id=sids.get(j))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors or len(handles) != len(prompts):
            raise AssertionError(f"submission failed: {errors}")
        outs = {j: handles[j].wait(timeout=120) for j in sorted(handles)}
        wall_s = time.perf_counter() - t0
        for j, h in sorted(handles.items()):
            streamed = [e["token_id"] for e in h if e["type"] == "token"]
            if streamed != outs[j].token_ids or not outs[j].token_ids:
                raise AssertionError(f"request {j} streamed {streamed}, "
                                     f"returned {outs[j].token_ids}")
        # A second turn for one session, evicted through the loop after.
        again = loop.submit(prompts[0][:SECOND_TURN], greedy,
                            session_id=sids[1])
        again.wait(timeout=120)
        stats = loop.stats()
        evicted = loop.evict_session(sids[1])
        ended = [loop.end_session(sid) for sid in sids.values()]
    finally:
        loop.shutdown(timeout=30)
    launches = _counts(fa)
    ttft = {j: round(h.ttft_s() * 1e3, 1) for j, h in sorted(handles.items())}
    print(f"loop llama3-8b slots 4: {len(outs)} requests from 4 threads in "
          f"{wall_s:.2f} s; TTFT ms by request (prompt tokens "
          f"{list(lengths)}) {ttft}; evicted {evicted}, ended {ended}; "
          f"stats {json.dumps(stats)}; engine stats "
          f"{json.dumps(engine.stats)}; launches {launches}", flush=True)
    if loop._thread.is_alive():
        raise AssertionError("the loop thread did not stop")
    if not (evicted and all(ended) and engine.resident_sessions() == 0):
        raise AssertionError("evict_session / end_session through the loop "
                             "failed")
    if any(launches.values()):
        raise AssertionError(f"the loop path launched {launches}, expected "
                             "no flash kernel")
    return launches


# Runtime phase: Llama-3-8B behind a local-mode actor.
RUNTIME_PROMPTS = (20, 1500)    # prompt tokens
RUNTIME_TOKENS = 32             # new tokens per prompt
RUNTIME_NOOP_CALLS = 1000       # calls of each kind in the overhead probe
                                # (2000 until the parallel phase came)


class _Echo:
    def ping(self, x):
        return x


def _echo(x):
    return x


def runtime_overhead(art, calls=RUNTIME_NOOP_CALLS):
    """The runtime's own cost per call in local mode: a no-op actor
    method and a no-op task through ``.remote()`` + ``get``, beside the
    same method and function called directly, in turns, one call at a
    time; medians in microseconds on the host's clock."""
    actor, task, plain = art.remote(_Echo).remote(), art.remote(_echo), _Echo()
    kinds = {"actor_call": lambda i: art.get(actor.ping.remote(i)),
             "direct_method": plain.ping,
             "task": lambda i: art.get(task.remote(i)),
             "direct_fn": _echo}
    times = {k: [] for k in kinds}
    for i in range(calls):
        for kind, fn in kinds.items():
            t0 = time.perf_counter_ns()
            out = fn(i)
            times[kind].append(time.perf_counter_ns() - t0)
            if out != i:
                raise AssertionError(f"{kind} returned {out!r} for {i}")
    us = {f"{k}_us": statistics.median(v) / 1e3 for k, v in times.items()}
    us["actor_overhead_us"] = us["actor_call_us"] - us["direct_method_us"]
    us["task_overhead_us"] = us["task_us"] - us["direct_fn_us"]
    return {"calls": calls, **us}


def runtime_phase(torch, fa, llama, params):
    """The runtime in local mode on the card: an actor holding an
    LLMEngine("llama3-8b") on the given weights answers two greedy
    prompts, whose tokens must equal the same engine's called directly
    (after a direct warm-up round); a task returns a CUDA tensor,
    put/get carry one, wait splits the actor's refs, and no-op calls
    measure the runtime's own cost per call.  Returns the engine, whose
    cache the objects phase ships."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415

    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in RUNTIME_PROMPTS]
    greedy = SamplingParams(max_tokens=RUNTIME_TOKENS)

    @art.remote
    class EngineActor:
        def __init__(self, engine):
            self.engine = engine

        def generate(self, prompt):
            return self.engine.generate([prompt], greedy)[0].token_ids

    @art.remote
    def random_tensor(seed, n):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn((n, n), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    direct = LLMEngine("llama3-8b", params, slots=2, max_seq=4096, seed=0)
    ctx = art.init(local_mode=True)
    try:
        # Local mode hands the actor its argument as it is: the actor
        # holds this very engine, so the gate compares the runtime's
        # call path with the direct one on the same weights and cache.
        actor, actor_s = timed(lambda: EngineActor.remote(direct))
        calls, refs = [], []
        # Round 0 warms the engine up (a bucket's first prefill in a
        # process loads its kernels); round 1 is the one counted.
        for round_, order in ((0, ("direct",)), (1, ("actor", "direct"))):
            if round_:
                _reset_counts(fa)
            for n, prompt in zip(RUNTIME_PROMPTS, prompts):
                walls, tokens = {}, {}
                for who in order:
                    if who == "direct":
                        got, walls[who] = timed(lambda: direct.generate(
                            [prompt], greedy)[0].token_ids)
                    else:
                        (ref, got), walls[who] = timed(
                            lambda: (lambda r: (r, art.get(r)))(
                                actor.generate.remote(prompt)))
                        refs.append(ref)
                    tokens[who] = got
                if round_:
                    calls.append({"prompt": n, "bucket": _bucket(n, 4096),
                                  "tokens": len(tokens["direct"]),
                                  "equal": tokens["actor"] == tokens["direct"],
                                  "direct_s": round(walls["direct"], 4),
                                  "actor_s": round(walls["actor"], 4)})
        launches = _counts(fa)
        (ready, not_ready), wait_s = timed(
            lambda: art.wait(refs, num_returns=len(refs), timeout=60))
        task_out, task_s = timed(lambda: art.get(random_tensor.remote(7, 1024)))
        gen = torch.Generator(device="cuda").manual_seed(7)
        task_want = torch.randn((1024, 1024), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
        x = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
        x_out, put_get_s = timed(lambda: art.get(art.put(x)))
        tensors_ok = all(t.device.type == "cuda" and torch.equal(t, w)
                         for t, w in ((task_out, task_want), (x_out, x)))
        overhead = runtime_overhead(art)
    finally:
        art.shutdown()
    kernel_prefills = sum(_bucket(n, 4096) >= 128 for n in RUNTIME_PROMPTS)
    expected = 2 * cfg.n_layers * kernel_prefills    # round 1's two calls
    print("runtime " + json.dumps({
        "mode": ctx.mode, "model": "llama3-8b", "actor_init_s":
        round(actor_s, 6), "calls": calls, "overhead": overhead, "wait": {
            "ready": len(ready), "not_ready": len(not_ready),
            "s": round(wait_s, 6)},
        "task_cuda_tensor_s": round(task_s, 6),
        "put_get_cuda_tensor_s": round(put_get_s, 6),
        "tensors_on_cuda_bitwise": tensors_ok, "launches": launches,
        "expected_sm90_fwd": expected}), flush=True)
    if not all(c["equal"] and c["tokens"] == RUNTIME_TOKENS for c in calls):
        raise AssertionError("the actor's tokens differ from the engine's")
    if (len(ready), len(not_ready)) != (len(refs), 0) or not tensors_ok:
        raise AssertionError("wait, a task's tensor or put/get failed")
    if launches != {"fwd": expected, "fwd_sm90": expected, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0,
                    "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}:
        raise AssertionError(f"the runtime path launched {launches}, "
                             f"expected {expected} sm90 forward launches")
    return direct


# Cluster phase: the runtime's processes on the card.
# The operator's processes (the dashboard, a node agent per node) start
# with every cluster by default, as in the JAX package; the cluster
# phases before the operations phase turn both off, so that their
# process, card-memory and timing gates see only the runtime's own.
QUIET = {"include_dashboard": False, "enable_node_agent": False}
CLUSTER_SLAB_REPS = 3           # warm round trips of the slab after the first
CLUSTER_FREE_SLACK = 1 << 30    # card memory a killed actor may leave behind
CLUSTER_FREE_WAIT_S = 30.0      # ... within this long
CLUSTER_EXIT_WAIT_S = 10.0      # every process of the session gone within
CLUSTER_GCS_STANDBYS = 1        # warm standby GCS replicas beside the leader
CLUSTER_GCS_WAIT_S = 30.0       # for a GCS leader after a kill
CLUSTER_GCS_STEP_S = 20.0       # the GCS step's budget, restart and failover
CLUSTER_DAG_NOOP_CALLS = 200    # no-op round trips, compiled and .remote()
CLUSTER_DAG_BUFFER = 1 << 20    # bytes a DAG channel holds: the 8B logits


def _leaf_checksums(torch, params):
    """Checksums of three leaves of a Llama's weights (the embedding,
    layer 0's wq, the head): sums of their bits as int64, on the card."""
    head = params.get("lm_head", params["embed"])
    return [int(t.contiguous().view(torch.int16).to(torch.int64).sum())
            for t in (params["embed"], params["layers"]["wq"][0], head)]


def _slab_checksum(torch, slab):
    return [int(t.contiguous().view(torch.int16).to(torch.int64).sum())
            for t in (slab["k"], slab["v"])]


def _pid_alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _child_pids(pid):
    out = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(entry))
        except (OSError, IndexError, ValueError):
            continue
    return out


def _print_worker_logs(session_dir, tail=4000):
    logs = os.path.join(session_dir, "logs")
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        with open(os.path.join(logs, name), "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - tail))
            text = f.read().decode(errors="replace")
        print(f"--- {name} (last {tail} bytes) ---\n{text}", flush=True)


def _gcs_step(art, cluster, runtime, actor, prompt, want, n_layers):
    """The cluster's GCS is lost twice while the 8B actor lives: its
    leader is killed and restarted on its port as a new replica (a
    standby takes the lease meanwhile), then the leader of that set is
    killed and the restarted replica takes over.  After each, the actor
    answers ``prompt`` with ``want``'s tokens, in the same process, and
    launches the sm90 forward for each layer of the bucketed prefill;
    after the failover a ``num_gpus=0`` task runs and a KV key written
    before the first kill reads back through the driver's router.
    Returns the step's record; raises if a gate fails."""
    gcs = runtime._gcs

    def view(leader):
        """The leader's own HA view (a standby's trails it by a sync)."""
        v = cluster._pool.get(leader).call("GetHaView", {}, timeout=30)
        return {k: v[k] for k in ("leader", "term", "last_failover_ts")} | {
            "replicas": [(r["replica_id"], r["role"]) for r in v["replicas"]]}

    def answer():
        tokens, counted = art.get(actor.counted.remote(prompt), timeout=300)
        return {"equal": tokens == want, "tokens": len(tokens),
                "worker_launches": counted}

    @art.remote(num_gpus=0)
    def after_failover():
        return os.getpid()

    out = {"pid_before": art.get(actor.pid.remote(), timeout=60)}
    t_step = time.perf_counter()
    gcs.call("KVPut", {"key": "chip_smoke_gcs", "value": b"kept"},
             timeout=30, retries=3)
    leader = cluster.gcs_leader_address(timeout=CLUSTER_GCS_WAIT_S)
    if leader != cluster.address.split(",")[0]:
        raise AssertionError(f"the first replica does not lead: {leader}")
    out["before"] = view(leader)

    # Restart: the leader killed and started again on its port.
    t0 = time.perf_counter()
    cluster.kill_gcs()
    cluster.restart_gcs()
    out["restart_process_s"] = round(time.perf_counter() - t0, 3)
    out["restart"] = answer()
    out["restart_to_answer_s"] = round(time.perf_counter() - t0, 3)
    leader = cluster.gcs_leader_address(timeout=CLUSTER_GCS_WAIT_S)
    out["restart_to_leader_s"] = round(time.perf_counter() - t0, 3)
    out["after_restart"] = view(leader)

    # Failover: the leader killed for good; the restarted replica leads.
    t0 = time.perf_counter()
    out["killed_leader"] = cluster.kill_gcs_leader()
    out["failover"] = answer()
    out["failover_to_answer_s"] = round(time.perf_counter() - t0, 3)
    out["new_leader"] = cluster.gcs_leader_address(
        timeout=CLUSTER_GCS_WAIT_S)
    out["failover_to_leader_s"] = round(time.perf_counter() - t0, 3)
    out["task_pid"] = art.get(after_failover.remote(), timeout=120)
    out["failover_to_task_s"] = round(time.perf_counter() - t0, 3)
    kept = gcs.call("KVGet", {"key": "chip_smoke_gcs"}, timeout=30,
                    retries=3)
    out["kv_after_failover"] = repr(kept)
    out["failover_to_kv_s"] = round(time.perf_counter() - t0, 3)
    out["after_failover"] = view(out["new_leader"])
    out["pid_after"] = art.get(actor.pid.remote(), timeout=60)
    out["step_s"] = round(time.perf_counter() - t_step, 3)
    print("cluster gcs " + json.dumps(out, default=str), flush=True)

    row1 = {"fwd": n_layers, "fwd_sm90": n_layers}
    for name in ("restart", "failover"):
        got = out[name]
        if not got["equal"]:
            raise AssertionError(f"the actor's tokens after the GCS "
                                 f"{name} differ from the engine's")
        launched = got["worker_launches"]
        if launched != {**dict.fromkeys(launched, 0), **row1}:
            raise AssertionError(
                f"the worker launched {launched} after the GCS {name}, "
                f"expected {n_layers} sm90 forward launches")
    if out["pid_after"] != out["pid_before"]:
        raise AssertionError("the actor's process changed across the GCS "
                             "restart and failover")
    term = out["after_restart"]["term"]
    if out["after_failover"]["term"] != term + 1 or \
            out["after_failover"]["leader"] != out["new_leader"] or \
            out["new_leader"] == out["killed_leader"] or \
            out["after_failover"]["last_failover_ts"] is None:
        raise AssertionError(f"the failover's HA view is wrong: "
                             f"{out['after_restart']} then "
                             f"{out['after_failover']}")
    if kept != b"kept":
        raise AssertionError("the KV key did not survive the failover")
    if out["step_s"] > CLUSTER_GCS_STEP_S:
        raise AssertionError(f"the GCS step took {out['step_s']} s, over "
                             f"its {CLUSTER_GCS_STEP_S} s")
    return out


def _dag_step(torch, art, actor, prompts, want, n_layers):
    """Compiled DAGs over the cluster's live 8B actor (shared-memory
    channels, per-actor execution loops): ``actor.counted`` answers both
    prompts with the engine's tokens (``want``), launching the sm90
    forward for each layer of the bucketed prefill and nothing else;
    ``actor.last_logits`` takes the longer prompt as a CUDA tensor
    through the input channel and returns its fp32 CUDA logits, bitwise
    equal to the same call through the object plane, with the engine's
    first token as their argmax; a no-op stage on a CPU actor times the
    channels' round trip beside ``.remote()``.  Each DAG is torn down,
    its loop reports its iterations, and no channel file is left; the
    actor then answers ``generate`` in the same process.  Returns the
    step's record and the launches counted in the actor's process;
    raises if a gate fails."""
    from ant_ray_tpu_torch.dag import InputNode  # noqa: PLC0415
    from ant_ray_tpu_torch.dag.compiled import ChannelCompiledDAG  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415

    def compile_on(method, **kwargs):
        with InputNode() as inp:
            dag = method.bind(inp)
        compiled = dag.experimental_compile(**kwargs)
        if not isinstance(compiled, ChannelCompiledDAG):
            raise AssertionError(f"{method._method_name} compiled to "
                                 f"{type(compiled).__name__}, not the "
                                 "channel path")
        paths.extend(spec.path for spec in compiled._channel_specs.values())
        return compiled

    def teardown(compiled):
        compiled.teardown()
        return [loop["iterations"] for loop in
                art.get(compiled._loop_refs, timeout=60)]

    paths = []
    out = {"pid_before": art.get(actor.pid.remote(), timeout=60)}
    t_step = time.perf_counter()

    # 1. Tokens and launches through the channels.
    compiled = compile_on(actor.counted)
    calls, launches = [], {}
    for prompt, tokens_want in zip(prompts, want):
        t0 = time.perf_counter()
        tokens, counted = compiled.execute(prompt).get(timeout=300)
        calls.append({"prompt": len(prompt), "equal": tokens == tokens_want,
                      "worker_launches": counted,
                      "s": round(time.perf_counter() - t0, 3)})
        launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
    out["tokens"] = calls
    out["tokens_iterations"] = teardown(compiled)

    # 2. CUDA tensors both ways: the prompt in, the logits out.
    ids = torch.tensor(prompts[-1], dtype=torch.int64, device="cuda")
    art.get(actor.take_launches.remote(), timeout=60)    # from zero
    compiled = compile_on(actor.last_logits,
                          buffer_size_bytes=CLUSTER_DAG_BUFFER)
    t0 = time.perf_counter()
    through_dag = compiled.execute(ids).get(timeout=300)
    out["logits_dag_s"] = round(time.perf_counter() - t0, 3)
    out["logits_iterations"] = teardown(compiled)
    t0 = time.perf_counter()
    through_objects = art.get(actor.last_logits.remote(ids), timeout=300)
    out["logits_object_plane_s"] = round(time.perf_counter() - t0, 3)
    counted = art.get(actor.take_launches.remote(), timeout=60)
    launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
    out["logits"] = {
        "device": through_dag.device.type, "dtype": str(through_dag.dtype),
        "shape": list(through_dag.shape),
        "bitwise": bool(through_dag.device == through_objects.device
                        and torch.equal(through_dag, through_objects)),
        "argmax": int(through_dag.argmax()), "first_token": want[-1][0],
        "worker_launches": counted}

    # 3. The channels' round trip: a no-op stage on a CPU actor, beside
    #    the same actor's .remote() call (both medians of the host clock).
    echo = art.remote(_Echo).remote()
    remote_ns = []
    for i in range(1 + CLUSTER_DAG_NOOP_CALLS):
        t0 = time.perf_counter_ns()
        art.get(echo.ping.remote(i))
        remote_ns.append(time.perf_counter_ns() - t0)
    compiled = compile_on(echo.ping)
    compiled_ns = []
    for i in range(1 + CLUSTER_DAG_NOOP_CALLS):
        t0 = time.perf_counter_ns()
        if compiled.execute(i).get(timeout=60) != i:
            raise AssertionError("the no-op stage returned another value")
        compiled_ns.append(time.perf_counter_ns() - t0)
    noop_iterations = teardown(compiled)
    art.kill(echo)
    out["noop"] = {"calls": CLUSTER_DAG_NOOP_CALLS,
                   "compiled_us": statistics.median(compiled_ns[1:]) / 1e3,
                   "remote_us": statistics.median(remote_ns[1:]) / 1e3,
                   "iterations": noop_iterations}

    # 4. After teardown: the actor answers in the same process.
    t0 = time.perf_counter()
    after = art.get(actor.generate.remote(prompts[0]), timeout=300)
    out["after_teardown"] = {"equal": after == want[0],
                             "s": round(time.perf_counter() - t0, 3)}
    out["pid_after"] = art.get(actor.pid.remote(), timeout=60)
    out["channel_files"] = len(paths)
    out["channels_left"] = [p for p in paths if os.path.exists(p)]
    out["step_s"] = round(time.perf_counter() - t_step, 3)
    out["launches"] = launches
    print("cluster dag " + json.dumps(out, default=str), flush=True)

    none = dict.fromkeys(launches, 0)
    row1 = {"fwd": n_layers, "fwd_sm90": n_layers}
    for call, prompt in zip(calls, prompts):
        if not call["equal"]:
            raise AssertionError(f"the DAG's tokens for the {len(prompt)}-"
                                 "token prompt differ from the engine's")
        bucketed = _bucket(len(prompt), 4096) >= 128
        if call["worker_launches"] != {**none, **(row1 if bucketed else {})}:
            raise AssertionError(
                f"the DAG's stage launched {call['worker_launches']} for "
                f"the {len(prompt)}-token prompt")
    if out["tokens_iterations"] != [len(prompts)] or \
            out["logits_iterations"] != [1] or \
            noop_iterations != [1 + CLUSTER_DAG_NOOP_CALLS]:
        raise AssertionError(f"the exec loops' iterations differ from the "
                             f"executes: {out}")
    got = out["logits"]
    if got["device"] != "cuda" or got["dtype"] != "torch.float32" or \
            not got["bitwise"] or got["argmax"] != got["first_token"]:
        raise AssertionError(f"the DAG's logits are wrong: {got}")
    if counted != {**none, "fwd": 2 * n_layers, "fwd_sm90": 2 * n_layers}:
        raise AssertionError(f"last_logits launched {counted}, expected "
                             f"{n_layers} sm90 forward launches a call")
    if not out["after_teardown"]["equal"] or \
            out["pid_after"] != out["pid_before"]:
        raise AssertionError(f"the actor after teardown: {out}")
    if out["channels_left"]:
        raise AssertionError(f"channel files left: {out['channels_left']}")
    return out, launches


# The cluster phase's placement and device-object steps.
HANDOFF_PROMPT = 1500           # prompt tokens: one of RUNTIME_PROMPTS
HANDOFF_SLOT = 1                # the free slot of both engines the slab uses
HANDOFF_TOKENS = 32             # greedy tokens decoded from it on each side
HANDOFF_FREE_WAIT_S = 5.0       # the holder's device store empty within
SLICE_READY_S = 30.0            # a one-card slice group ready within
DRAIN_WAIT_S = 5.0              # the node draining within, after a notice
DRAIN_REASON = "chip_smoke maintenance"


def _greedy_from_slot(torch, llama, params, cache, slot, first, n, cfg):
    """``n`` greedy tokens decoded from ``slot`` of ``cache``, fed
    ``first`` first; the other slots neither write nor advance.  Returns
    the tokens and the cache, whose slot is then given back (length 0)."""
    slots = cache["k"].shape[1]
    dev = cache["length"].device
    with torch.inference_mode():
        active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        active[slot] = True
        last = torch.zeros((slots,), dtype=torch.int64, device=dev)
        tokens, tok = [], int(first)
        for _ in range(n):
            last[slot].fill_(tok)
            logits, cache = llama.decode_step(params, last, cache, cfg,
                                              active=active)
            tok = int(logits[slot].argmax())
            tokens.append(tok)
        cache["length"][slot].fill_(0)
    return tokens, cache


def _node_gates(art, torch):
    """The node's detected GPU labels and its slice-head resource, beside
    the driver's own detection (same host) and its source."""
    from ant_ray_tpu_torch._private.accelerators import gpu  # noqa: PLC0415

    node = art.nodes()[0]
    labels = {k: v for k, v in (node["Labels"] or {}).items()
              if k.startswith("gpu-")}
    pod_type = f"h100-{torch.cuda.device_count()}"
    head = f"GPU-{pod_type}-head"
    out = {"labels": labels, "detected": gpu.detect_generation(),
           "source": gpu.generation_source(),
           "head_resource": art.cluster_resources().get(head)}
    print("cluster placement node " + json.dumps(out), flush=True)
    if not (labels.get("gpu-generation") == "h100"
            and labels.get("gpu-pod-type") == pod_type
            and labels.get("gpu-worker-id") == "0"
            and out["head_resource"] == 1.0):
        raise AssertionError(f"the node's GPU labels or {head}: {out}")
    return out


def _slice_step(art, node_gates):
    """A one-card slice group of the detected H100: ready within
    SLICE_READY_S on this node, one bundle of the card and the slice's
    head; a num_gpus=1 task runs on bundle 0; once the group is removed
    the head resource comes back."""
    from ant_ray_tpu_torch.util.gpu import slice_placement_group  # noqa: PLC0415

    node = art.nodes()[0]
    head = f"GPU-{node_gates['labels']['gpu-pod-type']}-head"

    @art.remote(num_gpus=1, num_cpus=0)    # the bundle holds no CPU
    def on_bundle():
        return os.environ.get("ART_NODE_ID", "")

    t0 = time.perf_counter()
    spg = slice_placement_group("1x1", "H100")
    out = {"ready": spg.ready(timeout=SLICE_READY_S)}
    out["ready_s"] = round(time.perf_counter() - t0, 3)
    out["bundles"] = [dict(b) for b in spg.placement_group.bundles]
    out["on_this_node"] = (spg.placement_group.bundle_node(0)
                           == node["Address"])
    try:
        out["task_node"] = art.get(on_bundle.options(
            placement_group=spg.placement_group,
            placement_group_bundle_index=0).remote(), timeout=60)
    finally:
        spg.remove()
    deadline = time.monotonic() + SLICE_READY_S
    while art.available_resources().get(head) != 1.0 and \
            time.monotonic() < deadline:
        time.sleep(0.1)
    out["head_back"] = art.available_resources().get(head) == 1.0
    out["s"] = round(time.perf_counter() - t0, 3)
    print("cluster placement slice " + json.dumps(out), flush=True)
    if not (out["ready"] and out["on_this_node"] and out["head_back"]
            and out["bundles"] == [{"GPU": 1.0, head: 1.0}]
            and out["task_node"] == node["NodeID"]):
        raise AssertionError(f"the one-card slice group failed: {out}")
    return out


def _handoff_step(torch, llama, art, actor, engine, prompt, n_layers):
    """An 8B prefill's KV slab handed from the worker to ``engine`` as
    device objects: the worker's bucketed prefill of ``prompt`` into its
    free slot (n_layers sm90 forward launches) puts the slot's k and v
    on its card (transport "dma"); its own get is a local hit; the
    driver's get gives CUDA tensors bitwise the worker's, installs them
    into ``engine``'s free slot, and decodes the worker's greedy tokens
    exactly; a free from the driver empties the worker's device store,
    and a get after it raises ObjectLostError.  Returns the line's dict
    and the worker's launches."""
    from ant_ray_tpu_torch import exceptions  # noqa: PLC0415
    from ant_ray_tpu_torch.experimental import device_objects  # noqa: PLC0415

    t0 = time.perf_counter()
    refs, length, sums, first, want, launches = art.get(
        actor.handoff.remote(prompt), timeout=300)
    out = {"prompt": len(prompt), "length": length,
           "worker_s": round(time.perf_counter() - t0, 3),
           "worker_launches": launches,
           "local_hit": art.get(actor.handoff_local_hit.remote(*refs),
                                timeout=60)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k, v = (device_objects.get(r, timeout=300) for r in refs)
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in (k, v))
    out.update({"bytes": nbytes, "fetch_ms": round(fetch_s * 1e3, 2),
                "fetch_GBps": round(nbytes / fetch_s / 1e9, 3),
                "devices": [t.device.type for t in (k, v)],
                "dtype": str(k.dtype).removeprefix("torch."),
                "checksums_equal":
                _slab_checksum(torch, {"k": k, "v": v}) == sums})
    dst = engine.cache["k"][:, HANDOFF_SLOT]
    if tuple(dst.shape) != tuple(k.shape) or \
            HANDOFF_SLOT not in engine._free_slots:
        raise AssertionError(f"the driver's engine has no free slot of the "
                             f"slab's shape {tuple(k.shape)}: "
                             f"{tuple(dst.shape)}, free {engine._free_slots}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        engine.cache = llama.install_slot(engine.cache, k, v, length,
                                          HANDOFF_SLOT)
    torch.cuda.synchronize()
    out["install_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    t0 = time.perf_counter()
    got, engine.cache = _greedy_from_slot(
        torch, llama, engine.params, engine.cache, HANDOFF_SLOT, first,
        HANDOFF_TOKENS, engine.config)
    out["driver_decode_s"] = round(time.perf_counter() - t0, 3)
    out["tokens_equal"] = got == want
    out["first_difference"] = _first_difference(got, want)
    del k, v, dst
    for ref in refs:
        device_objects.free(ref)
    t0 = time.perf_counter()
    deadline = time.monotonic() + HANDOFF_FREE_WAIT_S
    while True:
        held = art.get(actor.device_objects_held.remote(), timeout=60)
        if held == 0 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    out["held_after_free"] = held
    out["freed_s"] = round(time.perf_counter() - t0, 3)
    try:
        device_objects.get(refs[0], timeout=60)
        out["lost_raises"] = False
    except exceptions.ObjectLostError:
        out["lost_raises"] = True
    print("cluster handoff " + json.dumps(out), flush=True)
    only_fwd = {"fwd": n_layers, "fwd_sm90": n_layers, "fwd_tf32x3": 0,
                "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                "tf32x3": 0, "sm90_d256": 0, "tf32x3_d256": 0,
                "fwd_tf32x3_d256": 0}
    if launches != only_fwd:
        raise AssertionError(f"the worker's prefill launched {launches}, "
                             f"expected {only_fwd}")
    if not (out["local_hit"] and out["checksums_equal"]
            and out["devices"] == ["cuda", "cuda"]):
        raise AssertionError("the device objects' local hit or fetch "
                             "failed")
    if not out["tokens_equal"]:
        raise AssertionError(
            f"the driver's decode from the fetched slab differs from the "
            f"worker's at token {out['first_difference']}: {got} against "
            f"{want}")
    if held or not out["lost_raises"]:
        raise AssertionError("free left the worker holding the slab, or a "
                             "get of a freed ref did not raise")
    return out, launches


def _stream_step(art, actor, prompt, want, generate_s, n_layers):
    """A token stream from the 8B actor: its streaming method yields each
    greedy token id of ``engine.stream`` for ``prompt``.  Gates: the ids
    equal ``want`` (the actor's ``generate`` of the same prompt); the
    driver holds item 0 before the generator ends (the actor's wall
    clock, on this host); the stream's bucketed prefill launches the sm90
    forward n_layers times in the worker and nothing else.  Returns the
    line's dict and the worker's launches."""
    t0 = time.perf_counter()
    ids, arrivals = [], []
    for ref in actor.stream_ids.remote(prompt):
        ids.append(art.get(ref, timeout=300))
        arrivals.append((time.perf_counter(), time.time()))
    stream_s = time.perf_counter() - t0
    launches, end_wall = art.get(actor.stream_record.remote(), timeout=60)
    out = {"prompt": len(prompt), "items": len(ids), "ids_equal": ids == want,
           "first_difference": _first_difference(ids, want),
           "first_item_s": round(arrivals[0][0] - t0, 4) if ids else None,
           "later_item_ms": (round((arrivals[-1][0] - arrivals[0][0])
                                   / (len(ids) - 1) * 1e3, 3)
                             if len(ids) > 1 else None),
           "stream_s": round(stream_s, 4),
           "generate_s": round(generate_s, 4),
           "item0_before_end_s": (round(end_wall - arrivals[0][1], 4)
                                  if ids else None),
           "worker_launches": launches}
    print("cluster stream " + json.dumps(out), flush=True)
    if not out["ids_equal"]:
        raise AssertionError(
            f"the streamed ids differ from generate's at item "
            f"{out['first_difference']}: {ids} against {want}")
    if not out["item0_before_end_s"] or out["item0_before_end_s"] <= 0:
        raise AssertionError("the driver held item 0 only after the "
                             f"actor's generator ended: {out}")
    only_fwd = {"fwd": n_layers, "fwd_sm90": n_layers, "fwd_tf32x3": 0,
                "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                "tf32x3": 0, "sm90_d256": 0, "tf32x3_d256": 0,
                "fwd_tf32x3_d256": 0}
    if launches != only_fwd:
        raise AssertionError(f"the stream's prefill launched {launches}, "
                             f"expected {only_fwd}")
    return out, launches


def _lineage_step(torch, art, runtime, ref, first, want, runs):
    """Lineage of a CUDA tensor: every copy of ``ref`` (a task's seeded
    bf16 CUDA tensor, already got as ``first``) freed through the GCS's
    FreeObject, as tests/test_lineage.py:22 frees them; the next get
    re-runs the task.  Gates: that get is on cuda and bitwise equal to
    ``first`` and to ``want`` (the seeded regeneration); the task ran
    twice (``runs`` holds a pid a run).  A driver put of a CUDA tensor
    freed the same way raises ObjectLostError."""
    from ant_ray_tpu_torch import exceptions  # noqa: PLC0415

    def free(r):
        runtime._gcs.call("FreeObject", {"object_id": r.id}, retries=3)
        time.sleep(0.2)                 # the frees reach the node's store

    free(ref)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = art.get(ref, timeout=300)
    torch.cuda.synchronize()
    out = {"second_get_s": round(time.perf_counter() - t0, 4)}
    with open(runs) as f:
        pids = [int(line) for line in f.read().split()]
    out.update({"device": again.device.type, "dtype": str(again.dtype),
                "bitwise_first": torch.equal(again, first),
                "bitwise_seeded": torch.equal(again, want),
                "task_runs": len(pids),
                "rerun_on_step4_worker": len(pids) == 2 and pids[0] == pids[1]})
    put_ref = art.put(want)
    free(put_ref)
    try:
        art.get(put_ref, timeout=60)
        out["lost_put_raises"] = None
    except exceptions.ObjectLostError as e:
        out["lost_put_raises"] = type(e).__name__
    print("cluster lineage " + json.dumps(out), flush=True)
    if not (out["device"] == "cuda" and out["bitwise_first"]
            and out["bitwise_seeded"] and out["task_runs"] == 2):
        raise AssertionError(f"the CUDA tensor was not rebuilt bitwise by "
                             f"a second run of its task: {out}")
    if out["lost_put_raises"] != "ObjectLostError":
        raise AssertionError("a freed put of a CUDA tensor did not raise "
                             "ObjectLostError")
    return out


def _drain_step(art, chaos):
    """The preemption watch: arming the notice file marks the node
    Draining within DRAIN_WAIT_S, with the notice's reason."""
    t0 = time.perf_counter()
    chaos.trigger_preemption(deadline_s=17.5, reason=DRAIN_REASON)
    deadline = time.monotonic() + DRAIN_WAIT_S
    while True:
        node = art.nodes()[0]
        if node["Draining"] or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    out = {"draining": node["Draining"], "reason": node["DrainReason"],
           "deadline": node["DrainDeadline"], "alive": node["Alive"],
           "s": round(time.perf_counter() - t0, 3)}
    print("cluster drain " + json.dumps(out), flush=True)
    if not (out["draining"] and DRAIN_REASON in out["reason"]
            and out["alive"]):
        raise AssertionError(f"the notice did not drain the node: {out}")
    return out


def cluster_phase(torch, fa, llama, params, engine, card):
    """The runtime's processes on the card (``cluster_utils.Cluster`` with
    4 CPUs and one warm standby GCS, joined with ``connect()``: two GCS
    replicas, a node daemon and worker processes).  A ``num_gpus=1``
    actor builds Llama-3-8B (seed 0, as ``params``) in its worker and
    answers the runtime phase's prompts beside ``engine`` (on
    ``params``) called here; compiled DAGs run over that actor through
    shared-memory channels and are torn down (``_dag_step``); the GCS is
    restarted and then fails over while that actor lives, which answers
    again after each (``_gcs_step``); a second ``num_gpus=1`` actor waits for the card
    until the first is killed, whose memory must come back; a task
    returns a CUDA tensor, and one slot's KV slab of ``engine`` goes to
    a worker and back; no-op calls measure the runtime's cost per call;
    shutdown must leave no process, session directory, arena or DAG
    channel file behind.  GPU placement and device objects: the node
    carries the detected h100 labels and its slice-head resource
    (_node_gates); the actor's prefill slab reaches ``engine`` as device
    objects and decodes there as in the worker (_handoff_step); a
    one-card slice group reserves the card once it is free
    (_slice_step); a preemption notice drains the node before shutdown
    (_drain_step).  The actor streams its greedy ids through a
    streaming method before its kill (_stream_step), and the task's
    CUDA tensor is rebuilt from its lineage once freed (_lineage_step).
    Returns the launches the actor counted in its process."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.cluster_utils import Cluster  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.util.chaos import ChaosSchedule  # noqa: PLC0415

    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in RUNTIME_PROMPTS]
    greedy = SamplingParams(max_tokens=RUNTIME_TOKENS)

    @art.remote(num_gpus=1)
    class EngineWorker:
        def __init__(self):
            from ant_ray_tpu_torch.llm import LLMEngine  # noqa: PLC0415

            self.engine = LLMEngine("llama3-8b", slots=2, max_seq=4096,
                                    seed=0)
            torch.cuda.synchronize()

        def checksums(self):
            return _leaf_checksums(torch, self.engine.params)

        def pid(self):
            return os.getpid()

        def devices(self):
            leaves = [*self.engine.params.values(),
                      *self.engine.cache.values()]
            flat = [t for leaf in leaves for t in (
                leaf.values() if isinstance(leaf, dict) else [leaf])]
            return sorted({t.device.type for t in flat})

        def generate(self, prompt):
            return self.engine.generate([prompt], greedy)[0].token_ids

        def counted(self, prompt):
            """Tokens and the launches of this process's kernels for
            one call."""
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            _reset_counts(flash_attention)
            tokens = self.generate(prompt)
            torch.cuda.synchronize()
            return tokens, _counts(flash_attention)

        def last_logits(self, ids):
            """The fp32 logits of the last position of ``ids`` (a CUDA
            int64 tensor of prompt ids), [vocab] on the card, from the
            bucketed prefill the engine runs (into its slot 0)."""
            n = int(ids.shape[0])
            with torch.inference_mode():    # the engine's cache is made so
                padded = torch.zeros((1, _bucket(n, self.engine.max_seq)),
                                     dtype=torch.int64, device=ids.device)
                padded[0, :n] = ids
                logits, self.engine.cache = llama.prefill_into_cache(
                    self.engine.params, padded, self.engine.cache, 0, n,
                    self.engine.config)
                return logits.float()

        def take_launches(self):
            """The launches of this process's kernels since the last
            reset, which this call makes."""
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            torch.cuda.synchronize()
            counts = _counts(flash_attention)
            _reset_counts(flash_attention)
            return counts

        def handoff(self, prompt):
            """A bucketed prefill of ``prompt`` into the free slot, whose
            k and v (cloned) go on the card as device objects; returns
            their refs, the slot's length, the slab's checksum, the
            prefill's greedy token, the HANDOFF_TOKENS tokens decoded
            from the slot after it, and the prefill's launches."""
            from ant_ray_tpu_torch.experimental import device_objects  # noqa: PLC0415
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            eng, n = self.engine, len(prompt)
            with torch.inference_mode():
                padded = torch.zeros((1, _bucket(n, eng.max_seq)),
                                     dtype=torch.int64, device="cuda")
                padded[0, :n] = torch.tensor(prompt, device="cuda")
                torch.cuda.synchronize()
                _reset_counts(flash_attention)
                logits, eng.cache = llama.prefill_into_cache(
                    eng.params, padded, eng.cache, HANDOFF_SLOT, n,
                    eng.config)
                torch.cuda.synchronize()
                launches = _counts(flash_attention)
                slab = {name: eng.cache[name][:, HANDOFF_SLOT].clone()
                        for name in ("k", "v")}
                length = int(eng.cache["length"][HANDOFF_SLOT])
            refs = [device_objects.put(slab[name], transport="dma")
                    for name in ("k", "v")]
            self.handoff_ptrs = [slab[name].data_ptr() for name in ("k", "v")]
            sums = _slab_checksum(torch, slab)
            first = int(logits.argmax())
            tokens, eng.cache = _greedy_from_slot(
                torch, llama, eng.params, eng.cache, HANDOFF_SLOT, first,
                HANDOFF_TOKENS, eng.config)
            return refs, length, sums, first, tokens, launches

        def handoff_local_hit(self, k_meta, v_meta):
            """Whether this process's get of its own device objects gives
            the very tensors it put (the same data_ptr)."""
            from ant_ray_tpu_torch.experimental import device_objects  # noqa: PLC0415

            return [device_objects.get(m).data_ptr()
                    for m in (k_meta, v_meta)] == self.handoff_ptrs

        def device_objects_held(self):
            from ant_ray_tpu_torch._private.worker import (  # noqa: PLC0415
                global_worker as worker)

            return len(worker.runtime._device_objects)

        @art.method(num_returns="streaming")
        def stream_ids(self, prompt):
            """Each token id of the engine's greedy stream of ``prompt``,
            one item each; the stream's launches of this process's
            kernels and the generator's end on the host's wall clock are
            kept for ``stream_record``."""
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            torch.cuda.synchronize()
            _reset_counts(flash_attention)
            for event in self.engine.stream(prompt, greedy):
                if not event["finished"]:
                    yield event["token_id"]
            torch.cuda.synchronize()
            self.stream_end = (_counts(flash_attention), time.time())

        def stream_record(self):
            return self.stream_end

    @art.remote(num_gpus=1)
    class Waiter:
        def ping(self):
            return "ran"

    @art.remote(num_gpus=1)
    def random_tensor(seed, n, runs):
        with open(runs, "a") as f:      # one line, its pid, per run
            f.write(f"{os.getpid()}\n")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn((n, n), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    @art.remote(num_gpus=1)
    def echo_slab(slab):
        ok = all(t.device.type == "cuda" for t in slab.values())
        return slab, _slab_checksum(torch, slab), ok

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def card_free():
        """The card's free bytes, with this process's cached blocks given
        back first, so that only what processes hold is counted."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info()[0]

    def smi_apps():
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()

    out = {"card": card, "model": "llama3-8b"}
    shm = os.statvfs("/dev/shm")
    out["dev_shm_bytes"] = shm.f_blocks * shm.f_frsize
    t0, t_init = time.perf_counter(), time.time()
    # The daemon's preemption watch polls the chaos harness's notice
    # file, armed by the drain step at the end.
    chaos = ChaosSchedule(seed=0)
    chaos.preemption_notice()
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "gcs_standbys": CLUSTER_GCS_STANDBYS,
        "_system_config": {**QUIET, **chaos.system_config(),
                           "preemption_poll_interval_s": 0.1}})
    try:
        ctx = cluster.connect()
    except BaseException:
        cluster.shutdown()
        chaos.cleanup()
        raise
    out["init_s"] = round(time.perf_counter() - t0, 3)
    runtime = global_worker.runtime
    session_dir, store_dir = cluster._session_dir, runtime.store_dir

    def cluster_pids():
        return ([p.pid for p, _a in cluster._gcs_procs]
                + [p.pid for p in cluster._node_procs])

    daemons = cluster_pids()
    workers = set()
    try:
        out["mode"] = ctx.mode
        # A standby answers this read from tables it syncs every 0.25 s:
        # the node's registration reaches it within a few syncs.
        deadline = time.monotonic() + CLUSTER_GCS_WAIT_S
        while True:
            out["resources"] = art.cluster_resources()
            if "GPU" in out["resources"] or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        out["store_capacity_bytes"] = runtime._node.call(
            "GetStoreStats", {}, timeout=30)["capacity"]
        print("cluster up " + json.dumps(out), flush=True)
        if out["resources"].get("GPU") != 1.0:
            raise AssertionError(f"the detector found no card: "
                                 f"{out['resources']}")
        out["placement"] = {"node": _node_gates(art, torch)}

        # Step 2: the engine in a worker process.
        free_before = card_free()
        t0, since = time.perf_counter(), time.time()
        actor = EngineWorker.remote()
        sums = art.get(actor.checksums.remote(), timeout=900)
        out["actor_start_s"] = round(time.perf_counter() - t0, 3)
        # What the GCS's and the daemon's io loops did meanwhile (ROADMAP
        # §C: a node marked dead while an 8B actor started).
        out["io_loops_at_actor_start"] = _io_loops(runtime._gcs, since)
        want_sums = _leaf_checksums(torch, params)
        out["weights_checksums_equal"] = sums == want_sums
        if sums != want_sums:
            raise AssertionError(f"the worker's weights differ: {sums} "
                                 f"against {want_sums}")
        out["actor_devices"] = art.get(actor.devices.remote())
        if out["actor_devices"] != ["cuda"]:
            raise AssertionError(f"the worker's engine is on "
                                 f"{out['actor_devices']}")
        for prompt in prompts:          # round 0: warm-up
            art.get(actor.generate.remote(prompt))
        calls, launches, direct_tokens = [], {}, []
        for n, prompt in zip(RUNTIME_PROMPTS, prompts):
            direct, direct_s = timed(lambda: engine.generate(
                [prompt], greedy)[0].token_ids)
            (tokens, counted), actor_s = timed(
                lambda: art.get(actor.counted.remote(prompt)))
            calls.append({"prompt": n, "bucket": _bucket(n, 4096),
                          "tokens": len(tokens), "equal": tokens == direct,
                          "direct_s": round(direct_s, 4),
                          "actor_s": round(actor_s, 4),
                          "worker_launches": counted})
            launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
            direct_tokens.append(direct)
        out["calls"] = calls
        workers.update(c for d in daemons for c in _child_pids(d))
        if not all(c["equal"] and c["tokens"] == RUNTIME_TOKENS
                   for c in calls):
            raise AssertionError("the worker's tokens differ from the "
                                 "engine's")
        for c in calls:
            want = cfg.n_layers if c["bucket"] >= 128 else 0
            if c["worker_launches"] != {
                    "fwd": want, "fwd_sm90": want, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0,
                    "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}:
                raise AssertionError(
                    f"the worker launched {c['worker_launches']} for the "
                    f"{c['prompt']}-token prompt, expected {want} sm90 "
                    "forward launches")

        # Step 2b: compiled DAGs over the actor (channels, exec loops),
        # torn down before anything else calls it.
        out["dag"], dag_launches = _dag_step(
            torch, art, actor, prompts, direct_tokens, cfg.n_layers)
        launches = {k: launches.get(k, 0) + v
                    for k, v in dag_launches.items()}
        out["channels_left"] = out["dag"]["channels_left"]

        # Step 2c: the GCS restarted, then failed over, while the actor
        # lives; it answers the longest prompt after each.
        if _bucket(RUNTIME_PROMPTS[-1], 4096) < 128:
            raise AssertionError("the GCS step's prompt has no bucketed "
                                 "prefill")
        out["gcs"] = _gcs_step(art, cluster, runtime, actor, prompts[-1],
                               direct_tokens[-1], cfg.n_layers)
        for name in ("restart", "failover"):
            launches = {k: launches.get(k, 0) + v for k, v in
                        out["gcs"][name]["worker_launches"].items()}
        daemons += cluster_pids()

        # Step 2d: the actor's prefill slab handed to ``engine`` as
        # device objects, decoded on both sides.
        if _bucket(HANDOFF_PROMPT, 4096) < 128:
            raise AssertionError("the handoff's prompt has no bucketed "
                                 "prefill")
        out["handoff"], handoff_launches = _handoff_step(
            torch, llama, art, actor, engine, prompts[RUNTIME_PROMPTS.index(
                HANDOFF_PROMPT)], cfg.n_layers)
        launches = {k: launches.get(k, 0) + v
                    for k, v in handoff_launches.items()}

        # Step 2e: a token stream from the actor (a streaming method over
        # engine.stream), before its kill frees the card for step 4.
        out["stream"], stream_launches = _stream_step(
            art, actor, prompts[-1], direct_tokens[-1], calls[-1]["actor_s"],
            cfg.n_layers)
        launches = {k: launches.get(k, 0) + v
                    for k, v in stream_launches.items()}

        # Step 3: the card is taken; a second card actor waits.
        out["compute_apps_with_engine"] = smi_apps()
        waiter = Waiter.remote()
        pending = waiter.ping.remote()
        ready, _ = art.wait([pending], timeout=2.0)
        out["second_actor_pending"] = not ready
        if ready:
            raise AssertionError("a second num_gpus=1 actor ran while the "
                                 "card was taken")
        art.kill(actor)
        t0 = time.perf_counter()
        out["second_actor_after_kill"] = art.get(pending, timeout=120)
        out["second_actor_wait_s"] = round(time.perf_counter() - t0, 3)
        deadline = time.monotonic() + CLUSTER_FREE_WAIT_S
        while True:
            free_after = card_free()
            if free_after >= free_before - CLUSTER_FREE_SLACK or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        out["free_before_bytes"], out["free_after_kill_bytes"] = \
            free_before, free_after
        out["memory_back_s"] = round(time.perf_counter() - t0, 3)
        out["compute_apps_after_kill"] = smi_apps()
        if free_after < free_before - CLUSTER_FREE_SLACK:
            raise AssertionError(
                f"the card's free memory did not come back: {free_after} "
                f"bytes after the kill, {free_before} before the actor")
        art.kill(waiter)

        # Step 3b: a one-card slice group reserves the freed card.
        out["placement"]["slice"] = _slice_step(art,
                                                out["placement"]["node"])

        # Step 4: a task returns a CUDA tensor.
        runs = os.path.join(session_dir, "random_tensor_runs")
        task_ref = random_tensor.remote(7, 1024, runs)
        task_out, out["task_cuda_tensor_s"] = timed(
            lambda: art.get(task_ref, timeout=300))
        gen = torch.Generator(device="cuda").manual_seed(7)
        task_want = torch.randn((1024, 1024), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
        out["task_tensor_bitwise"] = (task_out.device.type == "cuda"
                                      and torch.equal(task_out, task_want))
        if not out["task_tensor_bitwise"]:
            raise AssertionError("the task's CUDA tensor differs")

        # Step 4b: that tensor rebuilt from its lineage once every copy
        # is freed; a put one freed so is lost.
        out["lineage"] = _lineage_step(torch, art, runtime, task_ref,
                                       task_out, task_want, runs)
        del task_ref

        # Step 5: one slot's KV slab to a worker and back.
        slab = {"k": engine.cache["k"][:, 0], "v": engine.cache["v"][:, 0]}
        nbytes = sum(t.numel() * t.element_size() for t in slab.values())
        capacity = out["store_capacity_bytes"]
        shm_free = os.statvfs("/dev/shm").f_bavail * shm.f_frsize
        if 3 * nbytes > min(capacity, shm_free):
            raise AssertionError(
                f"the node store cannot hold the slab three times: capacity "
                f"{capacity}, /dev/shm free {shm_free}, slab {nbytes}")
        want_sum = _slab_checksum(torch, slab)
        puts, trips, gets, equal = [], [], [], []
        for _ in range(1 + CLUSTER_SLAB_REPS):
            ref, put_s = timed(lambda: art.put(slab))
            t0 = time.perf_counter()
            back_ref = echo_slab.remote(ref)
            art.wait([back_ref], timeout=300)
            trip_s = time.perf_counter() - t0
            (back, sums, on_card), get_s = timed(lambda: art.get(back_ref))
            puts.append(put_s)
            trips.append(trip_s)
            gets.append(get_s)
            equal.append(on_card and sums == want_sum and all(
                back[n].device.type == "cuda" and torch.equal(back[n], slab[n])
                for n in slab))
            del ref, back_ref, back
        workers.update(c for d in daemons for c in _child_pids(d))

        def warm(xs):
            return statistics.median(xs[1:])

        def rate(seconds):
            return round(nbytes / seconds / 1e9, 3)

        out["slab"] = {
            "bytes": nbytes, "bitwise": equal,
            "first_put_ms": round(puts[0] * 1e3, 2),
            "first_round_trip_ms": round(trips[0] * 1e3, 2),
            "first_get_ms": round(gets[0] * 1e3, 2),
            "put_ms": round(warm(puts) * 1e3, 2), "put_GBps":
            rate(warm(puts)), "round_trip_ms": round(warm(trips) * 1e3, 2),
            "round_trip_GBps": rate(warm(trips)),
            "get_ms": round(warm(gets) * 1e3, 2), "get_GBps":
            rate(warm(gets)), "reps": CLUSTER_SLAB_REPS}
        if not all(equal):
            raise AssertionError("the slab did not come back bitwise")

        # Step 6: the runtime's own cost per call, and how many of its
        # calls went over hot frames (hotframe.py's counters).
        from ant_ray_tpu_torch._private import hotframe  # noqa: PLC0415

        before = dict(hotframe.counters)
        out["overhead"] = runtime_overhead(art)
        hot = out["overhead"]["hotframe"] = {
            k: v - before[k] for k, v in hotframe.counters.items()}
        # Only a call made before its connection's HELLO-ack (the first
        # to the new actor's worker and to the task's) goes pickled.
        if (hot["calls_encoded"] < 2 * RUNTIME_NOOP_CALLS - 2
                or hot["fallback_ineligible"] or hot["fallback_cache_full"]):
            raise AssertionError(f"no-op calls off the hot wire: {hot}")
        out["local_mode_overhead_us"] = {"actor": 6.58, "task": 5.76}
        workers.update(c for d in daemons for c in _child_pids(d))

        # Step 6b: a preemption notice drains the node.
        out["drain"] = _drain_step(art, chaos)
    except BaseException:
        _print_worker_logs(session_dir)
        try:
            out["io_loops_since_init"] = _io_loops(runtime._gcs, t_init)
        except Exception as e:  # noqa: BLE001 — the GCS may be gone
            out["io_loops_since_init"] = repr(e)
        out["gcs_deferred_ticks"] = _deferred_ticks(session_dir)
        print("cluster (failed) " + json.dumps(out, default=str), flush=True)
        art.shutdown()
        cluster.shutdown()
        chaos.cleanup()
        raise
    # Step 7: shutdown leaves nothing behind.
    deferred = _deferred_ticks(session_dir)
    t0 = time.perf_counter()
    art.shutdown()
    cluster.shutdown()
    chaos.cleanup()
    pids = sorted(set(daemons)) + sorted(workers)
    deadline = time.monotonic() + CLUSTER_EXIT_WAIT_S
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["shutdown_s"] = round(time.perf_counter() - t0, 3)
    out["processes"] = len(pids)
    out["left_alive"] = [p for p in pids if _pid_alive(p)]
    out["session_dir_left"] = os.path.exists(session_dir)
    out["arena_left"] = os.path.exists(store_dir)
    out["channels_left"] = [p for p in out["channels_left"]
                            if os.path.exists(p)]
    out["launches"] = launches
    out["gcs_deferred_ticks"] = deferred
    print("cluster " + json.dumps(out), flush=True)
    if out["left_alive"] or out["session_dir_left"] or out["arena_left"] \
            or out["channels_left"]:
        raise AssertionError("shutdown left a process, the session "
                             "directory, the arena or a DAG's channel "
                             "file behind")
    return launches


TRACE_SERVER = dict(slots=2, max_seq=4096, seed=0, kv_offload="auto")
# The servers' depth: Llama-3-8B's widths with its depth cut from 32
# layers to this, to pay for the jobs phase in the time limit.
TRACE_LAYERS = 8
TRACE_PROMPTS = {"completion": 1500, "turn1": 300, "turn2": 50,
                 "stream": 100}  # prompt tokens of the traced requests
TRACE_TOKENS = 16               # new tokens per traced request
TRACE_SPLIT_CALLS = 200         # no-op actor calls, sampled and unsampled
TRACE_WAIT_S = 60.0             # for spans and series to reach the GCS
# The spans the traced requests must leave, each named as recorded.
TRACE_SPAN_NAMES = ("smoke:request", "call:TracedServer.complete",
                    "run:TracedServer.complete", "run:TracedServer.turn",
                    "run:TracedServer.stream", "llm:generate",
                    "llm:admission", "llm:stream", "llm:restore")


def _poll(fn, what, timeout=TRACE_WAIT_S):
    """fn() until it returns something true; raises after ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        value = fn()
        if value:
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"never saw {what} within {timeout} s")
        time.sleep(0.2)


def _trace_gates(spans, ctx, restore_bytes):
    """Gates on one request trace's spans (dicts as the GCS holds them):
    one trace id, one root (the driver's request span), no orphan parent,
    every name of TRACE_SPAN_NAMES, llm:admission inside llm:generate
    under one execution span, and llm:restore under the second turn's
    execution with the session's slab bytes.  Returns a summary."""
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

    trace_ids = {s["trace_id"] for s in spans}
    if trace_ids != {ctx.trace_id}:
        raise AssertionError(f"spans of {len(trace_ids)} traces: "
                             f"{sorted(trace_ids)}")
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s.get("parent_id") not in by_id]
    if [(s["name"], s["span_id"], s.get("parent_id")) for s in roots] != [
            ("smoke:request", ctx.span_id, "")]:
        raise AssertionError(
            "the trace has orphans or more than one root: " + json.dumps(
                [(s["name"], s.get("parent_id")) for s in roots]))
    names = sorted({s["name"] for s in spans})
    missing = sorted(set(TRACE_SPAN_NAMES) - set(names))
    if missing:
        raise AssertionError(f"spans missing from the trace: {missing}; "
                             f"present: {names}")

    def parent_name(s):
        return by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id \
            else ""

    gen = next(s for s in spans if s["name"] == "llm:generate"
               and parent_name(s) == "run:TracedServer.complete")
    adm = [s for s in spans if s["name"] == "llm:admission"
           and s["parent_id"] == gen["parent_id"]]
    if len(adm) != 1 or not (gen["ts"] <= adm[0]["ts"] and adm[0]["ts"]
                             + adm[0]["dur_s"] <= gen["ts"] + gen["dur_s"]):
        raise AssertionError(
            f"llm:admission not inside llm:generate: {gen}, {adm}")
    streams = [s for s in spans if s["name"] == "llm:stream"]
    if [parent_name(s) for s in streams] != ["run:TracedServer.stream"]:
        raise AssertionError(f"llm:stream spans: {streams}")
    restores = [s for s in spans if s["name"] == "llm:restore"]
    if len(restores) != 1 or restores[0].get("error") or \
            parent_name(restores[0]) != "run:TracedServer.turn" or \
            restores[0]["attrs"] != {"session": "s",
                                     "bytes": restore_bytes}:
        raise AssertionError(f"llm:restore spans {restores}, expected one "
                             f"of {restore_bytes} bytes under the turn")
    tree = tracing_plane.span_tree(spans)
    return {"spans": len(spans), "names": names, "roots": len(tree),
            "restore_bytes": restore_bytes,
            "restore_ms": round(restores[0]["dur_s"] * 1e3, 3)}


def _split_us(spans, wall_sampled, wall_unsampled):
    """Medians (µs) of a sampled no-op call's stages: client serialize
    (the call span's queue stage: submit to frame write), the worker's
    queue (arrival to executor pickup) and execute, and wire (the rest
    of the call span's wire stage: both frames' transport and the
    reply's decode), beside the wall time of sampled and unsampled
    calls."""
    runs = {s["parent_id"]: s for s in spans if s["name"].startswith("run:")}
    rows = []
    for call in (s for s in spans if s["name"].startswith("call:")):
        run = runs.get(call["span_id"])
        if run is None:
            continue
        queue, execute = run["stages"]["queue"], run["stages"]["execute"]
        rows.append({"serialize": call["stages"]["queue"],
                     "wire": call["stages"]["wire"] - queue - execute,
                     "queue": queue, "execute": execute,
                     "call_span": call["dur_s"]})
    if len(rows) != len(wall_sampled):
        raise AssertionError(f"{len(rows)} call/run span pairs for "
                             f"{len(wall_sampled)} sampled calls")
    out = {"calls": len(rows)}
    for key in ("serialize", "wire", "queue", "execute", "call_span"):
        out[f"{key}_us"] = statistics.median(r[key] for r in rows) * 1e6
    out["sampled_wall_us"] = statistics.median(wall_sampled) * 1e6
    out["unsampled_wall_us"] = statistics.median(wall_unsampled) * 1e6
    return out


def tracing_phase(torch, llama, card):
    """Tracing and metrics through a cluster on the card
    (``init(num_cpus=2)``): a ``num_gpus=1`` actor holds two LLMServers
    on Llama-3-8B's widths at TRACE_LAYERS layers (random weights from
    seed 0), one with bucketed
    prefill for completions and streams, whose prefills of 128 tokens
    and more run the sm90 flash forward, and one with the reference's
    serving default (chunks of 64), whose sessions continue.  Under one
    sampled trace context the driver sends a 1500-token completion, a
    session's two turns with the slab evicted between them (to the
    object-plane store: kv_offload="auto" in a worker), and a stream.
    Gates: the traced completion's tokens equal an untraced one's; the
    worker launched the sm90 forward n_layers times per bucketed
    prefill and nothing else; the trace (_trace_gates);
    ``art.timeline`` JSON with task slices for the actor calls and the
    trace's request rows; ``MetricsGet`` with ``art_rpc_latency_s``
    series whose buckets sum to their count and whose exemplar names the
    trace, and the loop's gauges tagged ``deployment="llm"``;
    ``device_stats_gauges()`` here with the card's total memory; then a
    trace split of no-op calls (printed, not gated) and shutdown leaving
    nothing behind.  Returns the worker's launches."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import (  # noqa: PLC0415
        device_stats_gauges, tracing_plane)
    from ant_ray_tpu_torch.util import timeline as tl_util  # noqa: PLC0415
    from ant_ray_tpu_torch.util import tracing as tr_util  # noqa: PLC0415

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              n_layers=TRACE_LAYERS)
    rng = np.random.default_rng(16)
    prompts = {k: rng.integers(0, cfg.vocab_size, n).tolist()
               for k, n in TRACE_PROMPTS.items()}

    @art.remote(num_gpus=1)
    class TracedServer:
        def __init__(self):
            from ant_ray_tpu_torch.llm import LLMServer  # noqa: PLC0415
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            self.fa = flash_attention
            self.server = LLMServer(cfg, prefill_chunk_tokens=None,
                                    **TRACE_SERVER)
            self.sessions = LLMServer(cfg, **TRACE_SERVER)
            torch.cuda.synchronize()
            _reset_counts(flash_attention)

        def complete(self, request):
            return self.server(request)["choices"][0]["token_ids"]

        def turn(self, request):
            return self.sessions(request)["choices"][0]["token_ids"]

        def evict(self, session_id):
            return self.sessions._loop.evict_session(session_id)

        def offload_bytes(self):
            return self.sessions.engine.stats["offload_bytes"]

        def stream(self, request):
            return [c["choices"][0].get("token_id")
                    for c in self.server.stream(request)]

        def counts(self):
            torch.cuda.synchronize()
            return _counts(self.fa)

    def request(kind, **kw):
        return {"prompt": prompts[kind], "max_tokens": TRACE_TOKENS, **kw}

    def timed(fn):
        t0 = time.perf_counter()
        value = fn()
        return value, round(time.perf_counter() - t0, 4)

    out = {"card": card, "model": "llama3-8b", "layers": TRACE_LAYERS}
    # Spans recorded before the cluster (none are sampled by the earlier
    # phases, but a 1-in-100 head-sampled call may be) are dropped here.
    tracing_plane.flush()
    art.init(num_cpus=2, _system_config=QUIET)
    runtime = global_worker.runtime
    session_dir, store_dir = runtime.session_dir, runtime.store_dir
    daemons = [p.pid for p in runtime._owned_processes]
    workers = set()
    # Every call outside the traced request runs under an unsampled
    # context: a call without one is head-sampled (trace_sample_rate).
    untraced = tracing_plane.mint(sampled=False)
    trace = tracing_plane.mint(sampled=True)
    out["trace_id"] = trace.trace_id
    scope = tracing_plane.set_current(untraced)
    try:
        if art.cluster_resources().get("GPU") != 1.0:
            raise AssertionError("the detector found no card")
        t0 = time.perf_counter()
        actor = TracedServer.remote()
        untraced_tokens = art.get(actor.complete.remote(
            request("completion")), timeout=900)
        out["actor_start_and_first_completion_s"] = round(
            time.perf_counter() - t0, 3)
        walls = {}
        wall0 = time.time()
        t0 = time.perf_counter()
        with tracing_plane.use(trace):
            tokens, walls["completion"] = timed(lambda: art.get(
                actor.complete.remote(request("completion")), timeout=300))
            _, walls["turn1"] = timed(lambda: art.get(actor.turn.remote(
                request("turn1", session_id="s")), timeout=300))
            before = art.get(actor.offload_bytes.remote())
            if not art.get(actor.evict.remote("s")):
                raise AssertionError("the session's slab was not evicted")
            slab_bytes = art.get(actor.offload_bytes.remote()) - before
            _, walls["turn2"] = timed(lambda: art.get(actor.turn.remote(
                request("turn2", session_id="s")), timeout=300))
            streamed, walls["stream"] = timed(lambda: art.get(
                actor.stream.remote(request("stream")), timeout=300))
        tracing_plane.record_span(
            trace, "smoke:request", ts=wall0,
            dur_s=time.perf_counter() - t0, span_id=trace.span_id,
            parent_id="", service="driver")
        out["wall_s"] = walls
        workers.update(c for d in daemons for c in _child_pids(d))

        # Tracing changes no result; the kernel ran in the worker.
        out["tokens_equal"] = tokens == untraced_tokens
        if not out["tokens_equal"] or len(tokens) != TRACE_TOKENS:
            raise AssertionError("the traced completion's tokens differ "
                                 "from the untraced one's")
        if len(streamed) != TRACE_TOKENS + 1 or streamed[-1] is not None:
            raise AssertionError(f"the stream gave {streamed}")
        launches = art.get(actor.counts.remote())
        prefills = [TRACE_PROMPTS["completion"]] * 2 + [
            TRACE_PROMPTS["stream"]]
        want = cfg.n_layers * sum(_bucket(n, TRACE_SERVER["max_seq"]) >= 128
                                  for n in prefills)
        out["launches"] = launches
        if launches != {**dict.fromkeys(launches, 0), "fwd": want,
                        "fwd_sm90": want}:
            raise AssertionError(f"the worker launched {launches}, expected "
                                 f"{want} sm90 forward launches")

        # One unbroken trace, in the GCS and through util.tracing.  The
        # processes publish their spans at least once a second: after
        # the names are all there, two more seconds bring in the rest.
        _poll(lambda: set(TRACE_SPAN_NAMES) <= {
            x["name"] for x in tl_util.fetch_span_events()},
            "the trace's spans")
        time.sleep(2.0)
        spans = tl_util.fetch_span_events()
        out["trace"] = _trace_gates(spans, trace, slab_bytes)
        live = tr_util.live_spans()
        if {s.trace_id for s in live} != {trace.trace_id} or \
                len(live) != len(spans):
            raise AssertionError("live_spans() holds other traces or "
                                 "misses spans")
        covered = {s.attributes["task_id"] for s in live
                   if "task_id" in s.attributes}
        derived = [s for s in tr_util.task_spans()
                   if s.attributes.get("art.task_id") in covered]
        if derived:
            raise AssertionError(f"task_spans() re-derived traced tasks: "
                                 f"{[s.name for s in derived]}")

        # The timeline.
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
            path = art.timeline(os.path.join(tmp, "timeline.json"))
            with open(path) as f:
                events = json.load(f)
        tasks = {e["name"] for e in events
                 if e.get("ph") == "X" and e.get("cat") == "task"}
        rows = [e for e in events if e.get("cat") == "request_span"]
        out["timeline"] = {"events": len(events), "request_rows": len(rows),
                           "task_names": sorted(tasks)}
        if not {"TracedServer.complete", "TracedServer.turn",
                "TracedServer.stream"} <= tasks or \
                {e["tid"] for e in rows} != {trace.trace_id[:8]} or \
                len(rows) != len(spans):
            raise AssertionError(f"the timeline lacks the actor calls or "
                                 f"the trace's rows: {out['timeline']}")

        # Metrics: the RPC histogram and the loop's gauges in the GCS.
        def series():
            got = runtime._gcs.call("MetricsGet", {}, retries=3)
            rpc = [m for m in got if m["name"] == "art_rpc_latency_s"]
            gauges = {m["name"]: m["value"] for m in got
                      if m["name"] in ("art_llm_tokens_per_s",
                                       "art_llm_queue_depth",
                                       "art_llm_resident_sessions")
                      and m["tags"] == {"deployment": "llm"}}
            return (rpc, gauges) if len(gauges) == 3 and {
                m["tags"]["stage"] for m in rpc} >= {
                "client_queue", "client_wire", "queue", "execute"} \
                else None

        rpc, gauges = _poll(series, "the RPC histogram and the gauges")
        out["metrics"] = {
            "rpc": {f"{m['tags']['method']}/{m['tags']['stage']}":
                    {"count": m["count"], "sum_s": m["sum"],
                     "exemplar": m.get("exemplar", {}).get(
                         "labels", {}).get("trace_id", "")[:8]}
                    for m in rpc}, "llm_gauges": gauges}
        if any(sum(m["buckets"]) != m["count"] for m in rpc) or any(
                m.get("exemplar", {}).get("labels", {}).get("trace_id")
                != trace.trace_id for m in rpc):
            raise AssertionError(f"art_rpc_latency_s: {rpc}")
        card_series = device_stats_gauges()
        out["device_gauges"] = {s["name"]: s["value"] for s in card_series}
        total = torch.cuda.get_device_properties(0).total_memory
        if [(s["name"], s["tags"]) for s in card_series] != [
                (n, {"device": "cuda:0", "platform": "gpu"}) for n in (
                    "art_device_hbm_bytes_in_use",
                    "art_device_hbm_peak_bytes",
                    "art_device_hbm_bytes_limit")] or \
                card_series[2]["value"] != float(total):
            raise AssertionError(f"device_stats_gauges(): {card_series}")

        # The split of a no-op actor call, sampled, beside unsampled ones.
        echo = art.remote(_Echo).remote()
        art.get(echo.ping.remote(0))
        split = tracing_plane.mint(sampled=True)
        wall_sampled, wall_unsampled = [], []
        for i in range(TRACE_SPLIT_CALLS):
            for c, walls_of in ((split, wall_sampled),
                                (untraced, wall_unsampled)):
                with tracing_plane.use(c):
                    t0 = time.perf_counter()
                    art.get(echo.ping.remote(i))
                    walls_of.append(time.perf_counter() - t0)
        split_spans = _poll(lambda: (lambda s: s if len(s) >= 2 *
                                     TRACE_SPLIT_CALLS else None)(
            tl_util.fetch_span_events(trace_id=split.trace_id)),
            "the split's spans")
        out["split"] = _split_us(split_spans, wall_sampled, wall_unsampled)
        print(f"trace split ({card}): " + json.dumps(out["split"]),
              flush=True)
        workers.update(c for d in daemons for c in _child_pids(d))
    except BaseException:
        _print_worker_logs(session_dir)
        print("tracing (failed) " + json.dumps(out, default=str), flush=True)
        art.shutdown()
        raise
    finally:
        tracing_plane.reset(scope)
    t0 = time.perf_counter()
    art.shutdown()
    pids = daemons + sorted(workers)
    deadline = time.monotonic() + CLUSTER_EXIT_WAIT_S
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["shutdown_s"] = round(time.perf_counter() - t0, 3)
    out["left_alive"] = [p for p in pids if _pid_alive(p)]
    out["session_dir_left"] = os.path.exists(session_dir)
    out["arena_left"] = os.path.exists(store_dir)
    print("tracing " + json.dumps(out), flush=True)
    if out["left_alive"] or out["session_dir_left"] or out["arena_left"]:
        raise AssertionError("shutdown left a process, the session "
                             "directory or the arena behind")
    return launches


DEPLOY_SERVER = dict(slots=2, max_seq=4096, max_ongoing_requests=8)
# The replicas' depth: Llama-3-8B's widths with its depth cut from 32
# layers to this, to pay for the jobs phase in the time limit.
DEPLOY_LAYERS = 8
DEPLOY_PROMPTS = {"completion": 1500, "chat": 300, "stream": 100,
                  "short": 40, "http": 200, "turn1": 300, "turn2": 50,
                  "turn3": 50, "filler": 20}  # tokens (the chat's: chars)
# A replica's warm-up prompts before it reports ready: one per prefill
# bucket of the phase's requests (2048, 512, 256, 128, 64).
DEPLOY_WARMUP = (1500, 300, 200, 100, 40)
DEPLOY_TOKENS = 16              # new tokens per request
DEPLOY_THREADS = 4              # driver threads sending through the handle
DEPLOY_IDLE_EVICT_S = 1.0       # the sessions replica's kv_idle_evict_s
DEPLOY_KINDS = ("completion", "chat", "stream", "short")


def _deployed_server_cls():
    """LLMServer plus what the deployment phase reads in a replica: its
    pid, build and warm-up times, its kernel launches and the prompt
    lengths it was given since it was warm, its store and counters, and
    the times of its sessions' offloads and restores: ``extract_slot``
    (card to pinned host memory), the store's ``put`` and ``get``, and
    ``install_slot`` on the host and on the card (CUDA events).  The
    warm-up (one request per prefill bucket of DEPLOY_WARMUP) runs in
    the constructor, before the replica reports ready: a process's first
    prefill of a bucket loads its kernels, which took 8-11 s on the
    card.  Built in a function: the class is shipped to the replicas by
    value."""
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch.llm.serve_llm import LLMServer  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama as llama_mod  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    def timed(log, key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            value = fn(*args, **kwargs)
            log.setdefault(key, []).append(time.perf_counter() - t0)
            return value
        return wrapper

    class DeployedServer(LLMServer):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            torch.cuda.synchronize()
            self.build_s = time.perf_counter() - t0
            self.prompt_lens = []
            self.served = 0
            gen = np.random.default_rng(0)
            vocab = self.engine.config.vocab_size
            t0 = time.perf_counter()
            for n in DEPLOY_WARMUP:
                self({"prompt": gen.integers(0, vocab, n).tolist(),
                      "max_tokens": 2})
            torch.cuda.synchronize()
            self.warm_s = time.perf_counter() - t0
            self.prompt_lens = []
            self.served = 0
            self.log = {}
            self.installs = []
            store = self.engine._store()
            store.put = timed(self.log, "put_s", store.put)
            store.get = timed(self.log, "get_s", store.get)
            llama_mod.extract_slot = timed(self.log, "extract_s",
                                           llama_mod.extract_slot)
            install = llama_mod.install_slot

            def timed_install(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                value = install(*args, **kwargs)
                host_s = time.perf_counter() - t0
                end.record()
                self.installs.append((host_s, start, end))
                return value

            llama_mod.install_slot = timed_install
            _reset_counts(fa)

        def _submit(self, prompt, sampling, session_id=None):
            self.prompt_lens.append(len(prompt) if isinstance(prompt, list)
                                    else len(self.engine.tokenizer.encode(
                                        prompt)))
            return super()._submit(prompt, sampling, session_id=session_id)

        def __call__(self, request):
            self.served += 1
            return {**super().__call__(request), "replica_pid": os.getpid()}

        def stream(self, request):
            self.served += 1
            yield from super().stream(request)

        def evict(self, session_id):
            return self._loop.evict_session(session_id)

        def report(self):
            torch.cuda.synchronize()
            return {"pid": os.getpid(), "build_s": round(self.build_s, 3),
                    "warm_s": round(self.warm_s, 3),
                    "served": self.served, "prompt_lens": self.prompt_lens,
                    "launches": _counts(fa),
                    "store": type(self.engine._kv_store).__name__,
                    "stats": dict(self.engine.stats),
                    "times_s": self.log,
                    "install_host_s": [h for h, _, _ in self.installs],
                    "install_card_ms": [s.elapsed_time(e)
                                        for _, s, e in self.installs]}

    return DeployedServer


def _ancestors():
    """This process and its ancestors (a shell that started this script
    may name the package on its command line)."""
    out, pid = set(), os.getpid()
    while pid > 1 and pid not in out:
        out.add(pid)
        try:
            with open(f"/proc/{pid}/stat") as f:
                pid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            break
    return out


def _http_post(port, path, payload):
    import urllib.request  # noqa: PLC0415

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def deployment_phase(torch, llama, card):
    """Serve on the card (``init(num_cpus=4)``): build_llm_deployment
    serves Llama-3-8B's widths at DEPLOY_LAYERS layers (random weights
    from seed 0, bf16, slots=2,
    max_seq=4096, max_ongoing_requests=8) from replicas, each in its own
    worker process, deployed together: "llm", two replicas with
    bucketed prefill, whose prefills of 128 tokens and more run the sm90
    flash forward, and "sessions", one replica with the reference's
    serving default (chunks of 64), kv_idle_evict_s and
    kv_offload="auto" — the object-plane store in a replica.  Each
    replica warms up before it reports ready (DEPLOY_WARMUP).  Through
    the DeploymentHandle: one completion, chat, stream and short
    completion alone, then the same from four driver threads; over
    HTTP, when aiohttp is installed, a completion and an SSE stream.  A
    session's turns around two idle evictions (a pause past
    kv_idle_evict_s, then a request that steps the engine) beside the
    same turns with no eviction.  A slab of that model's shape through
    a KvVault actor and ObjectPlaneKvStore(vault=...).  Gates: greedy
    tokens equal whichever replica answered, and over HTTP; both
    replicas served; each "llm" replica launched the sm90 forward
    n_layers times per bucketed prefill of 128 tokens or more and
    nothing else, "sessions" nothing; the sessions replica's store is
    ObjectPlaneKvStore, each offload one slot's k and v (134,217,728
    bytes at 8 layers), the continued turns' tokens those of the
    unevicted ones; the vault's slab back
    bitwise; serve.shutdown() and shutdown() leave no process, session
    directory or arena, and the card's memory comes back.  Returns the
    replicas' launches."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch import serve  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.kv_offload import (  # noqa: PLC0415
        KvVault, ObjectPlaneKvStore)
    from ant_ray_tpu_torch.llm.serve_llm import \
        build_llm_deployment  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              n_layers=DEPLOY_LAYERS)
    # One slot's k and v in bf16: what each offload moves.
    slot_bytes = (2 * cfg.n_layers * DEPLOY_SERVER["max_seq"]
                  * cfg.n_kv_heads * cfg.head_dim * 2)
    rng = np.random.default_rng(17)
    ids = {k: rng.integers(0, cfg.vocab_size, n).tolist()
           for k, n in DEPLOY_PROMPTS.items() if k != "chat"}
    words = "".join(chr(97 + int(c)) for c in rng.integers(
        0, 26, DEPLOY_PROMPTS["chat"]))
    requests = {
        "completion": {"prompt": ids["completion"]},
        "chat": {"messages": [{"role": "user", "content": words}]},
        "stream": {"prompt": ids["stream"]},
        "short": {"prompt": ids["short"]}}
    for r in requests.values():
        r["max_tokens"] = DEPLOY_TOKENS
    http = importlib.util.find_spec("aiohttp") is not None
    out = {"card": card, "model": "llama3-8b", "layers": DEPLOY_LAYERS,
           "aiohttp": http,
           "grpcio": importlib.util.find_spec("grpc") is not None}
    server_cls = _deployed_server_cls()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    # Every call of the phase runs under an unsampled trace context: a
    # call without one is head-sampled (trace_sample_rate).
    scope = tracing_plane.set_current(tracing_plane.mint(sampled=False))
    art.init(num_cpus=4, _system_config=QUIET)
    runtime = global_worker.runtime
    session_dir, store_dir = runtime.session_dir, runtime.store_dir
    daemons = [p.pid for p in runtime._owned_processes]
    workers = set()

    def timed(fn):
        t0 = time.perf_counter()
        value = fn()
        return value, time.perf_counter() - t0

    def replicas_of(name):
        controller = art.get_actor(serve.CONTROLLER_NAME, namespace="_serve")
        info = art.get(controller.get_handle_info.remote(name), timeout=60)
        return info["replicas"]

    def reports(name):
        return [art.get(r.handle_request.remote("report", (), {}),
                        timeout=120) for r in replicas_of(name)]

    try:
        # The two deployments, with build_llm_deployment's arguments,
        # deployed together (the controller first).
        apps = {
            "llm": (build_llm_deployment(
                cfg, name="llm", num_replicas=2,
                prefill_chunk_tokens=None,
                route_prefix="/v1" if http else None, **DEPLOY_SERVER),
                0 if http else None),
            "sessions": (build_llm_deployment(
                cfg, name="sessions", num_replicas=1,
                route_prefix=None, kv_idle_evict_s=DEPLOY_IDLE_EVICT_S,
                kv_offload="auto", **DEPLOY_SERVER), None)}
        serve.api._get_or_create_controller()
        handles, run_errors = {}, []

        def deploy(name):
            app, port = apps[name]
            app = dataclasses.replace(app, deployment=dataclasses.replace(
                app.deployment, cls_or_fn=server_cls))
            try:
                handles[name] = timed(lambda: serve.run(app, port=port))
            except BaseException as e:  # noqa: BLE001 — raised below
                run_errors.append(e)

        runs = [threading.Thread(target=deploy, args=(n,)) for n in apps]
        for t in runs:
            t.start()
        for t in runs:
            t.join()
        if run_errors:
            raise run_errors[0]
        (handle, out["llm_run_s"]), (sessions, out["sessions_run_s"]) = \
            handles["llm"], handles["sessions"]
        out["replica_build_warm_s"] = {
            name: [(r["build_s"], r["warm_s"]) for r in reports(name)]
            for name in ("llm", "sessions")}
        print(f"deployment up ({card}): serve.run llm "
              f"{out['llm_run_s']:.3f} s, sessions "
              f"{out['sessions_run_s']:.3f} s, together; replicas' build "
              f"and warm-up s {out['replica_build_warm_s']}", flush=True)

        def send(kind):
            if kind == "stream":
                gen = handle.options(method_name="stream", stream=True
                                     ).remote(dict(requests[kind]))
                chunks = [art.get(ref, timeout=300) for ref in gen]
                return [c["choices"][0].get("token_id") for c in chunks]
            reply = art.get(handle.remote(dict(requests[kind])), timeout=300)
            choice = reply["choices"][0]
            tokens = (choice.get("token_ids") if kind != "chat"
                      else choice["message"]["content"])
            return tokens, reply["replica_pid"]

        # Alone, one of each kind, then four threads each sending every
        # kind.
        walls = {"alone": {}, "threads": {k: [] for k in DEPLOY_KINDS}}
        alone = {}
        for kind in DEPLOY_KINDS:
            alone[kind], walls["alone"][kind] = timed(lambda: send(kind))
        results = {k: [] for k in DEPLOY_KINDS}
        errors = []

        def client(i):
            try:
                for kind in DEPLOY_KINDS[i % 4:] + DEPLOY_KINDS[:i % 4]:
                    value, wall = timed(lambda: send(kind))
                    results[kind].append(value)
                    walls["threads"][kind].append(wall)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(DEPLOY_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["threads_wall_s"] = round(time.perf_counter() - t0, 3)
        if errors:
            raise errors[0]
        out["wall_s"] = {
            "alone": {k: round(v, 4) for k, v in walls["alone"].items()},
            "threads_median": {k: round(statistics.median(v), 4)
                               for k, v in walls["threads"].items()}}
        pids = {}
        for kind in DEPLOY_KINDS:
            want = alone[kind]
            for got in results[kind]:
                if kind == "stream":
                    if got != want or len(got) != DEPLOY_TOKENS + 1:
                        raise AssertionError(f"a stream gave {got}, "
                                             f"alone {want}")
                    continue
                pids.setdefault(kind, set()).add(got[1])
                if got[0] != want[0]:
                    raise AssertionError(
                        f"{kind}: replica {got[1]} answered {got[0]}, "
                        f"replica {want[1]} {want[0]}")
        out["completion_replicas"] = len(pids["completion"])
        if len(alone["completion"][0]) != DEPLOY_TOKENS or \
                len(alone["stream"]) != DEPLOY_TOKENS + 1:
            raise AssertionError("the completion or the stream is short")
        print(f"deployment walls ({card}): " + json.dumps(out["wall_s"]),
              flush=True)

        # HTTP: a completion and an SSE stream through the proxy.
        if http:
            port = serve.api.run.last_http_port
            code, ctype, raw = _http_post(
                port, "/v1/completions",
                {"prompt": ids["http"], "max_tokens": DEPLOY_TOKENS})
            via_http = json.loads(raw)["result"]["choices"][0]["token_ids"]
            code_s, ctype_s, raw_s = _http_post(
                port, "/v1/completions", {"prompt": ids["http"],
                                          "max_tokens": DEPLOY_TOKENS,
                                          "stream": True})
            frames = [ln[6:] for ln in raw_s.decode().splitlines()
                      if ln.startswith("data: ")]
            sse = [json.loads(f)["choices"][0].get("token_id")
                   for f in frames[:-1]]
            direct = art.get(handle.remote(
                {"prompt": ids["http"], "max_tokens": DEPLOY_TOKENS}),
                timeout=300)["choices"][0]["token_ids"]
            out["http"] = {"status": [code, code_s],
                           "content_type": [ctype, ctype_s],
                           "sse_frames": len(frames)}
            if (code, code_s) != (200, 200) or via_http != direct or \
                    sse[:-1] != direct or frames[-1] != "[DONE]" or \
                    ctype_s != "text/event-stream":
                raise AssertionError(f"HTTP: {out['http']}, tokens "
                                     f"{via_http} / {sse} / {direct}")
        else:
            out["http"] = "aiohttp is not installed: deployed with " \
                          "route_prefix=None"

        # A session's turns around two idle evictions (the replica's
        # first offload and restore, then warm ones), beside the same
        # turns with no eviction (a second session, ended after).
        def turn(kind, sid):
            reply = sessions.call({"prompt": ids[kind], "session_id": sid,
                                   "max_tokens": DEPLOY_TOKENS},
                                  timeout_s=300)
            return reply["choices"][0]["token_ids"]

        kinds = ("turn1", "turn2", "turn3")
        plain = [turn(kind, "plain") for kind in kinds]
        if not sessions.options(method_name="end_session").call("plain"):
            raise AssertionError("end_session('plain') found no session")
        marks = reports("sessions")
        got = [turn(kinds[0], "s")]
        for kind in kinds[1:]:
            time.sleep(DEPLOY_IDLE_EVICT_S + 0.5)
            turn("filler", None)        # its steps run the idle sweep
            marks += reports("sessions")
            got.append(turn(kind, "s"))
        marks += reports("sessions")
        sessions.options(method_name="end_session").call("s")
        before, evicted1, evicted2, after = marks

        def delta(key, a=before, b=after):
            return b["stats"][key] - a["stats"][key]

        times = after["times_s"]
        out["session"] = {
            "store": after["store"],
            "idle_evictions": delta("idle_evictions"),
            "offload_bytes": [delta("offload_bytes", before, evicted1),
                              delta("offload_bytes", evicted1, evicted2)],
            "restores": delta("restores"),
            "tokens_equal": got == plain,
            **{f"{key[:-2]}_ms": [round(t * 1e3, 3) for t in
                                  times.get(key, [])]
               for key in ("extract_s", "put_s", "get_s")},
            "restore_wait_ms": [
                round(delta("restore_wait_s", evicted1, evicted2) * 1e3, 3),
                round(delta("restore_wait_s", evicted2) * 1e3, 3)],
            "install_host_ms": [round(t * 1e3, 3)
                                for t in after["install_host_s"]],
            "install_card_ms": [round(t, 3)
                                for t in after["install_card_ms"]]}
        print(f"deployment session ({card}): "
              + json.dumps(out["session"]), flush=True)
        if out["session"]["store"] != "ObjectPlaneKvStore" or \
                out["session"]["idle_evictions"] != 2 or \
                out["session"]["offload_bytes"] != [slot_bytes] * 2 or \
                out["session"]["restores"] != 2 or \
                not out["session"]["tokens_equal"]:
            raise AssertionError(f"the session through the object-plane "
                                 f"store: {out['session']}")

        # The vault: a slab of the model's shape through a KvVault actor.
        vault = art.remote(KvVault).remote()
        art.get(vault.put.remote("warm", 1), timeout=300)   # the actor is up
        store = ObjectPlaneKvStore(vault=vault, get_timeout_s=300.0)
        gen = torch.Generator(device="cuda").manual_seed(17)
        shape = (cfg.n_layers, DEPLOY_SERVER["max_seq"], cfg.n_kv_heads,
                 cfg.head_dim)
        slab = tuple(torch.randn(shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16).cpu()
                     for _ in range(2))
        nbytes = sum(t.numel() * t.element_size() for t in slab)
        _, put_s = timed(lambda: store.put("slab", (*slab, 4096)))
        (k, v, length), get_s = timed(lambda: store.get("slab"))
        out["vault"] = {
            "bytes": nbytes, "put_ms": round(put_s * 1e3, 3),
            "put_gb_s": round(nbytes / put_s / 1e9, 3),
            "fetch_ms": round(get_s * 1e3, 3),
            "fetch_gb_s": round(nbytes / get_s / 1e9, 3),
            "bitwise": length == 4096 and all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(slab, (k, v)))}
        del slab, k, v
        art.kill(vault)
        if not out["vault"]["bitwise"]:
            raise AssertionError("the vault's slab came back changed")

        # The replicas' kernels: n_layers sm90 forward launches per
        # bucketed prefill of 128 tokens or more, nothing in "sessions".
        launches = {}
        out["replicas"] = {}
        for name in ("llm", "sessions"):
            for r in reports(name):
                want = (0 if name == "sessions" else cfg.n_layers * sum(
                    _bucket(n, DEPLOY_SERVER["max_seq"]) >= 128
                    for n in r["prompt_lens"]))
                out["replicas"][r["pid"]] = {
                    "deployment": name, "served": r["served"],
                    "launches": r["launches"], "want_fwd_sm90": want}
                if r["launches"] != {**dict.fromkeys(r["launches"], 0),
                                     "fwd": want, "fwd_sm90": want}:
                    raise AssertionError(
                        f"replica {r['pid']} of {name} launched "
                        f"{r['launches']}, expected {want} sm90 forward "
                        "launches")
                for key, n in r["launches"].items():
                    launches[key] = launches.get(key, 0) + n
        served = [r["served"] for r in out["replicas"].values()
                  if r["deployment"] == "llm"]
        if len(served) != 2 or min(served) == 0:
            raise AssertionError(f"a replica of llm served nothing: {served}")
        out["launches"] = launches
        workers.update(c for d in daemons for c in _child_pids(d))
    except BaseException:
        _print_worker_logs(session_dir)
        print("deployment (failed) " + json.dumps(out, default=str),
              flush=True)
        try:
            serve.shutdown()
        finally:
            art.shutdown()
            tracing_plane.reset(scope)
        raise
    t0 = time.perf_counter()
    serve.shutdown()
    art.shutdown()
    tracing_plane.reset(scope)
    _after_shutdown(torch, out, t0, daemons + sorted(workers), session_dir,
                    store_dir, free_before)
    print("deployment " + json.dumps(out, default=str), flush=True)
    _gate_nothing_left(out)
    return launches


def _after_shutdown(torch, out, t0, pids, session_dir, store_dir,
                    free_before):
    """Into ``out``, after a cluster's shutdown() that began at ``t0``:
    the seconds until its processes (``pids``) were gone, any left alive
    or found by pgrep, whether its session directory or arena are left,
    and whether the card's free memory came back."""
    deadline = time.monotonic() + CLUSTER_EXIT_WAIT_S
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["shutdown_s"] = round(time.perf_counter() - t0, 3)
    out["left_alive"] = [p for p in pids if _pid_alive(p)]
    out["pgrep"] = [int(p) for p in subprocess.run(
        ["pgrep", "-f", "ant_ray_tpu_torch"], capture_output=True,
        text=True).stdout.split() if int(p) not in _ancestors()]
    out["session_dir_left"] = os.path.exists(session_dir)
    out["arena_left"] = os.path.exists(store_dir)
    out["card_free_back"] = _card_free_back(torch, free_before)


def _card_free_back(torch, free_before):
    """Whether the card's free memory comes back within
    CLUSTER_FREE_SLACK of ``free_before`` inside CLUSTER_FREE_WAIT_S."""
    torch.cuda.empty_cache()
    deadline = time.monotonic() + CLUSTER_FREE_WAIT_S
    while torch.cuda.mem_get_info()[0] < free_before - CLUSTER_FREE_SLACK \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    return torch.cuda.mem_get_info()[0] >= free_before - CLUSTER_FREE_SLACK


def _gate_nothing_left(out):
    if out["left_alive"] or out["pgrep"] or out["session_dir_left"] or \
            out["arena_left"] or not out["card_free_back"] or \
            out.get("channels_left"):
        raise AssertionError("shutdown left a process, the session "
                             "directory, the arena, a DAG's channel file "
                             "or card memory behind")


DATA_ROWS = 32                  # prompts through build_llm_processor
DATA_PROMPT_LENS = (128, 1500)  # their lengths, drawn from default_rng(18)
DATA_TOKENS = 16                # new tokens per prompt (greedy)
DATA_BLOCKS = 8                 # from_items(rows, parallelism=...)
DATA_PROCESSOR = dict(concurrency=2, slots=8, max_seq=4096)
# The depth of the model that generates and scores: Llama-3-8B's widths
# with its depth cut from 32 layers to this, to pay for the jobs phase
# in the time limit.
DATA_LAYERS = 8
DATA_SCORE = dict(rows=64, tokens=1024, batch_size=8)
DATA_TABLE = (1_000_000, 16)    # rows and blocks of the Data operations
DATA_GROUPS = 1000              # groupby keys: value % DATA_GROUPS
# |NLL| per row of build_logprob_processor (blockwise attention, which
# rounds p to bf16 before P.V) against reference attention (fp32
# softmax) on the same bf16 weights (tools/phase.py data --readings,
# NVIDIA H100 80GB HBM3, 700.00 W).  At Llama-3-8B's 32 layers the sound
# reading was 4.72e-3 on NLLs of 12.49-12.67, alike at prefetch 2 and 0,
# and the faults of _blockwise_faults 9.96e-2 (the ragged last block
# dropped) and 1.13e-1 (no causal mask); at DATA_LAYERS (8) they read
# 2.22e-3 on 12.48-12.65, and 9.41e-2 and 1.38e-1.  The limit lies
# between: 9x the sound reading at 8 layers, a fifth of the nearer
# fault's.
DATA_NLL_TOL = 2e-2
DATA_BLOCK_K = 512              # blockwise_attention's default block_k


def _group_of(value):
    return value % DATA_GROUPS


def _blockwise_faults(attn):
    """Faults planted in ``attn.blockwise_attention`` for the NLL gate's
    readings: at 1023 tokens the last KV block (511 keys) is ragged.
    Returns the sound function and the faulty ones by name."""
    sound = attn.blockwise_attention

    def ragged_block_dropped(q, k, v, **kw):
        n = k.shape[1] - k.shape[1] % DATA_BLOCK_K or k.shape[1]
        return sound(q, k[:, :n], v[:, :n], **kw)

    def not_causal(q, k, v, **kw):
        return sound(q, k, v, **{**kw, "causal": False})

    return sound, {"ragged_block_dropped": ragged_block_dropped,
                   "not_causal": not_causal}


def _actor_call(art, actor, name, *args):
    """A private method of an engine actor (llm/batch.py ``_launches``,
    ``_token_ids``), called through ActorMethod."""
    from ant_ray_tpu_torch.actor import ActorMethod  # noqa: PLC0415

    return art.get(ActorMethod(actor, name, 1, "").remote(*args),
                   timeout=600)


def _actor_launches(art, actor):
    """An engine actor's launch counters as a _counts() dict."""
    return _counts(types.SimpleNamespace(
        **_actor_call(art, actor, "_launches")))


def data_phase(torch, llama, card, readings=False):
    """Data and batch inference on the card (``init(num_cpus=4)``).

    (a) build_llm_processor(<Llama-3-8B at DATA_LAYERS layers>,
    concurrency=2, slots=8, max_seq=4096, device="cuda") over
    from_items of 32 rows {"id",
    "prompt": token ids of 128-1500, default_rng(18)} in 8 blocks, 16
    greedy tokens each: two actors, each its own engine (random weights
    from seed 0) in its own worker process.  Gates: 32 rows back in
    order, each with its keys unchanged and "generated_text" added; each
    actor launched the sm90 forward DATA_LAYERS times per bucketed
    prefill it ran (all of them: every prompt is 128 tokens or more) and
    nothing else, 256 between the two; the actors' generated token ids
    (llm/batch.py
    ``_token_ids``) are read back block by block.  (b) With the actors
    killed and the card's memory back,
    build_logprob_processor(<the same model>, batch_size=8,
    max_len=1024) in the driver over 64 rows of 1024 token ids, with
    prefetch_batches=2 and 0 (after one untimed pass, which loads the
    forward's kernels).  Gates: each batch on the card bitwise
    the collated host batch; NLL per row equal at both settings and
    within DATA_NLL_TOL of the plain path (reference attention, the same
    cross-entropy) on the same weights; no flash launch (blockwise by
    the reference's multiple-of-128 rule at 1023 tokens).  With
    ``readings`` the tolerance is not gated, and each fault of
    _blockwise_faults is read in one more pass at prefetch 0.  (c)
    random_shuffle(seed=0), sort and groupby(value % 1000).count() of
    1,000,000 list-block ints in 16 blocks, equal to numpy's, without
    loading pyarrow in the driver.  Then shutdown() leaves nothing, and one
    LLMEngine(<the same model>, slots=8, max_seq=4096) in the driver must
    generate the actors' token ids row by row, 16 a row, and their
    texts.  Returns the actors' launches."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    import torch.nn.functional as F  # noqa: PLC0415

    from ant_ray_tpu_torch import data  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.data import device_feed  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import (  # noqa: PLC0415
        LLMEngine, SamplingParams, build_llm_processor,
        build_logprob_processor)
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    # The module, not the package's attention() of the same name.
    attn = importlib.import_module("ant_ray_tpu_torch.ops.attention")
    cfg = llama.CONFIGS["llama3-8b"]
    model_cfg = dataclasses.replace(cfg, n_layers=DATA_LAYERS)
    nll_tol = None if readings else DATA_NLL_TOL
    sound, faults = _blockwise_faults(attn)
    rng = np.random.default_rng(18)
    lens = rng.integers(DATA_PROMPT_LENS[0], DATA_PROMPT_LENS[1] + 1,
                        DATA_ROWS)
    rows = [{"id": i, "prompt": rng.integers(0, cfg.vocab_size,
                                             int(n)).tolist()}
            for i, n in enumerate(lens)]
    scored = [{"tokens": rng.integers(1, cfg.vocab_size,
                                      DATA_SCORE["tokens"]).tolist()}
              for _ in range(DATA_SCORE["rows"])]
    values = rng.integers(0, 1 << 30, DATA_TABLE[0])
    sampling = SamplingParams(max_tokens=DATA_TOKENS)
    gib = 1 << 30
    out = {"card": card, "model": "llama3-8b",
           "generating_layers": DATA_LAYERS,
           "pyarrow": importlib.util.find_spec("pyarrow") is not None,
           "pandas": importlib.util.find_spec("pandas") is not None}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    scope = tracing_plane.set_current(tracing_plane.mint(sampled=False))
    art.init(num_cpus=4, _system_config=QUIET)
    runtime = global_worker.runtime
    session_dir, store_dir = runtime.session_dir, runtime.store_dir
    daemons = [p.pid for p in runtime._owned_processes]
    to_device, hand_over = (device_feed.DeviceFeed._to_device,
                            device_feed.DeviceFeed._hand_over)
    try:
        # (a) Generation through two engine actors.
        t0 = time.perf_counter()
        process = build_llm_processor(model_cfg, sampling=sampling,
                                      device="cuda", **DATA_PROCESSOR)
        actors = process._actors
        starts, fresh = [None] * len(actors), [None] * len(actors)

        def first_answer(i):
            _actor_call(art, actors[i], "_token_ids")     # keep them
            fresh[i] = _actor_launches(art, actors[i])
            starts[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=first_answer, args=(i,))
                   for i in range(len(actors))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["actor_start_s"] = [round(s, 3) for s in starts]
        out["card_free_gib"] = {
            "before": round(free_before / gib, 3),
            "with_actors": round(torch.cuda.mem_get_info()[0] / gib, 3)}
        print(f"data actors up ({card}): start s {out['actor_start_s']}, "
              f"card free GiB {out['card_free_gib']}", flush=True)
        if any(any(c.values()) for c in fresh):
            raise AssertionError(f"a new engine actor had launched: {fresh}")

        ds = data.from_items(rows, parallelism=DATA_BLOCKS)
        t1 = time.perf_counter()
        result = process(ds)
        refs = list(result._block_refs)
        done = {}
        while len(done) < len(refs):
            ready, _ = art.wait([r for r in refs if r not in done],
                                num_returns=1, timeout=900)
            if not ready:
                raise AssertionError("a block of the processor took more "
                                     "than 900 s")
            now = time.perf_counter() - t1
            for r in ready:
                done[r] = now
        got = result.take_all()
        wall = time.perf_counter() - t1
        done_at = [done[r] for r in refs]
        n = DATA_PROCESSOR["concurrency"]
        out["block_walls_s"] = [round(done_at[i] - (done_at[i - n] if i >= n
                                                    else 0.0), 3)
                                for i in range(len(refs))]
        out["generation_wall_s"] = round(wall, 3)
        print(f"data blocks ({card}): walls s {out['block_walls_s']} "
              f"(blocks {list(range(n))} are each actor's first)",
              flush=True)
        if len(got) != DATA_ROWS or [
                {k: v for k, v in r.items() if k != "generated_text"}
                for r in got] != rows or not all(
                isinstance(r.get("generated_text"), str) for r in got):
            raise AssertionError("the processor's rows came back changed, "
                                 "out of order or without generated_text")
        kept = [_actor_call(art, a, "_token_ids", False) for a in actors]
        if [len(k) for k in kept] != [len(range(i, len(refs), n))
                                      for i in range(n)]:
            raise AssertionError(f"the actors kept {[len(k) for k in kept]}"
                                 f" blocks of token ids for {len(refs)}")
        ids = [row for b in range(len(refs)) for row in kept[b % n][b // n]]
        launches, per_actor = {}, []
        for i, actor in enumerate(actors):
            counts = _actor_launches(art, actor)
            mine = [len(rows[j]["prompt"]) for b in range(i, DATA_BLOCKS, n)
                    for j in range(b * DATA_ROWS // DATA_BLOCKS,
                                   (b + 1) * DATA_ROWS // DATA_BLOCKS)]
            want = model_cfg.n_layers * sum(
                _bucket(m, DATA_PROCESSOR["max_seq"]) >= 128 for m in mine)
            per_actor.append({"fwd_sm90": counts["fwd_sm90"],
                              "want": want})
            if counts != {**dict.fromkeys(counts, 0), "fwd": want,
                          "fwd_sm90": want}:
                raise AssertionError(f"actor {i} launched {counts}, "
                                     f"expected {want} sm90 forwards")
            for key, v in counts.items():
                launches[key] = launches.get(key, 0) + v
        out["actor_launches"] = per_actor
        if launches["fwd_sm90"] != model_cfg.n_layers * DATA_ROWS:
            raise AssertionError(f"the actors launched {launches}")
        for actor in actors:
            art.kill(actor)
        del process, actors, result
        out["card_free_back_after_kill"] = _card_free_back(torch,
                                                           free_before)
        out["card_free_gib"]["after_kill"] = round(
            torch.cuda.mem_get_info()[0] / gib, 3)
        if not out["card_free_back_after_kill"]:
            raise AssertionError("the card's memory did not come back "
                                 "after the engine actors were killed")

        # (b) Scoring through the device feed, in the driver.
        seen = {"host": [], "card": [], "feeds": []}

        def spy_to_device(self, tree):
            if self not in seen["feeds"]:
                seen["feeds"].append(self)
            seen["host"].append({k: a.copy() for k, a in tree.items()})
            return to_device(self, tree)

        def spy_hand_over(self, tree, event):
            tree = hand_over(self, tree, event)
            seen["card"].append(tree)
            return tree

        device_feed.DeviceFeed._to_device = spy_to_device
        device_feed.DeviceFeed._hand_over = spy_hand_over
        _reset_counts(fa)
        nll, out["score"] = {}, {}
        for prefetch in (2, 0):
            proc = build_logprob_processor(
                model_cfg, batch_size=DATA_SCORE["batch_size"],
                max_len=DATA_SCORE["tokens"], prefetch_batches=prefetch)
            if prefetch == 2:           # warm: the process's first pass
                proc(data.from_items(scored, parallelism=DATA_BLOCKS))
            for v in seen.values():
                v.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scored_rows = proc(data.from_items(
                scored, parallelism=DATA_BLOCKS)).take_all()
            wall = time.perf_counter() - t0
            stats = dict(seen["feeds"][0].stats)
            bitwise = len(seen["host"]) == len(seen["card"]) == \
                DATA_SCORE["rows"] // DATA_SCORE["batch_size"] and all(
                    h.keys() == c.keys() and all(
                        c[k].device.type == "cuda" and torch.equal(
                            c[k].cpu(), torch.from_numpy(h[k]))
                        for k in h)
                    for h, c in zip(seen["host"], seen["card"]))
            nll[prefetch] = [r["nll"] for r in sorted(
                scored_rows, key=lambda r: r["row"])]
            out["score"][f"prefetch_{prefetch}"] = {
                "wall_s": round(wall, 4), "bitwise": bitwise,
                **{k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in stats.items()}}
            print(f"data score ({card}) prefetch={prefetch}: "
                  + json.dumps(out["score"][f"prefetch_{prefetch}"]),
                  flush=True)
            if readings and prefetch == 0:
                faulted = {}
                for name, fault in faults.items():
                    attn.blockwise_attention = fault
                    try:
                        faulted[name] = [r["nll"] for r in sorted(
                            proc(data.from_items(
                                scored, parallelism=DATA_BLOCKS)).take_all(),
                            key=lambda r: r["row"])]
                    finally:
                        attn.blockwise_attention = sound
            del proc, scored_rows
            seen["card"].clear()
            torch.cuda.empty_cache()
            if not bitwise:
                raise AssertionError(f"prefetch={prefetch}: the feed's card "
                                     "batches differ from the host's")
        score_counts = _counts(fa)
        device_feed.DeviceFeed._to_device = to_device
        device_feed.DeviceFeed._hand_over = hand_over
        if any(score_counts.values()):
            raise AssertionError(f"the scoring path launched flash "
                                 f"kernels: {score_counts}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(model_cfg, generator=gen, device="cuda")
        tokens = torch.tensor([r["tokens"] for r in scored],
                              dtype=torch.long, device="cuda")
        plain = []
        with torch.inference_mode():
            for b in range(0, len(scored), DATA_SCORE["batch_size"]):
                toks = tokens[b:b + DATA_SCORE["batch_size"]]
                logits = llama.forward(params, toks[:, :-1], model_cfg,
                                       attn_impl="reference")
                losses = F.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    toks[:, 1:].reshape(-1), reduction="none").view(
                        toks.shape[0], -1)
                plain += losses.mean(-1).tolist()
                del logits, losses
        del params, tokens
        torch.cuda.empty_cache()
        out["nll_max_abs_err"] = {
            f"prefetch_{p}": float(max(abs(a - b) for a, b in
                                       zip(nll[p], plain)))
            for p in nll}
        out["nll_prefetch_equal"] = nll[2] == nll[0]
        out["nll_range"] = [round(min(plain), 4), round(max(plain), 4)]
        out["nll_tol"] = nll_tol
        if readings:
            out["nll_fault_err"] = {
                name: float(max(abs(a - b) for a, b in zip(f, plain)))
                for name, f in faulted.items()}
        print(f"data nll ({card}): max abs err against the plain path "
              f"{out['nll_max_abs_err']}, planted faults "
              f"{out.get('nll_fault_err', 'not read')}, range "
              f"{out['nll_range']}, tol {nll_tol}", flush=True)
        if not out["nll_prefetch_equal"]:
            raise AssertionError("the NLL per row differs between prefetch "
                                 "2 and 0")
        if nll_tol is not None and max(out["nll_max_abs_err"].values()) \
                > nll_tol:
            raise AssertionError(f"NLL off the plain path: "
                                 f"{out['nll_max_abs_err']} > {nll_tol}")

        # (c) List-block Data at a million rows.
        pyarrow_before = "pyarrow" in sys.modules
        table = data.from_items(values.tolist(), parallelism=DATA_TABLE[1])
        want_sorted = np.sort(values)
        ops = {"random_shuffle": lambda: table.random_shuffle(seed=0),
               "sort": lambda: table.sort(),
               "groupby_count": lambda: table.groupby(_group_of).count()}
        results, out["table"] = {}, {}
        for name, op in ops.items():
            t0 = time.perf_counter()
            results[name] = op().take_all()
            sec = time.perf_counter() - t0
            out["table"][name] = {"s": round(sec, 3),
                                  "rows_per_s": round(DATA_TABLE[0] / sec)}
        counts = np.bincount(values % DATA_GROUPS, minlength=DATA_GROUPS)
        groups = sorted((r["key"], r["count"])
                        for r in results["groupby_count"])
        out["table_equal"] = {
            "random_shuffle": bool(np.array_equal(
                np.sort(results["random_shuffle"]), want_sorted))
            and results["random_shuffle"] != values.tolist(),
            "sort": bool(np.array_equal(results["sort"], want_sorted)),
            "groupby_count": groups == [(g, int(c)) for g, c in
                                        enumerate(counts) if c]}
        out["pyarrow_in_driver"] = [pyarrow_before, "pyarrow" in sys.modules]
        print(f"data table ({card}, pyarrow installed: {out['pyarrow']}, "
              f"in the driver before and after: {out['pyarrow_in_driver']}"
              "): " + json.dumps(out["table"]), flush=True)
        if not all(out["table_equal"].values()):
            raise AssertionError(f"Data's results differ from numpy's: "
                                 f"{out['table_equal']}")
        if out["pyarrow_in_driver"] == [False, True]:
            raise AssertionError("list-block Data loaded pyarrow")
        workers = {c for d in daemons for c in _child_pids(d)}
    except BaseException:
        device_feed.DeviceFeed._to_device = to_device
        device_feed.DeviceFeed._hand_over = hand_over
        attn.blockwise_attention = sound
        _print_worker_logs(session_dir)
        print("data (failed) " + json.dumps(out, default=str), flush=True)
        try:
            art.shutdown()
        finally:
            tracing_plane.reset(scope)
        raise
    t0 = time.perf_counter()
    art.shutdown()
    tracing_plane.reset(scope)
    _after_shutdown(torch, out, t0, daemons + sorted(workers), session_dir,
                    store_dir, free_before)
    _gate_nothing_left(out)
    out["card_free_gib"]["after_shutdown"] = round(
        torch.cuda.mem_get_info()[0] / gib, 3)

    # The same prompts through one engine in the driver.
    engine = LLMEngine(model_cfg, slots=DATA_PROCESSOR["slots"],
                       max_seq=DATA_PROCESSOR["max_seq"])
    direct = engine.generate([r["prompt"] for r in rows], sampling)
    del engine
    torch.cuda.empty_cache()
    want = [list(o.token_ids) for o in direct]
    out["token_ids_equal"] = ids == want
    out["tokens_per_row"] = sorted({len(t) for t in want})
    out["texts_equal"] = [o.text for o in direct] == \
        [r["generated_text"] for r in got]
    n_tokens = sum(len(t) for t in want)
    out["generation"] = {
        "rows_per_s": round(DATA_ROWS / out["generation_wall_s"], 3),
        "generated_tokens": n_tokens,
        "generated_tokens_per_s": round(n_tokens / out["generation_wall_s"],
                                        3)}
    print(f"data generation ({card}): {DATA_ROWS} rows in "
          f"{out['generation_wall_s']} s: " + json.dumps(out["generation"]),
          flush=True)
    print("data " + json.dumps(out, default=str), flush=True)
    if out["tokens_per_row"] != [DATA_TOKENS]:
        raise AssertionError(f"the driver's engine generated "
                             f"{out['tokens_per_row']} tokens a row, not "
                             f"{DATA_TOKENS}")
    if not (out["token_ids_equal"] and out["texts_equal"]):
        diff = [i for i, (o, r, t) in enumerate(zip(direct, got, ids))
                if list(o.token_ids) != t or o.text != r["generated_text"]]
        raise AssertionError(f"rows {diff} differ from the driver's engine")
    return launches


OPS_CONFIG = {"include_dashboard": True, "enable_node_agent": True,
              "device_stats_interval_s": 2.0, "enable_insight": True,
              "lockcheck": True}
OPS_ENGINE = dict(slots=4, max_seq=2048)
OPS_PROMPT_LENS = (256, 1024)   # 4 prompts, lengths from default_rng(19)
OPS_PROMPTS = 4
OPS_TOKENS = 16                 # new tokens per prompt (greedy)
OPS_PROFILE_S = 2.0             # POST /api/profile's duration
OPS_WEIGHT_BYTES = 16.06e9      # Llama-3-8B's bf16 weights
OPS_SMI_SLACK = 1 << 30         # the agent's gauge against nvidia-smi
OPS_SAMPLE_COST_S = 300e-6      # the reference's per-sample bound
OPS_PROCS = ("driver", "gcs", "daemon", "worker", "agent")
OPS_WAIT_S = 60.0               # for gauges and profiles to reach the GCS


def _ops_prompts(cfg):
    """The operations phase's prompt lengths and token ids (4 prompts of
    256-1024 ids from default_rng(19)); the jobs phase sends the same."""
    rng = np.random.default_rng(19)
    lens = rng.integers(OPS_PROMPT_LENS[0], OPS_PROMPT_LENS[1] + 1,
                        OPS_PROMPTS)
    return lens, [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                  for n in lens]


def _io_loops(gcs, since_ts):
    """What the GCS's and the node daemon's io loops did since
    ``since_ts``, from the CPU profiler's ring: per process class the io
    thread's samples, its busy share (samples whose leaf is not the
    selector's wait), the busiest publish window's share, and its three
    heaviest busy stacks (their last four frames)."""
    records = gcs.call("CpuProfileGet", {"since_ts": since_ts},
                       timeout=30) or []
    out = {}
    for proc in ("gcs", "daemon"):
        total = busy = 0
        worst = 0.0
        stacks = {}
        for record in records:
            if record.get("proc") != proc:
                continue
            r_total = r_busy = 0
            for key, n in record["stacks"].items():
                parts = key.split(";")
                if len(parts) < 3 or parts[1] != "art-io":
                    continue
                r_total += n
                if ":select" in parts[-1] or ":poll" in parts[-1]:
                    continue
                r_busy += n
                tail = ";".join(parts[-4:])
                stacks[tail] = stacks.get(tail, 0) + n
            total, busy = total + r_total, busy + r_busy
            if r_total:
                worst = max(worst, r_busy / r_total)
        out[proc] = {"io_samples": total,
                     "busy_share": round(busy / total, 4) if total else None,
                     "worst_window_busy_share": round(worst, 4),
                     "top_busy": sorted(stacks.items(),
                                        key=lambda kv: -kv[1])[:3]}
    return out


def _deferred_ticks(session_dir):
    """Health ticks the GCS deferred because they woke late (its
    warnings in gcs.err)."""
    path = os.path.join(session_dir, "logs", "gcs.err")
    try:
        with open(path, errors="replace") as f:
            return sum("judging liveness on the next tick" in line
                       for line in f)
    except OSError:
        return None


def _whole_log(state, name):
    """All of a log file through ``get_log``, in the 4-MiB reads that
    ReadLog serves."""
    text, offset = "", 0
    while True:
        chunk = state.get_log(name, offset=offset, max_bytes=4 << 20)
        if not chunk:
            return text
        text += chunk
        offset += len(chunk.encode())


def _metric_values(text, name):
    """{labels: value} of one series family in Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            labels, value = line[len(name):].rsplit(" ", 1)
            out[labels] = float(value)
    return out


def operations_phase(torch, llama, card, keep=None):
    """The operator's surface on the card (``init(num_cpus=4,
    _system_config=OPS_CONFIG)``: the dashboard, a node agent publishing
    the card's memory every 2 s, the CPU profiler at its default 67 Hz
    in every process, flow insight, lockcheck's instrumented locks in
    every process).  A placement group ``[{"CPU": 1, "GPU": 1}]``
    (STRICT_PACK) holds one ``num_gpus=1`` actor with
    ``LLMEngine("llama3-8b", slots=4, max_seq=2048)`` (random weights
    from seed 0) in bundle 0; it generates 16 greedy tokens for 4 prompts
    of 256-1024 token ids (default_rng(19)) while ``POST /api/profile
    {"duration_s": 2}`` captures the agent's trace.  Gates, each printed:
    the actor's 32 sm90 forward launches per bucketed prefill and
    nothing else (counted in its process); ``/api/insight``'s call graph
    holds the driver's edge to ``OpsEngine.generate`` with its one call,
    run once without error; the group CREATED with its
    bundle on the node, ``/api/cluster_status`` GPU 1 total and 0 free
    while the actor lives and 1 free after the kill and the group's
    removal; ``list_actors`` shows the actor ALIVE at the address of a
    worker whose log ``list_logs`` names and ``get_log`` reads;
    ``/metrics`` carries the agent's ``art_device_hbm_bytes_in_use`` of
    the card at 16.06e9 or more, at most its limit and within 1 GiB of
    nvidia-smi's memory.used; ``/api/cpuprofile`` and ``python -m
    ant_ray_tpu_torch profile --json`` hold records of the driver, the
    GCS, the daemon, the worker and the agent, with the engine's or the
    model's frames in the worker's stacks, and the profiler's mean cost
    per sample under 300 µs in the driver and in the worker; the trace
    archive is listed and served by the log routes and holds a Chrome
    trace; ``status`` and ``list placement-groups`` through the CLI name
    the node, the GPU and the group; no log that ``list_logs`` names
    holds a lockcheck cycle report (its long-hold reports are counted).
    After shutdown nothing is left and
    the card's memory is back; then one LLMEngine of the same shape in
    the driver must generate the actor's token ids row by row (kept
    under ``keep["tokens"]`` where ``keep`` is a dict, for the jobs
    phase).  Also printed: the GCS's and the daemon's io loops while the
    actor started.  Returns the actor's launches."""
    import tarfile  # noqa: PLC0415
    import urllib.request  # noqa: PLC0415

    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch._lint import lockcheck  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415
    from ant_ray_tpu_torch.util import state  # noqa: PLC0415
    from ant_ray_tpu_torch.util.placement_group import (  # noqa: PLC0415
        placement_group, placement_group_table, remove_placement_group)

    cfg = llama.CONFIGS["llama3-8b"]
    lens, prompts = _ops_prompts(cfg)
    greedy = SamplingParams(max_tokens=OPS_TOKENS)
    want_launches = cfg.n_layers * sum(
        _bucket(int(n), OPS_ENGINE["max_seq"]) >= 128 for n in lens)

    @art.remote(num_gpus=1)
    class OpsEngine:
        def __init__(self):
            self.engine = LLMEngine("llama3-8b", seed=0, **OPS_ENGINE)
            torch.cuda.synchronize()
            print("operations actor ready", flush=True)

        def where(self):
            return os.getpid(), os.environ["ART_WORKER_ID"]

        def generate(self, rows):
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            _reset_counts(flash_attention)
            outs = self.engine.generate(rows, greedy)
            torch.cuda.synchronize()
            return [list(o.token_ids) for o in outs]

        def _launches(self):
            from ant_ray_tpu_torch.ops import flash_attention  # noqa: PLC0415

            return _counts(flash_attention)

        def _profiler_cost(self):
            return cpu_profiler.profiler().overhead_stats()

    def get(url):
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.read().decode()

    def cli(*args):
        env = dict(os.environ, ART_ADDRESS=runtime.gcs_address)
        proc = subprocess.run(
            [sys.executable, "-m", "ant_ray_tpu_torch", "--json", *args],
            capture_output=True, text=True, env=env, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"CLI {args} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return json.loads(proc.stdout)

    def gate(name, ok, detail):
        out["gates"][name] = bool(ok)
        print(f"operations gate {name} ({card}): "
              f"{'held' if ok else 'FAILED'}: {json.dumps(detail, default=str)}",
              flush=True)
        if not ok:
            raise AssertionError(f"operations gate {name} failed: {detail}")

    gib = 1 << 30
    out = {"card": card, "model": "llama3-8b", "gates": {},
           "prompt_lens": [int(n) for n in lens]}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    scope = tracing_plane.set_current(tracing_plane.mint(sampled=False))
    ctx = art.init(num_cpus=4, _system_config=OPS_CONFIG)
    runtime = global_worker.runtime
    session_dir, store_dir = runtime.session_dir, runtime.store_dir
    owned = [p.pid for p in runtime._owned_processes]
    url = ctx.dashboard_url
    workers = set()
    try:
        if not url:
            raise AssertionError("the dashboard did not start")
        node_id = state.list_nodes()[0].node_id
        status = json.loads(get(url + "/api/cluster_status"))
        out["resources_total"] = status["resources_total"]

        # The placement group and the actor in its bundle.
        pg = placement_group([{"CPU": 1, "GPU": 1}], strategy="STRICT_PACK")
        if not pg.ready(timeout=60):
            raise AssertionError("the placement group was never created")
        table = placement_group_table()
        entry = table.get(pg.id.hex(), {})
        bundle_node = pg.bundle_node(0)
        since = time.time()
        t0 = time.perf_counter()
        actor = OpsEngine.options(placement_group=pg,
                                  placement_group_bundle_index=0).remote()
        pid, worker_id = art.get(actor.where.remote(), timeout=900)
        out["actor_start_s"] = round(time.perf_counter() - t0, 3)
        workers.update(c for d in owned for c in _child_pids(d))
        status_live = json.loads(get(url + "/api/cluster_status"))
        gate("placement_group",
             entry.get("state") == "CREATED"
             and entry.get("bundles") == [{"CPU": 1, "GPU": 1}]
             and bundle_node in (node_id, runtime.node_address)
             and status_live["resources_total"].get("GPU") == 1.0
             and status_live["resources_available"].get("GPU") == 0.0,
             {"entry": entry, "bundle_node": bundle_node,
              "node_id": node_id, "status": status_live})

        # The work, with a trace captured while it runs.
        ref = actor.generate.remote(prompts)
        t0 = time.perf_counter()
        profile = json.loads(_http_post(
            int(url.rsplit(":", 1)[1]), "/api/profile",
            {"duration_s": OPS_PROFILE_S})[2])
        out["profile_call_s"] = round(time.perf_counter() - t0, 3)
        out["generating_when_the_trace_ended"] = not art.wait(
            [ref], timeout=0)[0]
        tokens = art.get(ref, timeout=900)
        out["generate_s"] = round(time.perf_counter() - t0, 3)
        launches = _actor_call(art, actor, "_launches")
        gate("launches", launches == {**dict.fromkeys(launches, 0),
                                      "fwd": want_launches,
                                      "fwd_sm90": want_launches},
             {"launches": launches, "want_fwd_sm90": want_launches})

        # Flow insight: the generate call is the driver's edge to the
        # actor, and the actor's worker ran it once without error.
        deadline = time.monotonic() + OPS_WAIT_S
        while True:
            reply = json.loads(get(url + "/api/insight"))
            edges = {f"{e['caller']}->{e['callee']}": e["count"]
                     for e in reply["graph"]["edges"]}
            ran = reply["graph"]["functions"].get("OpsEngine.generate", {})
            if ran.get("calls") or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        out["insight"] = {"edges": edges, "generate": ran,
                          "events": len(reply["events"])}
        gate("insight",
             edges.get("driver->OpsEngine.generate") == 1
             and ran.get("calls") == 1 and ran.get("errors") == 0,
             out["insight"])

        # State: the actor, its worker's log.
        actors = [a for a in state.list_actors()
                  if a.class_name == "OpsEngine"]
        logs = state.list_logs()
        log_name = f"worker-{worker_id[:8]}.log"
        tail = state.get_log(log_name, tail=4096)
        gate("state",
             len(actors) == 1 and actors[0].state == "ALIVE"
             and actors[0].node_id == node_id and pid in workers
             and log_name in [f["filename"] for f in logs["files"]]
             and "operations actor ready" in tail,
             {"actor": actors and dataclasses.asdict(actors[0]),
              "pid": pid, "log": log_name, "tail": tail[-200:]})

        # The agent's card gauges against nvidia-smi.
        deadline = time.monotonic() + OPS_WAIT_S
        while True:
            text = get(url + "/metrics")
            in_use = _metric_values(text, "art_device_hbm_bytes_in_use")
            limit = _metric_values(text, "art_device_hbm_bytes_limit")
            used_mib = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=60).stdout.split()[0]
            smi = float(used_mib) * (1 << 20)
            reading = max(in_use.values(), default=0.0)
            if (reading >= OPS_WEIGHT_BYTES and abs(reading - smi)
                    <= OPS_SMI_SLACK) or time.monotonic() > deadline:
                break
            time.sleep(1.0)
        out["device_gauges"] = {"in_use": in_use, "limit": limit,
                                "nvidia_smi_used_bytes": smi}
        gate("device_gauges",
             len(in_use) == 1 and 'device="cuda:0"' in next(iter(in_use))
             and reading >= OPS_WEIGHT_BYTES
             and reading <= max(limit.values(), default=0.0)
             and abs(reading - smi) <= OPS_SMI_SLACK,
             out["device_gauges"])

        # CPU profiles of every process class.
        deadline = time.monotonic() + OPS_WAIT_S
        while True:
            prof = json.loads(get(url + "/api/cpuprofile"))
            worker_frames = sorted({
                f for key in prof["stacks"] if key.startswith("worker;")
                for f in ("engine:generate", "llama:forward")
                if f in key.split(";")})
            if (set(OPS_PROCS) <= set(prof["procs"]) and worker_frames) \
                    or time.monotonic() > deadline:
                break
            time.sleep(1.0)
        capture = cli("profile", "--duration", "3")
        costs = {"driver": cpu_profiler.profiler().overhead_stats(),
                 "worker": _actor_call(art, actor, "_profiler_cost")}
        out["cpu_profile"] = {
            "procs": prof["procs"], "records": prof["records"],
            "samples": prof["samples"], "worker_frames": worker_frames,
            "cli_procs": capture["procs"], "cli_samples":
            capture["samples"], "sample_cost_s": {
                k: v["avg_sample_cost_s"] for k, v in costs.items()},
            "overhead_fraction": {
                k: v["overhead_fraction"] for k, v in costs.items()}}
        gate("cpu_profile",
             set(OPS_PROCS) <= set(prof["procs"])
             and set(OPS_PROCS) <= set(capture["procs"])
             and worker_frames
             and all(v["avg_sample_cost_s"] < OPS_SAMPLE_COST_S
                     for v in costs.values()),
             out["cpu_profile"])

        # The trace archive through the log routes.
        archive = profile.get("archive", "")
        listed = [f["filename"] for n in json.loads(get(url + "/api/logs"))
                  for f in n["files"]]
        served = json.loads(get(url + f"/api/logs/{archive}")) \
            if archive else {}
        events = 0
        if archive:
            with tarfile.open(os.path.join(session_dir, "logs",
                                           archive)) as tar:
                member = next(m for m in tar.getmembers()
                              if m.name.endswith("trace.json"))
                events = len(json.load(tar.extractfile(member))[
                    "traceEvents"])
        out["trace"] = {"reply": profile, "listed": archive in listed,
                        "served_chars": len(served.get("data", "")),
                        "chrome_events": events}
        gate("trace_capture",
             archive.endswith(".tar.gz") and archive in listed
             and served.get("data") and events > 0, out["trace"])

        # The CLI.
        cli_status = cli("status")
        cli_pgs = cli("list", "placement-groups")
        gate("cli",
             cli_status["nodes"]["alive"] == 1
             and cli_status["resources_total"].get("GPU") == 1.0
             and [r["pg_id"] for r in cli_pgs] == [pg.id.hex()]
             and cli_pgs[0]["state"] == "CREATED",
             {"status": cli_status, "placement_groups": cli_pgs})

        # Lockcheck: every process of the cluster ran instrumented
        # locks; no log that list_logs names holds a cycle report.
        reports = {}
        for f in state.list_logs()["files"]:
            lines = [ln for ln in _whole_log(state, f["filename"])
                     .splitlines() if "LOCKCHECK: " in ln]
            if lines:
                reports[f["filename"]] = lines
        driver = lockcheck.reports()
        cycles = {name: [ln for ln in lines if "lock-order inversion" in ln]
                  for name, lines in reports.items()}
        cycles = {name: lines for name, lines in cycles.items() if lines}
        out["lockcheck"] = {
            "enabled_in_driver": lockcheck.enabled(),
            "logs_read": len(state.list_logs()["files"]),
            "cycle_reports": cycles,
            "driver_cycles": [r for r in driver if r["kind"] == "cycle"],
            "long_hold_reports": sum(
                "across blocking call" in ln for lines in reports.values()
                for ln in lines) + sum(r["kind"] == "long-hold"
                                       for r in driver)}
        gate("lockcheck",
             out["lockcheck"]["enabled_in_driver"]
             and not cycles and not out["lockcheck"]["driver_cycles"],
             out["lockcheck"])

        out["io_loops_at_actor_start"] = _io_loops(runtime._gcs, since)
        out["gcs_deferred_ticks"] = _deferred_ticks(session_dir)
        print(f"operations io loops ({card}): " + json.dumps(
            {"since_actor_start": out["io_loops_at_actor_start"],
             "gcs_deferred_ticks": out["gcs_deferred_ticks"]}),
            flush=True)

        # The group's GPU comes back.
        art.kill(actor)
        remove_placement_group(pg)
        deadline = time.monotonic() + 30
        while True:
            status_after = json.loads(get(url + "/api/cluster_status"))
            if status_after["resources_available"].get("GPU") == 1.0 or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        gate("placement_group_removed",
             status_after["resources_available"].get("GPU") == 1.0,
             status_after)
        workers.update(c for d in owned for c in _child_pids(d))
    except BaseException:
        _print_worker_logs(session_dir)
        print("operations (failed) " + json.dumps(out, default=str),
              flush=True)
        try:
            art.shutdown()
        finally:
            tracing_plane.reset(scope)
        raise
    t0 = time.perf_counter()
    art.shutdown()
    tracing_plane.reset(scope)
    _after_shutdown(torch, out, t0, owned + sorted(workers), session_dir,
                    store_dir, free_before)
    _gate_nothing_left(out)
    out["card_free_gib_after_shutdown"] = round(
        torch.cuda.mem_get_info()[0] / gib, 3)

    engine = LLMEngine("llama3-8b", seed=0, **OPS_ENGINE)
    want = [list(o.token_ids) for o in engine.generate(prompts, greedy)]
    del engine
    torch.cuda.empty_cache()
    if keep is not None:
        keep["tokens"] = want
    gate("tokens", tokens == want and all(len(t) == OPS_TOKENS
                                          for t in want),
         {"rows_equal": [a == b for a, b in zip(tokens, want)],
          "tokens_per_row": [len(t) for t in want]})
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("operations " + json.dumps(out, default=str), flush=True)
    return launches


JOBS_CONFIG = {"include_dashboard": True, "enable_node_agent": True,
               "export_task_events": True}
JOBS_TENSOR_ELEMS = 128 << 20   # 256 MiB of bf16 through the client
JOBS_VENV_ATTN = (1, 4096, 4096, 32, 8, 128)   # row 1's shape, bf16, causal
JOBS_TIMEOUT_S = 600.0          # for the job to end
JOBS_WAIT_S = 30.0              # for a stopped job, and for export events
JOBS_ACTOR_FLAG = "jobs-runtime-env"
JOBS_MAGIC = 20                 # the py_module's constant
# A venv is built with pip from a wheel made here: pip asks no index.
JOBS_PIP_ENV = {"PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
JOBS_COUNTERS = ("launch_count", "fwd_sm90_launch_count",
                 "fwd_tf32x3_launch_count", "fwd_sm90_d256_launch_count",
                 "fwd_tf32x3_d256_launch_count", "bwd_dq_launch_count",
                 "bwd_dkv_launch_count", "bwd_sm90_launch_count",
                 "bwd_tf32x3_launch_count", "bwd_sm90_d256_launch_count",
                 "bwd_tf32x3_d256_launch_count")

# The job's driver script: a process outside the cluster that connects
# through the client server, holds Llama-3-8B in one num_gpus=1 actor
# whose runtime env carries an env var and a py_module, generates, and
# sends a CUDA tensor through the client by ref to the actor and back.
JOB_SCRIPT = '''\
import json
import os
import time

import ant_ray_tpu_torch as art

with open("spec.json") as f:
    spec = json.load(f)
out = {}
t0 = time.perf_counter()
art.init(os.environ["ART_CLIENT_ADDRESS"])
out["connect_s"] = round(time.perf_counter() - t0, 3)


@art.remote(num_gpus=1)
class JobEngine:
    def __init__(self, engine):
        import torch
        from ant_ray_tpu_torch.llm import LLMEngine

        self.engine = LLMEngine("llama3-8b", seed=0, **engine)
        torch.cuda.synchronize()

    def seen(self):
        import jobs_payload

        return {"env": os.environ.get("JOBS_ACTOR_FLAG"),
                "py_module": jobs_payload.MAGIC, "pid": os.getpid()}

    def generate(self, prompts, max_tokens):
        import torch
        from ant_ray_tpu_torch.llm import SamplingParams
        from ant_ray_tpu_torch.ops import flash_attention as fa

        for name in spec["counters"]:
            setattr(fa, name, 0)
        t0 = time.perf_counter()
        outs = self.engine.generate(prompts,
                                    SamplingParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
        return ([list(o.token_ids) for o in outs],
                round(time.perf_counter() - t0, 3))

    def launches(self):
        from ant_ray_tpu_torch.ops import flash_attention as fa

        return {name: getattr(fa, name) for name in spec["counters"]}

    def echo(self, tensor):
        return tensor, tensor.device.type


t0 = time.perf_counter()
actor = JobEngine.options(runtime_env={
    "env_vars": {"JOBS_ACTOR_FLAG": spec["flag"]},
    "py_modules": [os.path.abspath("jobs_payload")]}).remote(spec["engine"])
import torch  # noqa: E402 — while the actor starts

out["actor_id"] = actor._actor_id.hex()
out["seen"] = art.get(actor.seen.remote(), timeout=900)
out["actor_start_s"] = round(time.perf_counter() - t0, 3)
out["tokens"], out["generate_s"] = art.get(
    actor.generate.remote(spec["prompts"], spec["max_tokens"]), timeout=900)
out["launches"] = art.get(actor.launches.remote(), timeout=60)

gen = torch.Generator(device="cuda").manual_seed(20)
tensor = torch.randn(spec["tensor_elems"], generator=gen, device="cuda",
                     dtype=torch.bfloat16)
torch.cuda.synchronize()
t0 = time.perf_counter()
ref = art.put(tensor)
out["put_s"] = round(time.perf_counter() - t0, 3)
t0 = time.perf_counter()
back_ref = actor.echo.remote(ref)
art.wait([back_ref], timeout=600)
out["echo_s"] = round(time.perf_counter() - t0, 3)
t0 = time.perf_counter()
back, actor_device = art.get(back_ref, timeout=600)
torch.cuda.synchronize()
out["get_s"] = round(time.perf_counter() - t0, 3)
out["tensor"] = {"bytes": tensor.numel() * tensor.element_size(),
                 "actor_device": actor_device,
                 "device": back.device.type, "dtype": str(back.dtype),
                 "bitwise": bool(torch.equal(back, tensor))}
art.kill(actor)
print("JOB_RESULT " + json.dumps(out), flush=True)
art.shutdown()
'''


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _descendants(pid):
    out, todo = [], [pid]
    while todo:
        for child in _child_pids(todo.pop()):
            out.append(child)
            todo.append(child)
    return out


def _maps_name(pid, *names):
    """Which of ``names`` the shared objects mapped by ``pid`` mention."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            text = f.read()
    except OSError:
        return None
    return sorted(n for n in names if n in text)


def _write_wheel(path):
    """A minimal pure-python wheel made here (a wheel is a zip): the pip
    runtime env installs it with no index."""
    import zipfile  # noqa: PLC0415

    name, version = "artjobswheel", "0.1"
    wheel = os.path.join(path, f"{name}-{version}-py3-none-any.whl")
    info = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(wheel, "w") as zf:
        zf.writestr(f"{name}/__init__.py", f"MAGIC = {JOBS_MAGIC}\n")
        zf.writestr(f"{info}/METADATA", "Metadata-Version: 2.1\n"
                    f"Name: {name}\nVersion: {version}\n")
        zf.writestr(f"{info}/WHEEL", "Wheel-Version: 1.0\nGenerator: "
                    "chip_smoke\nRoot-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{info}/RECORD", "")
    return wheel


def _venv_kernel_check(attn):
    """A num_gpus=1 task's body in a pip venv: where it runs, the wheel,
    whether the sm90 forward's library was already built, and one launch
    of it at ``attn`` (bf16, causal) against its plain version."""
    import artjobswheel  # noqa: PLC0415
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    lib = "flash_attention_fwd_sm90"
    prebuilt = _build._library_path(lib).exists()
    t0 = time.perf_counter()
    _build.load(lib)
    load_s = time.perf_counter() - t0
    batch, q_len, kv_len, heads, kv_heads, dim = attn
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q = rand(batch, q_len, heads, dim)
    k = rand(batch, kv_len, kv_heads, dim)
    v = rand(batch, kv_len, kv_heads, dim)
    _reset_counts(fa)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _counts(fa)
    ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal=True)
    return {"prefix": sys.prefix, "executable": sys.executable,
            "wheel": artjobswheel.MAGIC, "prebuilt": prebuilt,
            "load_s": round(load_s, 3), "launches": launches,
            "max_abs_err": (out.float() - ref_out.float()).abs().max().item(),
            "lse_err": (lse - ref_lse).abs().max().item()}


def _imports_the_wheel():
    try:
        import artjobswheel  # noqa: F401, PLC0415
        return True
    except ImportError:
        return False


def jobs_phase(torch, llama, card, want=None):
    """Job submission, the client, runtime envs and export events on the
    card (``init(num_cpus=4, _system_config=JOBS_CONFIG)``: the
    dashboard, a node agent, task events exported).  A client server
    (``python -m ant_ray_tpu_torch.util.client.server``) fronts the
    cluster; through the dashboard's ``JobSubmissionClient`` a job is
    submitted with ``runtime_env={"working_dir": <dir>, "env_vars":
    {"ART_CLIENT_ADDRESS": "art://<server>"}}``.  The job, a driver
    outside the cluster, connects through ``art://``, creates one
    ``num_gpus=1`` actor with ``LLMEngine("llama3-8b", slots=4,
    max_seq=2048)`` (random weights from seed 0) under a runtime env of
    an env var and a py_module, generates 16 greedy tokens for the
    operations phase's 4 prompts, puts a 256-MiB bf16 CUDA tensor
    through the client, which the actor takes by ref and returns, then
    kills the actor and prints one ``JOB_RESULT`` line.  Meanwhile a
    second job (``sleep 600``) is stopped, and a ``num_gpus=1`` task
    with ``runtime_env={"pip": [<wheel made here>]}`` waits for the card.
    Gates, each on a "jobs gate" line: the job SUCCEEDED, listed, its
    log holding the result; the actor's token ids equal, row by row, to
    the operations phase's driver engine's (``want``; built here once
    when not given); 32 sm90 forward launches per bucketed prefill in
    the actor's process and nothing else; the env var and the py_module
    in the actor; the tensor bitwise equal after the round trip, on the
    card at both ends, the client server holding no CUDA library; the
    stopped job STOPPED and its processes gone; EXPORT_DRIVER_JOB and
    the actor's ALIVE and DEAD in ``/api/export_events``; the venv task
    on the venv's interpreter, importing the wheel, loading the sm90
    forward without building it and launching it once at row 1's shape
    within TOL of its plain version, a task without the env unable to
    import the wheel; nothing left after shutdown and the card's memory
    back.  Returns the actor's launches."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415
    from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415
    from ant_ray_tpu_torch.job_submission import (  # noqa: PLC0415
        JobStatus, JobSubmissionClient)
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

    t_phase = time.perf_counter()
    cfg = llama.CONFIGS["llama3-8b"]
    lens, prompts = _ops_prompts(cfg)
    want_launches = cfg.n_layers * sum(
        _bucket(int(n), OPS_ENGINE["max_seq"]) >= 128 for n in lens)
    out = {"card": card, "model": "llama3-8b", "gates": {},
           "prompt_lens": [int(n) for n in lens]}
    out["reference"] = "operations phase" if want else "built here"
    if want is None:
        engine = LLMEngine("llama3-8b", seed=0, **OPS_ENGINE)
        want = [list(o.token_ids) for o in engine.generate(
            prompts, SamplingParams(max_tokens=OPS_TOKENS))]
        del engine
    launch_keys = list(_counts(types.SimpleNamespace(
        **dict.fromkeys(JOBS_COUNTERS, 0))))

    def gate(name, ok, detail):
        out["gates"][name] = bool(ok)
        print(f"jobs gate {name} ({card}): "
              f"{'held' if ok else 'FAILED'}: "
              f"{json.dumps(detail, default=str)}", flush=True)
        if not ok:
            raise AssertionError(f"jobs gate {name} failed: {detail}")

    def lap(what, seconds):
        out.setdefault("walls_s", {})[what] = round(seconds, 3)
        print(f"jobs {what} ({card}): {seconds:.3f} s", flush=True)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="jobs_smoke_", dir=root)
    prior_env = {k: os.environ.get(k) for k in JOBS_PIP_ENV}
    os.environ.update(JOBS_PIP_ENV)
    scope = tracing_plane.set_current(tracing_plane.mint(sampled=False))
    server = None
    t0 = time.perf_counter()
    ctx = art.init(num_cpus=4, _system_config=JOBS_CONFIG)
    lap("cluster start", time.perf_counter() - t0)
    runtime = global_worker.runtime
    session_dir, store_dir = runtime.session_dir, runtime.store_dir
    owned = [p.pid for p in runtime._owned_processes]
    seen_pids = set()
    url = ctx.dashboard_url
    try:
        if not url:
            raise AssertionError("the dashboard did not start")
        t0 = time.perf_counter()
        with open(os.path.join(session_dir, "logs", "client-server.err"),
                  "ab") as err:
            server = subprocess.Popen(
                [sys.executable, "-m", "ant_ray_tpu_torch.util.client.server",
                 "--cluster-address", runtime.gcs_address,
                 "--host", "127.0.0.1"], cwd=root,
                stdout=subprocess.PIPE, stderr=err, start_new_session=True)
        line = server.stdout.readline().decode(errors="replace").split()
        if line[:1] != ["ART_CLIENT_SERVER_READY"]:
            raise AssertionError(f"the client server did not start: {line}")
        address = line[1]
        lap("client server start", time.perf_counter() - t0)

        # The job's working directory: its script, its spec, the py_module.
        os.makedirs(os.path.join(workdir, "jobs_payload"))
        with open(os.path.join(workdir, "jobs_payload", "__init__.py"),
                  "w") as f:
            f.write(f"MAGIC = {JOBS_MAGIC}\n")
        with open(os.path.join(workdir, "jobs_driver.py"), "w") as f:
            f.write(JOB_SCRIPT)
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump({"prompts": prompts, "max_tokens": OPS_TOKENS,
                       "engine": OPS_ENGINE, "flag": JOBS_ACTOR_FLAG,
                       "tensor_elems": JOBS_TENSOR_ELEMS,
                       "counters": JOBS_COUNTERS}, f)
        wheel = _write_wheel(tempfile.mkdtemp(dir=workdir))

        client = JobSubmissionClient(url)
        t0 = time.perf_counter()
        job_id = client.submit_job(
            entrypoint=f"{shlex.quote(sys.executable)} jobs_driver.py",
            runtime_env={"working_dir": workdir, "env_vars": {
                "ART_CLIENT_ADDRESS": f"art://{address}"}})
        while client.get_job_status(job_id) == JobStatus.PENDING:
            time.sleep(0.01)
        lap("submit_job to RUNNING", time.perf_counter() - t0)
        sleeper = client.submit_job(entrypoint="sleep 600")

        # The venv task, sent now: the agent builds its venv while the
        # job runs, and it starts once the job's actor gives the card up.
        t_venv = time.time()
        venv_ref = art.remote(num_gpus=1)(_venv_kernel_check).options(
            runtime_env={"pip": [wheel]}).remote(JOBS_VENV_ATTN)

        # The stopped job.
        deadline = time.monotonic() + JOBS_WAIT_S
        sleeping = []
        while not sleeping and time.monotonic() < deadline:
            sleeping = [p for p in _descendants(owned[0])
                        if "sleep 600" in _cmdline(p)]
            time.sleep(0.05)
        stopped = client.stop_job(sleeper)
        status = client.wait_until_finished(sleeper, timeout=JOBS_WAIT_S)
        time.sleep(0.2)
        gate("stop_job",
             stopped and status == JobStatus.STOPPED and sleeping
             and not any(_pid_alive(p) for p in sleeping),
             {"stopped": stopped, "status": status, "pids": sleeping,
              "alive": [p for p in sleeping if _pid_alive(p)]})

        # The job.
        seen_pids.update(_descendants(owned[0]) + _descendants(owned[1]))
        status = client.wait_until_finished(job_id, timeout=JOBS_TIMEOUT_S)
        logs = client.get_job_logs(job_id)
        result_lines = [ln for ln in logs.splitlines()
                        if ln.startswith("JOB_RESULT ")]
        listed = [j for j in client.list_jobs()
                  if j["submission_id"] == job_id]
        gate("job", status == JobStatus.SUCCEEDED and len(result_lines) == 1
             and len(listed) == 1 and listed[0]["status"] == status,
             {"status": status, "listed": listed, "logs": logs[-3000:]})
        result = json.loads(result_lines[0].split(" ", 1)[1])
        tokens = result.pop("tokens")
        out["job"] = result
        for what, key in (("connect through the client", "connect_s"),
                          ("8B actor start through the client",
                           "actor_start_s"),
                          ("generation (4 prompts, 16 tokens)",
                           "generate_s"),
                          ("put of 256 MiB through the client", "put_s"),
                          ("the actor's echo by ref", "echo_s"),
                          ("get of 256 MiB through the client", "get_s")):
            lap(what, result[key])
        gate("tokens", tokens == want and all(len(t) == OPS_TOKENS
                                              for t in want),
             {"rows_equal": [a == b for a, b in zip(tokens, want)],
              "tokens_per_row": [len(t) for t in tokens],
              "reference": out["reference"]})
        launches = _counts(types.SimpleNamespace(**result["launches"]))
        gate("launches", launches == {**dict.fromkeys(launch_keys, 0),
                                      "fwd": want_launches,
                                      "fwd_sm90": want_launches},
             {"launches": launches, "want_fwd_sm90": want_launches})
        gate("runtime_env",
             result["seen"]["env"] == JOBS_ACTOR_FLAG
             and result["seen"]["py_module"] == JOBS_MAGIC, result["seen"])
        proxy_libs = _maps_name(server.pid, "libcuda", "libtorch")
        gate("tensor_round_trip",
             result["tensor"] == {"bytes": 2 * JOBS_TENSOR_ELEMS,
                                  "actor_device": "cuda", "device": "cuda",
                                  "dtype": "torch.bfloat16", "bitwise": True}
             and proxy_libs == [],
             {**result["tensor"], "client_server_maps": proxy_libs})

        # Export events: the jobs' and the job's actor's lifecycle.
        deadline = time.monotonic() + JOBS_WAIT_S
        while True:
            with urllib.request.urlopen(
                    url + "/api/export_events?limit=5000", timeout=60) as r:
                events = json.loads(r.read().decode())
            kinds = sorted({(e["source_type"], e["event_type"])
                            for e in events["events"]})
            actor_events = sorted({e["event_type"] for e in events["events"]
                                   if e["source_type"] == "EXPORT_ACTOR"
                                   and e["entity_id"] == result["actor_id"]})
            ok = (("EXPORT_DRIVER_JOB", "STARTED") in kinds
                  and {"ALIVE", "DEAD"} <= set(actor_events))
            if ok or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        out["export_events"] = {"enabled": events["enabled"],
                                "events": len(events["events"]),
                                "kinds": kinds, "actor": actor_events}
        gate("export_events", events["enabled"] and ok, out["export_events"])

        # The venv task.
        venv = art.get(venv_ref, timeout=JOBS_TIMEOUT_S)
        ready = os.path.join(renv.venv_dir([wheel], session_dir), ".art_ready")
        lap("venv build (pip, from the task's submission)",
            os.path.getmtime(ready) - t_venv)
        lap("sm90 forward library load in the venv", venv["load_s"])
        bare = art.get(art.remote(_imports_the_wheel).remote(), timeout=120)
        tol_out, tol_lse = TOL["bfloat16"]
        out["venv"] = {**venv, "without_the_env_imports_the_wheel": bare}
        gate("pip_venv",
             "venvs" in venv["prefix"] and venv["wheel"] == JOBS_MAGIC
             and venv["prebuilt"] and not bare
             and venv["launches"] == {**dict.fromkeys(launch_keys, 0),
                                      "fwd": 1, "fwd_sm90": 1}
             and venv["max_abs_err"] <= tol_out
             and venv["lse_err"] <= tol_lse, out["venv"])
        seen_pids.update(_descendants(owned[0]) + _descendants(owned[1]))
    except BaseException:
        _print_worker_logs(session_dir)
        print("jobs (failed) " + json.dumps(out, default=str), flush=True)
        try:
            if server is not None:
                server.kill()
                server.wait(timeout=30)
            art.shutdown()
        finally:
            tracing_plane.reset(scope)
            _restore_env(prior_env)
            shutil.rmtree(workdir, ignore_errors=True)
        raise
    t0 = time.perf_counter()
    server.terminate()
    server.wait(timeout=30)
    art.shutdown()
    tracing_plane.reset(scope)
    _restore_env(prior_env)
    shutil.rmtree(workdir, ignore_errors=True)
    _after_shutdown(torch, out, t0, owned + [server.pid] + sorted(seen_pids),
                    session_dir, store_dir, free_before)
    gate("shutdown", not (out["left_alive"] or out["pgrep"]
                          or out["session_dir_left"] or out["arena_left"])
         and out["card_free_back"],
         {k: out[k] for k in ("shutdown_s", "left_alive", "pgrep",
                              "session_dir_left", "arena_left",
                              "card_free_back")})
    lap("phase", time.perf_counter() - t_phase)
    print("jobs " + json.dumps(out, default=str), flush=True)
    return launches


def _restore_env(prior):
    for key, value in prior.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


class _ArenaPin:
    """A read pin on a stored object, held for as long as something
    references the buffers deserialized from it (the pin owner of
    ``SerializedObject.from_payload``).  The store keeps the token, not
    this object, so dropping the last buffer drops the pin."""

    _tokens = itertools.count()

    def __init__(self, store, oid):
        self.store, self.oid = store, oid
        self.token = next(self._tokens)
        store.pin(oid, self.token)

    def __del__(self):
        self.store.unpin(self.oid, self.token)


OBJECT_REPS = 5


def objects_phase(torch, engine, card, slot=0):
    """The object plane on the card: one slot's KV slab of Llama-3-8B (two
    non-contiguous bf16 views, 0.537 GB) and a mixed dict go through
    serialize -> the native arena on the node's tmpfs -> deserialize,
    back onto the card, bitwise; put and get timed beside plain copies
    of the same bytes."""
    from ant_ray_tpu_torch._private import native, object_store  # noqa: PLC0415
    from ant_ray_tpu_torch._private import serialization as ser  # noqa: PLC0415
    from ant_ray_tpu_torch._private.ids import ObjectID  # noqa: PLC0415
    from ant_ray_tpu_torch.object_ref import ObjectRef  # noqa: PLC0415

    fresh = not os.path.exists(native.library_path())
    t0 = time.perf_counter()
    module = native.load_native()
    build_s = time.perf_counter() - t0
    if module is None:
        raise AssertionError("the native arena module did not build or load "
                             "(see the warning above); no fallback to files")
    slab = {"k": engine.cache["k"][:, slot], "v": engine.cache["v"][:, slot]}
    nbytes = sum(t.numel() * t.element_size() for t in slab.values())
    if any(t.is_contiguous() for t in slab.values()):
        raise AssertionError("the slab views should be non-contiguous")
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    capacity = object_store.default_store_capacity()
    need = nbytes + (64 << 20)
    if shm_free < need or capacity < need:
        raise AssertionError(f"the tmpfs cannot hold the slab: /dev/shm has "
                             f"{shm_free} bytes free, the store's capacity "
                             f"is {capacity}, the slab needs {need}")
    directory = tempfile.mkdtemp(prefix="art_torch_objects_", dir="/dev/shm")
    # /dev/shm outlives this process: the directory goes at the end of the
    # phase (finally below), at exit, and on SIGTERM, the signal a time
    # limit sends, which unwinds through that finally.
    atexit.register(shutil.rmtree, directory, True)
    prior_sigterm = signal.signal(signal.SIGTERM, _exit_on_sigterm)
    store = object_store.ObjectStore(directory, capacity)
    client = object_store.ArenaClient()

    def put(value):
        oid = ObjectID.from_random()
        t0 = time.perf_counter()
        obj = ser.serialize(value)
        t1 = time.perf_counter()
        store.create_buffer(oid, obj.payload_nbytes())
        obj.write_into(store.view_unsealed(oid))
        store.seal_buffer(oid)
        t2 = time.perf_counter()
        return oid, obj, (t1 - t0, t2 - t1)

    def get(oid):
        info = store.locate(oid)
        view = client.view(info["path"], info["offset"], info["size"])
        value = ser.deserialize(ser.SerializedObject.from_payload(
            view, pin_owner=_ArenaPin(store, oid)))
        torch.cuda.synchronize()
        return value

    def bitwise(a, b):
        return (isinstance(a, torch.Tensor) and a.device.type == "cuda"
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))

    try:
        if not store.uses_arena:
            raise AssertionError("the object store is not on the native arena")
        puts, gets, parts, equal, pins = [], [], [], [], []
        # Round trip 0 is the first touch of the arena's pages and of the
        # host buffers; it is reported alone, and the medians are over
        # the OBJECT_REPS warm ones after it.
        for _ in range(1 + OBJECT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            oid, obj, split = put(slab)
            puts.append(time.perf_counter() - t0)
            parts.append(split)
            del obj
            t0 = time.perf_counter()
            out = get(oid)
            gets.append(time.perf_counter() - t0)
            equal.append(all(bitwise(out[n], slab[n]) for n in slab))
            del out
            pins.append(sum(s["pins"] for s in store.object_stats()))
            store.delete(oid)
        direct_d2h, direct_h2d = [], []
        for _ in range(1 + OBJECT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = {n: t.cpu() for n, t in slab.items()}
            direct_d2h.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = {n: t.to("cuda") for n, t in host.items()}
            torch.cuda.synchronize()
            direct_h2d.append(time.perf_counter() - t0)
            del host, back

        gen = torch.Generator(device="cuda").manual_seed(13)
        ref = ObjectRef(ObjectID.from_random(), _skip_refcount=True)
        fp32 = torch.randn((256, 384), generator=gen, device="cuda")
        mixed = {"bf16_view": engine.cache["k"][:, slot, :16, 0],
                 "fp32": fp32,
                 "int64": torch.arange(-500, 500, device="cuda"),
                 "bool": fp32 > 0,
                 "scalar": torch.tensor(3.25, device="cuda"),
                 "numpy": np.random.default_rng(13).standard_normal(1000),
                 "ref": ref}
        oid, obj, _ = put(mixed)
        refs_recorded = obj.contained_refs == [ref]
        out = get(oid)
        mixed_ok = (
            all(bitwise(out[n], mixed[n]) for n in
                ("bf16_view", "fp32", "int64", "bool", "scalar"))
            and np.array_equal(out["numpy"], mixed["numpy"])
            and out["ref"] == ref and refs_recorded)
        mixed_bytes = obj.payload_nbytes()
        del obj, out
        store.delete(oid)
    finally:
        store.destroy()
        shutil.rmtree(directory, ignore_errors=True)
        signal.signal(signal.SIGTERM, prior_sigterm)

    def warm(xs):    # the median past round trip 0
        return statistics.median(list(xs)[1:])

    def rate(seconds):
        return round(nbytes / seconds / 1e9, 3)

    put_s, get_s = warm(puts), warm(gets)
    d2h_s, h2d_s = warm(direct_d2h), warm(direct_h2d)
    print("objects " + json.dumps({
        "card": card, "slab": "llama3-8b cache k,v [:, slot] "
        f"{list(slab['k'].shape)} bf16 x2", "slab_bytes": nbytes,
        "dev_shm_bytes": shm.f_blocks * shm.f_frsize,
        "dev_shm_free_bytes": shm_free, "store_capacity_bytes": capacity,
        "uses_arena": True, "native_build_s": round(build_s, 3),
        "native_built_fresh": fresh,
        "first_put_ms": round(puts[0] * 1e3, 2),
        "first_get_ms": round(gets[0] * 1e3, 2),
        "put_ms": round(put_s * 1e3, 2), "put_GBps": rate(put_s),
        "put_serialize_ms": round(warm(p[0] for p in parts) * 1e3, 2),
        "put_arena_copy_ms": round(warm(p[1] for p in parts) * 1e3, 2),
        "get_ms": round(get_s * 1e3, 2), "get_GBps": rate(get_s),
        "direct_cpu_ms": round(d2h_s * 1e3, 2), "direct_cpu_GBps":
        rate(d2h_s), "direct_to_cuda_ms": round(h2d_s * 1e3, 2),
        "direct_to_cuda_GBps": rate(h2d_s), "reps": OBJECT_REPS,
        "puts_ms": [round(x * 1e3, 2) for x in puts],
        "gets_ms": [round(x * 1e3, 2) for x in gets],
        "slab_bitwise": equal, "pins_after_get": pins,
        "mixed_bytes": mixed_bytes, "mixed_equal": mixed_ok}), flush=True)
    if not (all(equal) and mixed_ok and not any(pins)):
        raise AssertionError("the object plane did not round-trip bitwise "
                             "or left a pin behind")


def _write_safetensors(torch, path, state):
    """A bf16 state dict as one safetensors file: an 8-byte little-endian
    header length, a JSON header of each tensor's dtype, shape and byte
    range (padded with spaces to 8 bytes), then the raw buffers."""
    header, offset = {}, 0
    for name, t in state.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the writer takes bf16, not {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in state.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())
        f.flush()
        os.fsync(f.fileno())


def _bitwise_equal(torch, a, b):
    """Every leaf of two trees has the same dtype, shape and bits."""
    flat_a = {**{k: v for k, v in a.items() if k != "layers"},
              **{f"layers.{k}": v for k, v in a["layers"].items()}}
    flat_b = {**{k: v for k, v in b.items() if k != "layers"},
              **{f"layers.{k}": v for k, v in b["layers"].items()}}
    return flat_a.keys() == flat_b.keys() and all(
        v.dtype == flat_b[k].dtype and v.shape == flat_b[k].shape
        and torch.equal(v.view(torch.int16), flat_b[k].view(torch.int16))
        for k, v in flat_a.items())


# Checkpoint phase: llama-400m, greedy prompts (buckets 128, 1024, 2048).
CKPT_PROMPTS = (100, 700, 1500)
CKPT_TOKENS = 16


def checkpoint_phase(torch, fa, llama):
    """Serving from a checkpoint directory: llama-400m's random weights
    (seed 0) written as a HF directory twice, as model.safetensors (by
    _write_safetensors) and as pytorch_model.bin (torch.save), in a
    temporary directory of this checkout; each loaded onto the card
    through LLMEngine(<dir>, prefill_chunk_tokens=None).  Gates: leaves
    bitwise equal to the weights in memory; greedy tokens of three
    prompts equal to an engine on the weights in memory; one completion
    through LLMServer(<dir>) equal to the engine's; the sm90 forward
    launched n_layers times per prefill (every bucket here is 128 or
    more), nothing else.  Returns the launches of the directory engines
    and the server."""
    from ant_ray_tpu_torch.llm import (LLMEngine, LLMServer,  # noqa: PLC0415
                                       SamplingParams, get_tokenizer)
    from ant_ray_tpu_torch.models import checkpoint as ckpt  # noqa: PLC0415

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in CKPT_PROMPTS]
    greedy = SamplingParams(max_tokens=CKPT_TOKENS)
    kw = dict(slots=8, max_seq=4096, prefill_chunk_tokens=None)

    ref = LLMEngine(cfg, params, **kw)
    want = [o.token_ids for o in ref.generate(prompts, greedy)]
    want_solo = ref.generate([prompts[1]], greedy)[0].token_ids
    del ref
    state = ckpt.hf_state_dict(params)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    per_format = {}
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for fmt, fname in (("safetensors", "model.safetensors"),
                           ("bin", "pytorch_model.bin")):
            path = os.path.join(tmp, fmt)
            os.makedirs(path)
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(ckpt.hf_config(cfg), f)
            t0 = time.perf_counter()
            if fmt == "safetensors":
                _write_safetensors(torch, os.path.join(path, fname), state)
            else:
                with open(os.path.join(path, fname), "wb") as f:
                    torch.save(state, f)
                    f.flush()
                    os.fsync(f.fileno())
            write_s = time.perf_counter() - t0
            size = os.path.getsize(os.path.join(path, fname))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded, _ = ckpt.load_llama_params(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            bitwise = _bitwise_equal(torch, loaded, params)
            del loaded
            # LLMEngine(<dir>) also asks get_tokenizer(<dir>) for the
            # directory's tokenizer: timed alone here (the first call
            # imports transformers where it exists).
            t0 = time.perf_counter()
            get_tokenizer(path)
            tokenizer_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine = LLMEngine(path, **kw)
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
            bitwise = bitwise and _bitwise_equal(torch, engine.params, params)
            before = _counts(fa)["fwd_sm90"]
            got = [o.token_ids for o in engine.generate(prompts, greedy)]
            launched = _counts(fa)["fwd_sm90"] - before
            per_format[fmt] = {
                "file_bytes": size, "write_s": write_s,
                "write_GBps": size / write_s / 1e9, "load_s": load_s,
                "load_GBps": size / load_s / 1e9,
                "get_tokenizer_s": tokenizer_s, "engine_s": engine_s,
                "bitwise": bitwise,
                "tokens_equal": got == want, "sm90_launches": launched}
            print(f"checkpoint llama-400m {fmt}: "
                  f"{json.dumps(per_format[fmt])}", flush=True)
            del engine
            if fmt == "safetensors":
                server = LLMServer(path, prefill_chunk_tokens=None, slots=8,
                                   max_seq=4096)
                try:
                    answer = server({"prompt": prompts[1],
                                     "max_tokens": CKPT_TOKENS})
                finally:
                    server.shutdown()
                server_tokens = answer["choices"][0]["token_ids"]
                server_ok = (_bitwise_equal(torch, server.engine.params,
                                            params)
                             and server_tokens == want_solo)
                del server
    torch.cuda.synchronize()
    launches = _counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = cfg.n_layers          # every bucket here is 128 or more
    expected = per_prefill * (2 * len(prompts) + 1)
    has_hf = importlib.util.find_spec("transformers") is not None
    print(f"checkpoint llama-400m: {nbytes} bytes of bf16 weights "
          f"({cfg.num_params() / 1e6:.1f} M params; load_s is "
          f"load_llama_params alone, get_tokenizer_s get_tokenizer(<dir>) "
          f"alone, engine_s LLMEngine(<dir>) after both; transformers "
          f"installed {has_hf}), server completion "
          f"equal to the engine's {server_ok}; launches {launches} "
          f"(expected {expected} sm90 forward, nothing else); peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    if not (all(r["bitwise"] and r["tokens_equal"]
                and r["sm90_launches"] == per_prefill * len(prompts)
                for r in per_format.values()) and server_ok):
        raise AssertionError(f"checkpoint phase failed: {per_format}, "
                             f"server ok {server_ok}")
    if launches != {"fwd": expected, "fwd_sm90": expected, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0,
                    "tf32x3_d256": 0, "fwd_tf32x3_d256": 0}:
        raise AssertionError(f"checkpoint phase launched {launches}")
    return launches


# Server phase: Llama-3-8B behind LLMServer, the reference's defaults.
SERVER_TOKENS = 16
# Llama-3-8B's widths at 8 of its 32 layers: this cut pays for the tune
# phase, as the data, tracing and deployment phases' pays for jobs.
SERVER_LAYERS = 8
# The request whose deadline runs out mid-generation: seconds, tokens.
# (0.5, 64) at 32 layers; at 8 a decode step is ~4x shorter, so 128
# tokens in 0.2 s would need steps under 1.6 ms.
SERVER_DEADLINE = (0.2, 128)


def server_phase(torch, fa, llama):
    """LLMServer on Llama-3-8B's widths at SERVER_LAYERS layers
    (slots=8, max_seq=4096, kv_offload="local") with chunks of 64 (the reference's serving default), random weights
    from seed 0.  Four client threads send four completions of 100-1500
    token ids (one opening a session), two chats, two streams (a
    completion and the first chat), and the session's second turn; then
    end_session, load_signals, a request whose deadline has passed and
    one whose deadline runs out mid-generation.  Gates: every greedy
    answer equals the same request served alone afterwards; each stream
    equals its request's answer; chat usage matches the tokens; the
    expired request touches nothing; no flash launch (chunked prefill and
    decode run no kernel of ours)."""
    from ant_ray_tpu_torch.exceptions import DeadlineExceededError  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMServer  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.chat import render_chat  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import device_memory_stats  # noqa: PLC0415
    from ant_ray_tpu_torch.serve.api import _request_deadline  # noqa: PLC0415

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = LLMServer(dataclasses.replace(llama.CONFIGS["llama3-8b"],
                                        n_layers=SERVER_LAYERS),
                    slots=8, max_seq=4096, seed=0, kv_offload="local")
    torch.cuda.synchronize()
    print(f"llama3-8b ({SERVER_LAYERS} layers) LLMServer up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg, tok = srv.engine.config, srv.engine.tokenizer
    rng = np.random.default_rng(13)

    def ids(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def completion(n, **extra):
        return {"prompt": ids(n), "max_tokens": SERVER_TOKENS, **extra}

    chat_a = {"messages": [{"role": "system", "content": "You are terse."},
                           {"role": "user", "content": "Name three rivers "
                            "of Europe and their lengths."}],
              "max_tokens": SERVER_TOKENS}
    chat_b = {"messages": [{"role": "user", "content": "Say hello."}],
              "max_tokens": SERVER_TOKENS}
    reqs = {"c100": completion(100), "c500s": completion(500, session_id="s"),
            "c1000": completion(1000), "c1500": completion(1500),
            "chat_a": chat_a, "chat_b": chat_b,
            "stream_c300": completion(300), "stream_chat_a": dict(chat_a),
            "s_turn2": completion(50, session_id="s")}
    plan = [["c100", "c500s", "s_turn2"], ["c1000", "stream_c300"],
            ["chat_a", "chat_b"], ["c1500", "stream_chat_a"]]
    label = threading.local()
    handles: dict = {}
    submit = srv._loop.submit

    def recording_submit(prompt, sampling, **kwargs):
        handle = submit(prompt, sampling, **kwargs)
        handles[label.name] = handle
        return handle

    srv._loop.submit = recording_submit
    answers, errors = {}, []

    def serve(name):
        label.name = name
        req = dict(reqs[name])
        if name.startswith("stream"):
            return list(srv.stream(req))
        return srv(req)

    def client(names):
        try:
            for name in names:
                answers[name] = serve(name)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    _reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(names,))
                   for names in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SESSION_DEADLINE_S)
        wall_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server clients failed: {errors}")
        ttft = {name: round(h.ttft_s() * 1e3, 1)
                for name, h in handles.items()}
        ended = srv.end_session("s")
        signals = srv.load_signals()

        # Each request again, alone (the session replayed under another
        # id, its turns in order).
        solo = {}
        for names in plan:
            for name in names:
                req = dict(reqs[name])
                if req.get("session_id"):
                    req["session_id"] = "s-solo"
                label.name = f"solo {name}"
                solo[name] = (list(srv.stream(dict(req)))
                              if name.startswith("stream") else srv(req))
        srv.end_session("s-solo")
        # The streams' requests as completions, for their token ids: the
        # chat one as the token ids its template renders to, which is
        # what the chat path submits.
        whole = {"stream_c300": srv(dict(reqs["stream_c300"])),
                 "stream_chat_a": srv({
                     "prompt": render_chat(tok, chat_a["messages"]),
                     "max_tokens": SERVER_TOKENS})}

        # A request whose deadline has passed: shed, engine untouched.
        stats, counter = dict(srv.engine.stats), repr(srv.engine._req_counter)
        token = _request_deadline.set(time.time() - 1.0)
        shed = False
        try:
            srv(completion(100))
        except DeadlineExceededError:
            shed = (srv.engine.stats == stats
                    and repr(srv.engine._req_counter) == counter)
        finally:
            _request_deadline.reset(token)

        # A deadline that runs out mid-generation: SERVER_DEADLINE[0] s
        # for SERVER_DEADLINE[1] tokens.
        label.name = "deadline"
        token = _request_deadline.set(time.time() + SERVER_DEADLINE[0])
        t0 = time.perf_counter()
        expired_s = None
        try:
            srv({"prompt": ids(100), "max_tokens": SERVER_DEADLINE[1]})
        except DeadlineExceededError:
            expired_s = time.perf_counter() - t0
        finally:
            _request_deadline.reset(token)
        late = handles["deadline"]
        late_out = late.wait(SESSION_DEADLINE_S)      # it runs to its end
        mid_generation = (expired_s is not None and late.ttft_s() is not None
                          and late.ttft_s() < expired_s
                          and len(late_out.token_ids) > 1)
    finally:
        srv.shutdown()
        del srv._loop.submit   # the wrapper holds the loop: free the 8B now
    launches = _counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def streamed(name):
        """The texts and token ids of a stream's token chunks."""
        body = [c["choices"][0] for c in answers[name][:-1]]
        return ([b.get("text", b.get("delta", {}).get("content"))
                 for b in body], [b.get("token_id") for b in body])

    def per_token(ids):
        return [tok.decode([t]) for t in ids]

    equal = {name: answers[name] == solo[name] for name in answers}
    c300 = whole["stream_c300"]["choices"][0]
    chat_ids = whole["stream_chat_a"]["choices"][0]["token_ids"]
    chat = answers["chat_a"]
    # A stream carries each token's own text; joined, it equals the
    # answer's text unless a multi-byte character spans two tokens.
    streams_ok = (
        all(answers[n][-1]["done"] for n in ("stream_c300", "stream_chat_a"))
        and streamed("stream_c300") == (per_token(c300["token_ids"]),
                                        c300["token_ids"])
        and streamed("stream_chat_a")[0] == per_token(chat_ids)
        and chat["choices"][0]["message"]["content"] == tok.decode(chat_ids))
    joined_equal = {
        "stream_c300": "".join(streamed("stream_c300")[0]) == c300["text"],
        "stream_chat_a": "".join(streamed("stream_chat_a")[0])
        == chat["choices"][0]["message"]["content"]}
    usage_ok = all(
        answers[n]["usage"]["prompt_tokens"] == len(render_chat(
            tok, reqs[n]["messages"]))
        and answers[n]["usage"]["total_tokens"]
        == answers[n]["usage"]["prompt_tokens"]
        + answers[n]["usage"]["completion_tokens"]
        for n in ("chat_a", "chat_b")) and (
        chat["usage"]["completion_tokens"] == len(chat_ids))
    usage = {n: answers[n]["usage"] for n in ("chat_a", "chat_b")}
    print(f"server llama3-8b ({SERVER_LAYERS} layers) slots 8 chunks 64: "
          f"{len(answers)} requests from "
          f"{len(plan)} threads in {wall_s:.2f} s; TTFT ms by request "
          f"{json.dumps(ttft)}; equal to alone {json.dumps(equal)}; streams "
          f"carry their answers' tokens {streams_ok}, joined text equal to "
          f"the answer's {json.dumps(joined_equal)}; chat usage "
          f"{json.dumps(usage)} ok {usage_ok}; end_session {ended}; load_signals "
          f"{json.dumps(signals)}; expired deadline shed with the engine "
          f"untouched {shed}; deadline of {SERVER_DEADLINE[0]} s raised "
          "after "
          f"{expired_s if expired_s is None else round(expired_s, 3)} s, "
          f"first token at {late.ttft_s()} s, request ran on to "
          f"{len(late_out.token_ids)} tokens; engine stats "
          f"{json.dumps(srv.engine.stats)}; launches {launches}; peak memory "
          f"{peak_gb:.2f} GB; device_memory_stats "
          f"{json.dumps(device_memory_stats())}", flush=True)
    if not (all(equal.values()) and streams_ok and usage_ok and ended
            and set(signals) == set(srv._loop.METRIC_NAMES) and shed
            and mid_generation):
        raise AssertionError("server phase gates failed")
    if any(launches.values()):
        raise AssertionError(f"the server path launched {launches}, "
                             "expected no flash kernel")
    return launches


def _profile(torch, label, fn, top=6):
    """Where one call's time goes, from a torch.profiler trace: the
    device's busy share of the host wall time, and the ``top`` kernels
    that take most of it.  A trace without device events reports 'not
    measured' and returns None; else returns the kernel time (us) by
    name."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel time summed by the first 60 characters of the name (one
    # family of templated kernels).  User annotations that the trace
    # draws on the device timeline (the optimizer step's range) are not
    # kernels and would count their time twice.
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            key = e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device time "
              "not measured (no device events in the trace)", flush=True)
        return None
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); top kernels "
          + json.dumps({name: round(us / 1e3, 3) for name, us in heaviest}),
          flush=True)
    return by_name


def _print_ptxas(build, lib):
    """Registers and spills of each kernel of ``csrc/<lib>.cu``, from the
    build's -Xptxas=-v log; returns the spill bytes (stores and loads)
    of each kernel it names."""
    log = build._library_path(lib).with_suffix(".log")
    if not log.exists():
        print(f"ptxas {lib}: no build log (library built elsewhere)",
              flush=True)
        return {}
    kernel, spills = None, {}
    for line in log.read_text().splitlines():
        found = re.search(r"Compiling entry function .*?"
                          r"(flash_(?:fwd|bwd)_\w+?_kernel)(?:ILi(\d+)E)?",
                          line)
        if found:
            kernel = found.group(1) + (f"<{found.group(2)}>"
                                       if found.group(2) else "")
        elif kernel and ("spill" in line or "registers" in line):
            print(f"ptxas {kernel}: {line.strip()}", flush=True)
            spilled = re.findall(r"(\d+) bytes spill", line)
            if spilled:
                spills[kernel] = sum(int(n) for n in spilled)
            if "registers" in line:
                kernel = None
    return spills


def kernels_line(rows, bwd_rows, paths):
    """The {"kernels": [...]} record of the fifteen kernels from the
    kernel phases' rows and the launches of every path; raises if a
    kernel that a main path should run was not launched on one."""
    by_path = {path: _by_kernel(c) for path, c in paths.items()}
    main_paths = [p for p in paths if not p.startswith("grad_check")]

    # Forward: S=4096, the largest prefill of the serving slice, for sm90,
    # where the CUDA-core kernel was also timed; GPT-2's fp32 shape for
    # tf32x3, where it was too; Gemma-7B's attention for sm90_d256, where
    # it was too; the d256 fp32 path's attention for tf32x3_d256, where it
    # was too, as at FP32_D256_ATTN, the CUDA-core kernel's main shape
    # (it is on no route).  Backward: the training slice's shape (the
    # first backward case) for sm90; GPT-2's fp32 shape for tf32x3, where
    # the CUDA-core pair was also timed; Gemma-7B's attention for
    # sm90_d256, where it
    # was too; the d256 fp32 path's attention for tf32x3_d256, where it
    # was too, as at FP32_D256_ATTN, the CUDA-core pair's main shape.  The
    # sm90_d256 kernels also give their times at Gemma-2B's attention and
    # at the d256 path's own.
    main_row = next(r for r in rows if r["shape"].startswith("B=1 Sq=4096 "))
    train_row = next(r for r in rows if r["shape"].startswith("B=8 Sq=2048 "))
    s512_fwd = next(r for r in rows if r["shape"] == _shape(
        *FP32_D256_ATTN, "float32", True))
    bwd_row = bwd_rows[0]
    # fp32 at head_dim 256: rows 1b-3b's shape and the d256 fp32 path's.
    fp32_d256 = {name: next(r for r in bwd_rows if r["shape"] == _shape(
        *attn, "float32", True)) for name, attn in (
            ("s512", FP32_D256_ATTN), ("d256_fp32_path", _d256_attn()))}
    fp32_d256_fwd = next(r for r in rows if r["shape"] == _shape(
        *_d256_attn(), "float32", True))
    gemma = {name: _shape(*attn, "bfloat16", True) for name, attn in
             (("gemma7b", GEMMA7B_ATTN), ("gemma2b", GEMMA2B_ATTN),
              ("d256_path", _d256_attn()))}
    gemma_rows = {name: next(r for r in rows if r["shape"] == shape)
                  for name, shape in gemma.items()}
    gemma_bwd_rows = {name: next(r for r in bwd_rows if r["shape"] == shape)
                      for name, shape in gemma.items()}
    # GPT-2's shape, the main path of the tf32x3 kernels (fp32) and of
    # the sm90 kernels at head_dim 64 without GQA (bf16).
    gpt2_shape = "B=8 Sq=1024 Skv=1024 H=12 KVH=12 D=64 {} causal"
    gpt2_rows = {dtype: next(r for r in rows
                             if r["shape"] == gpt2_shape.format(dtype))
                 for dtype in ("float32", "bfloat16")}
    gpt2_bwd_rows = {dtype: next(r for r in bwd_rows
                                 if r["shape"] == gpt2_shape.format(dtype))
                     for dtype in ("float32", "bfloat16")}

    def _gpt2_keys(dtype, timed, bound_ms, plain_ms, library_ms):
        return {"gpt2_shape": gpt2_shape.format(dtype),
                "gpt2_shape_ms": timed["ms"],
                "gpt2_shape_share_of_bound": timed["share_of_bound"],
                "gpt2_shape_bound_ms": bound_ms,
                "gpt2_shape_plain_ms": plain_ms,
                "gpt2_shape_library_ms": library_ms}

    def launches(name):
        return {"launches": sum(by_path[p][name] for p in main_paths),
                "launches_by_path": {p: by_path[p][name] for p in by_path}}

    def gemma_keys(other, row, timed, bound_ms):
        return {f"{other}_shape": row["shape"],
                f"{other}_shape_ms": timed["ms"],
                f"{other}_shape_share_of_bound": timed["share_of_bound"],
                f"{other}_shape_bound_ms": bound_ms,
                f"{other}_shape_plain_ms": row["plain_ms"],
                f"{other}_shape_library_ms": row["library_ms"]}

    def fwd_entry(name, route, source):
        g32 = gpt2_rows["float32"]
        extra = {}
        gpt2 = None
        if route == "sm90":
            at = timed = main_row
            err_rows = [r for r in rows if r["route"] == "sm90"]
            b16 = gpt2_rows["bfloat16"]
            gpt2 = ("bfloat16", b16, b16["bound_ms"])
            extra = {"train_shape_ms": train_row["ms"],
                     "train_shape_share_of_bound": train_row["share_of_bound"]}
        elif route == "tf32x3":
            # Its main shape is GPT-2's fp32 one.
            at = timed = g32
            err_rows = [r for r in rows if r["route"] == "tf32x3"]
            gpt2 = ("float32", g32, g32["bound_ms"])
            extra = {"bound_ms_fp32_fma": g32["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound": g32["share_of_fp32_fma_bound"],
                     "simt_ms_same_inputs": g32["simt"]["ms"]}
        elif route == "sm90_d256":
            # Its main shape is Gemma-7B's attention; also Gemma-2B's and
            # the d256 path's, each beside the CUDA-core kernel's time on
            # the same inputs.
            at = timed = gemma_rows["gemma7b"]
            err_rows = [r for r in rows if r["route"] == "sm90_d256"]
            extra = {"simt_ms_same_inputs": at["simt"]["ms"]}
            for other in ("gemma2b", "d256_path"):
                row = gemma_rows[other]
                extra.update(gemma_keys(other, row, row, row["bound_ms"]))
                extra[f"{other}_shape_simt_ms_same_inputs"] = \
                    row["simt"]["ms"]
        elif route == "tf32x3_d256":
            # Its main shape is the d256 fp32 path's attention; also
            # FP32_D256_ATTN, each beside the CUDA-core kernel's time on
            # the same inputs.
            at = timed = fp32_d256_fwd
            err_rows = [r for r in rows if r["route"] == "tf32x3_d256"]
            extra = {"bound_ms_fp32_fma": at["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound": at["share_of_fp32_fma_bound"],
                     "simt_ms_same_inputs": at["simt"]["ms"]}
            extra.update(gemma_keys("s512", s512_fwd, s512_fwd,
                                    s512_fwd["bound_ms"]))
            extra["s512_shape_share_of_fp32_fma_bound"] = \
                s512_fwd["share_of_fp32_fma_bound"]
            extra["s512_shape_simt_ms_same_inputs"] = s512_fwd["simt"]["ms"]
        else:
            # On no route: timed, launched directly, where its successors
            # run; its main shape is FP32_D256_ATTN in fp32, its bound the
            # fp32 FMAs'; also its times on the other kernels' inputs (bf16
            # at S=4096, the training shape and the head_dim-256 shapes;
            # GPT-2's and the d256 fp32 path's fp32 shapes).
            at, timed = s512_fwd, s512_fwd["simt"]
            err_rows = [r["simt"] for r in rows if "simt" in r]
            gpt2 = ("float32", g32["simt"], g32["fp32_fma_bound_ms"])
            extra = {"s4096_ms": main_row["simt"]["ms"],
                     "train_shape_ms": train_row["simt"]["ms"]}
            for other, row in gemma_rows.items():
                extra[f"{other}_shape"] = row["shape"]
                extra[f"{other}_shape_ms"] = row["simt"]["ms"]
            path = fp32_d256_fwd["simt"]
            extra.update(gemma_keys("d256_fp32_path", fp32_d256_fwd, path,
                                    path["bound_ms"]))
        if gpt2 is not None:
            dtype, gpt2_timed, gpt2_bound_ms = gpt2
            extra.update(_gpt2_keys(dtype, gpt2_timed, gpt2_bound_ms,
                                    gpt2_rows[dtype]["plain_ms"],
                                    gpt2_rows[dtype]["library_ms"]))
        return {
            "name": name,
            "route": "cuda",
            "fwd_route": route,
            "source": f"ant_ray_tpu_torch/ops/csrc/{source}",
            "replaces": "ant_ray_tpu/ops/pallas/flash_attention.py:56",
            **launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in err_rows),
            "max_lse_err": max(r["lse_err"] for r in err_rows),
            "ms": timed["ms"],
            "tflops": timed["tflops"],
            "share_of_bound": timed["share_of_bound"],
            "plain_ms": at["plain_ms"],
            "bound_ms": timed.get("bound_ms", at["bound_ms"]),
            "bound_by": timed.get("bound_by", at["bound_by"]),
            **extra,
            "library_ms": at["library_ms"],
            "shape": at["shape"],
        }

    def bwd_entry(name, key, grads, route, source, line):
        g32 = gpt2_bwd_rows["float32"]
        g7 = gemma_bwd_rows["gemma7b"]
        extra = {}
        if route == "tf32x3_d256":
            # Its main shape is the d256 fp32 path's attention; also rows
            # 2b-3b's, each beside the CUDA-core pair on the same inputs.
            at = fp32_d256["d256_fp32_path"]
            timed = at["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "tf32x3_d256"]
            gpt2 = None
            extra = {"bound_ms_fp32_fma": timed["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound":
                         timed["share_of_fp32_fma_bound"],
                     "simt_ms_same_inputs": at["simt"][key]["ms"],
                     "simt_pair_ms_same_inputs": at["simt"]["dq"]["ms"]
                     + at["simt"]["dkv"]["ms"]}
            row = fp32_d256["s512"]
            extra.update(gemma_keys("s512", row, row["kernels"][key],
                                    row["bounds"][key][0]))
            extra["s512_shape_simt_ms_same_inputs"] = row["simt"][key]["ms"]
        elif route == "sm90_d256":
            # Its main shape is Gemma-7B's attention; also Gemma-2B's and
            # the d256 path's.
            at, timed = g7, g7["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "sm90_d256"]
            gpt2 = None
            extra = {"simt_pair_ms_same_inputs": g7["simt"]["dq"]["ms"]
                     + g7["simt"]["dkv"]["ms"]}
            for other in ("gemma2b", "d256_path"):
                row = gemma_bwd_rows[other]
                extra.update(gemma_keys(other, row, row["kernels"][key],
                                        row["bounds"][key][0]))
        elif route == "sm90":
            at, timed = bwd_row, bwd_row["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "sm90"]
            gpt2 = ("bfloat16", gpt2_bwd_rows["bfloat16"]["kernels"][key],
                    gpt2_bwd_rows["bfloat16"])
        elif route == "tf32x3":
            # Its main shape is GPT-2's fp32 one.
            at, timed = g32, g32["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "tf32x3"]
            gpt2 = ("float32", timed, g32)
            extra = {"bound_ms_fp32_fma": timed["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound":
                         timed["share_of_fp32_fma_bound"],
                     "simt_pair_ms_same_inputs": g32["simt"]["dq"]["ms"]
                     + g32["simt"]["dkv"]["ms"]}
        else:
            # On no route: timed, launched directly, where its successors
            # run, its main shape rows 2b-3b's (fp32, head_dim 256).
            at = fp32_d256["s512"]
            timed = at["simt"][key]
            err_rows = [r["simt"] for r in bwd_rows if "simt" in r]
            gpt2 = ("float32", g32["simt"][key], g32)
            path = fp32_d256["d256_fp32_path"]
            extra = {"gemma7b_shape": g7["shape"],
                     "gemma7b_shape_ms": g7["simt"][key]["ms"],
                     "train_shape": bwd_row["shape"],
                     "train_shape_ms": bwd_row["simt"][key]["ms"],
                     "d256_fp32_path_shape": path["shape"],
                     "d256_fp32_path_shape_ms": path["simt"][key]["ms"]}
        bounds_key = "fma_bounds" if route == "simt" else "bounds"
        bound_ms, bound_by, _flops = at[bounds_key][key]
        if gpt2 is not None:
            dtype, gpt2_timed, gpt2_row = gpt2
            extra.update(_gpt2_keys(dtype, gpt2_timed,
                                    gpt2_row[bounds_key][key][0],
                                    gpt2_row["plain_ms"],
                                    gpt2_row["library_ms"]))
        return {
            "name": name,
            "route": "cuda",
            "bwd_route": route,
            "source": f"ant_ray_tpu_torch/ops/csrc/{source}",
            "replaces": f"ant_ray_tpu/ops/pallas/flash_attention.py:{line}",
            **launches(name),
            "max_abs_err": max(r["abs_err"][g] for r in err_rows
                               for g in grads),
            "max_rel_err": max(r["rel_err"][g] for r in err_rows
                               for g in grads),
            "ms": timed["ms"],
            "tflops": timed["tflops"],
            "share_of_bound": timed["share_of_bound"],
            "plain_ms": at["plain_ms"],
            "plain": "flash_attention_backward_ref: dq, dk and dv in one call",
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **extra,
            "library_ms": at["library_ms"],
            "library": "scaled_dot_product_attention backward (fwd+bwd "
                       "minus fwd): dq, dk and dv",
            "shape": at["shape"],
        }

    # The CUDA-core forward, dQ and dK/dV kernels are on no route (timed
    # beside their successors only); every other kernel must run on a
    # main path.
    off_main_paths = {"flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"}
    for name in next(iter(by_path.values())):
        if name not in off_main_paths and not launches(name)["launches"]:
            raise AssertionError(f"{name} was not launched on the main path")
    return {"kernels": [
        fwd_entry("flash_attention_fwd_sm90", "sm90",
                  "flash_attention_fwd_sm90.cu"),
        fwd_entry("flash_attention_fwd_tf32x3", "tf32x3",
                  "flash_attention_fwd_tf32x3.cu"),
        fwd_entry("flash_attention_fwd_sm90_d256", "sm90_d256",
                  "flash_attention_fwd_sm90_d256.cu"),
        fwd_entry("flash_attention_fwd_tf32x3_d256", "tf32x3_d256",
                  "flash_attention_fwd_tf32x3_d256.cu"),
        fwd_entry("flash_attention_fwd", "simt", "flash_attention_fwd.cu"),
        bwd_entry("flash_attention_bwd_dq_sm90", "dq", ("dq",), "sm90",
                  "flash_attention_bwd_sm90.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_sm90", "dkv", ("dk", "dv"),
                  "sm90", "flash_attention_bwd_sm90.cu", 301),
        bwd_entry("flash_attention_bwd_dq_tf32x3", "dq", ("dq",), "tf32x3",
                  "flash_attention_bwd_tf32x3.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_tf32x3", "dkv", ("dk", "dv"),
                  "tf32x3", "flash_attention_bwd_tf32x3.cu", 301),
        bwd_entry("flash_attention_bwd_dq_sm90_d256", "dq", ("dq",),
                  "sm90_d256", "flash_attention_bwd_sm90_d256.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_sm90_d256", "dkv", ("dk", "dv"),
                  "sm90_d256", "flash_attention_bwd_sm90_d256.cu", 301),
        bwd_entry("flash_attention_bwd_dq_tf32x3_d256", "dq", ("dq",),
                  "tf32x3_d256", "flash_attention_bwd_tf32x3_d256.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_tf32x3_d256", "dkv",
                  ("dk", "dv"), "tf32x3_d256",
                  "flash_attention_bwd_tf32x3_d256.cu", 301),
        bwd_entry("flash_attention_bwd_dq", "dq", ("dq",), "simt",
                  "flash_attention_bwd.cu", 196),
        bwd_entry("flash_attention_bwd_dkv", "dkv", ("dk", "dv"), "simt",
                  "flash_attention_bwd.cu", 301)]}


# Faults that --plant-d256-fault writes into a copy of a source of
# ops/csrc/, as (file, this text, that text).  In
# flash_attention_bwd_sm90_d256.cu (bf16): block 0 of a dK/dV cluster
# skips rank 1's partial (at one KV head, a quarter of the query heads go
# missing from dK and dV); each dK/dV warpgroup takes its own P^T / dS^T
# fragments for the other's q columns; dK/dV's or dQ's causal mask also
# drops the diagonal.  In the fp32 pair, flash_attention_bwd_tf32x3_d256.cu:
# a dK/dV rank dropped and a diagonal masked as above, the row slices'
# sums of partial scores missing their last quarter (both kernels), and,
# in flash_attention_tf32x3.cuh, the split dropping the lo parts: one TF32
# product instead of three (in every tf32x3 kernel, the d256 fp32 path's
# forward and backward among them).  In the fp32 forward at head_dim 256
# (flash_attention_fwd_tf32x3_d256.cu, the d256 fp32 path's), the causal
# mask letting each row see one key ahead, and the row slices' sums of
# partial scores missing their last quarter.
_SM90_D256 = "flash_attention_bwd_sm90_d256.cu"
_TF32X3_D256 = "flash_attention_bwd_tf32x3_d256.cu"
_FWD_TF32X3_D256 = "flash_attention_fwd_tf32x3_d256.cu"
D256_FAULTS = {
    "dkv_rank_dropped": (_SM90_D256, "for (int r = 1; r < splits; ++r) {",
                         "for (int r = 2; r < splits; ++r) {"),
    "dkv_no_trade": (_SM90_D256,
                     "const uint4* from = w == wg ? mine : theirs;",
                     "const uint4* from = mine;"),
    "dkv_diagonal_masked": (
        _SM90_D256,
        "if (causal && row0 + 8 * (e >> 1) > q0 + 32 * wg + col + (e & 1))",
        "if (causal && row0 + 8 * (e >> 1) >= q0 + 32 * wg + col + (e & 1))"),
    "dq_diagonal_masked": (
        _SM90_D256,
        "if (causal && col + (e & 1) > row0 + 8 * (e >> 1)) p = 0.f;",
        "if (causal && col + (e & 1) >= row0 + 8 * (e >> 1)) p = 0.f;"),
    "fp32_dkv_rank_dropped": (
        _TF32X3_D256, "for (int from = 1; from < splits; ++from) {",
        "for (int from = 2; from < splits; ++from) {"),
    "fp32_quarter_dropped": (
        _TF32X3_D256, "for (int quarter = 0; quarter < 4; ++quarter) {",
        "for (int quarter = 0; quarter < 3; ++quarter) {"),
    "fp32_dkv_diagonal_masked": (
        _TF32X3_D256, "if (causal && k_pos0 + 8 * (e >> 1) > q0 + qc)",
        "if (causal && k_pos0 + 8 * (e >> 1) >= q0 + qc)"),
    "fp32_dq_diagonal_masked": (
        _TF32X3_D256,
        "if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * rr)",
        "if (causal && k0 + 8 * n + 2 * t + (e & 1) >= q_pos0 + 8 * rr)"),
    "fp32_one_tf32_product": (
        "flash_attention_tf32x3.cuh",
        "const int rest = __float_as_int(x[i] - __uint_as_float(s.hi[i]));",
        "const int rest = 0;"),
    "fp32_fwd_one_ahead": (
        _FWD_TF32X3_D256,
        "if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * j)",
        "if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * j + 1)"),
    "fp32_fwd_quarter_dropped": (
        _FWD_TF32X3_D256, "for (int quarter = 0; quarter < 4; ++quarter) {",
        "for (int quarter = 0; quarter < 3; ++quarter) {"),
}


def plant_d256_fault(fault, target):
    """A copy of this script and the package in ``target`` (new), without
    built libraries, with ``D256_FAULTS[fault]`` planted."""
    source, old, new = D256_FAULTS[fault]
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(target)
    shutil.copy2(os.path.join(here, "chip_smoke.py"), target)
    shutil.copytree(os.path.join(here, "ant_ray_tpu_torch"),
                    os.path.join(target, "ant_ray_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(target, "ant_ray_tpu_torch", "ops", "csrc", source)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{fault}: {old!r} is not in {path} once")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text.replace(old, new))


def d256_gate_readings(checkout, dtype_name="bfloat16"):
    """What CHECKOUT's head_dim-256 gates in ``dtype_name`` read, ungated
    (the module docstring's --d256-gate-readings and
    --d256-fp32-gate-readings)."""
    import math  # noqa: PLC0415

    sys.path.insert(0, os.path.abspath(checkout))
    import torch  # noqa: PLC0415

    import chip_smoke as cs  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dtype = getattr(torch, dtype_name)
    if dtype_name == "bfloat16":
        cs.BWD_TOL["bfloat16"] = dict.fromkeys(cs.BWD_TOL["bfloat16"],
                                               math.inf)
        cs.D256_GRAD_TOL = cs.BF16_LOSS_TOL = math.inf
        kernels = {r["shape"]: r["rel_err"]
                   for r in cs.bwd_kernel_phase(torch, fa)
                   if r["route"] == "sm90_d256"}
        remat = "none"
    else:
        kernels = {cs._shape(*attn, dtype_name, True): cs._fp32_d256_errs(
            torch, fa, attn, dtype) for attn in (cs.FP32_D256_ATTN,
                                                 cs._d256_attn())}
        remat = cs.D256_FP32_REMAT
    torch.cuda.empty_cache()
    cfg, params, tokens = cs._llama_d256(torch, llama, dtype)

    def grad_check():
        loss, ref_loss, err, launches = cs._d256_grad_check(
            torch, fa, llama, cfg, params, tokens, remat)
        return {"loss_err": abs(loss - ref_loss),
                "max_grad_err": max(err.values()), "grad_err": err,
                "launches": launches}

    out = {"checkout": os.path.abspath(checkout), "dtype": dtype_name,
           "remat": remat, "kernels": kernels, "grad_check": grad_check()}
    # The custom ops look the wrappers up at call time.
    kernels = fa.flash_attention_fwd_lse, fa.flash_attention_backward
    try:
        fa.flash_attention_backward = fa.flash_attention_backward_ref
        out["plain_backward"] = grad_check()
        fa.flash_attention_fwd_lse = fa.flash_attention_fwd_lse_ref
        out["plain"] = grad_check()
    finally:
        fa.flash_attention_fwd_lse, fa.flash_attention_backward = kernels
    return out


def _fp32_d256_errs(torch, fa, attn, dtype):
    """Max abs error of out and lse through flash_attention_fwd_lse, and
    max abs error over max |ref| of dq, dk and dv through
    flash_attention_backward, each against its plain version, causal, at
    ``attn`` (B, Sq, Skv, H, KVH, D) in ``dtype``."""
    batch, q_len, kv_len, heads, kv_heads, dim = attn
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand(batch, q_len, heads, dim), rand(batch, q_len, heads, dim)
    k, v = (rand(batch, kv_len, kv_heads, dim) for _ in range(2))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
        ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                          causal=True)
    errs = {"out": (out - ref_out).abs().max().item(),
            "lse": (lse - ref_lse).abs().max().item()}
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=True)
    return {**errs, **{key: _rel_err(g, w) for key, g, w in zip(
        ("dq", "dk", "dv"), got, want)}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # LLMEngine(<dir>) asks transformers, where it is installed, for the
    # directory's tokenizer: from local files only.  The clusters'
    # daemons never ask a metadata server for a maintenance event: the
    # cluster phase's notice is the chaos harness's file.
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    os.environ["ART_DISABLE_GCE_METADATA"] = "1"
    # A reference states and sets both: fp32 comparisons in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)

    for lib in ("flash_attention_fwd_sm90", "flash_attention_bwd_sm90",
                "flash_attention_fwd_tf32x3", "flash_attention_bwd_tf32x3",
                "flash_attention_fwd_sm90_d256",
                "flash_attention_bwd_sm90_d256",
                "flash_attention_fwd_tf32x3_d256",
                "flash_attention_bwd_tf32x3_d256"):
        spills = _print_ptxas(_build, lib)
        if lib == "flash_attention_fwd_tf32x3_d256" and any(spills.values()):
            raise AssertionError(f"{lib} spills: {spills}")

    t_script = time.perf_counter()

    def lap(name):
        # The script's clock at each phase's end: where the time limit goes.
        print(f"phase {name} ended at {time.perf_counter() - t_script:.1f} "
              "s", flush=True)

    rows = kernel_phase(torch, fa)
    bwd_rows = bwd_kernel_phase(torch, fa)
    model_check_phase(torch, llama)
    lap("kernels")
    paths = {"grad_check_fp32": grad_check_phase(torch, fa, llama)[0],
             "grad_check_bf16": bf16_grad_check_phase(torch, fa, llama)}
    paths["serve"], params, slice_info = slice_phase(torch, fa, llama)
    paths["parallel_serve"] = parallel_serve_phase(torch, fa, llama, params,
                                                   slice_info)
    paths["sessions"] = sessions_phase(torch, fa, llama, params)
    paths["loop"] = loop_phase(torch, fa, llama, params)
    lap("serving")
    engine = runtime_phase(torch, fa, llama, params)
    objects_phase(torch, engine, card)
    paths["cluster"] = cluster_phase(torch, fa, llama, params, engine, card)
    del engine, params
    torch.cuda.empty_cache()
    lap("runtime")
    paths["tracing"] = tracing_phase(torch, llama, card)
    lap("tracing")
    paths["deployment"] = deployment_phase(torch, llama, card)
    lap("deployment")
    paths["data"] = data_phase(torch, llama, card)
    lap("data")
    ops_tokens = {}
    paths["operations"] = operations_phase(torch, llama, card,
                                           keep=ops_tokens)
    lap("operations")
    paths["jobs"] = jobs_phase(torch, llama, card,
                               want=ops_tokens.get("tokens"))
    lap("jobs")
    paths["checkpoint"] = checkpoint_phase(torch, fa, llama)
    paths["server"] = server_phase(torch, fa, llama)
    lap("checkpoint and server")
    kept = {}
    paths["train"] = train_phase(torch, fa, llama, keep=kept)
    paths["parallel_train"] = parallel_train_phase(
        torch, fa, llama, *kept.pop("llama-400m"))
    paths.update(remat_phase(torch, fa, llama))
    paths["gpt2_fp32"] = gpt2_phase(torch, fa, "float32")[0]
    paths["gpt2_bf16"] = gpt2_phase(torch, fa, "bfloat16")[0]
    lap("training")
    paths["d256"] = d256_phase(torch, fa, llama)
    paths["d256_fp32"] = d256_fp32_phase(torch, fa, llama)
    lap("d256")
    paths["tune"] = tune_phase(torch, llama, card)
    lap("tune")
    collective_phase(torch, llama, card)
    paths["trainer"] = trainer_phase(torch, llama, card)
    lap("collective and trainer")
    paths["rllib"] = rllib_phase(torch, card)
    lap("rllib")
    print(json.dumps(kernels_line(rows, bwd_rows, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plant-d256-fault"]:
        plant_d256_fault(*sys.argv[2:4])
        sys.exit(0)
    readings_of = {"--d256-gate-readings": "bfloat16",
                   "--d256-fp32-gate-readings": "float32"}
    if sys.argv[1:2] and sys.argv[1] in readings_of:
        print(json.dumps(d256_gate_readings(
            sys.argv[2] if len(sys.argv) > 2 else
            os.path.dirname(os.path.abspath(__file__)),
            readings_of[sys.argv[1]])), flush=True)
        sys.exit(0)
    sys.exit(main())
