#!/usr/bin/env python3
"""Smoke run of client_tpu_torch on one NVIDIA GPU: lints the port with
its own static analyser (first, so that a finding costs seconds), builds
the kernels, holds each against its plain PyTorch version, serves the LM
over KServe-v2 HTTP through the continuous-batching engine, trains the flagship
LM through the flash-attention kernels, serves ResNet-50 and the CNN
through the dynamic batcher and the vision ensemble, serves ResNet-50
again from CUDA shared memory of another process, serves the LM engines
and ResNet-50 once more behind the server's operational surface (every
hook on: tracing, flight recorder, SLO watchdog, tenant QoS, response
cache, coalescing, admission, drain), runs the mixture-of-experts LM
through training and the engine, serves the builtin model set, runs
two engine replicas that share one cache through the fleet tier, trains
the flagship on a one-rank device mesh through the flash kernels' ring and
runs that ring over two ranks on the one card, streams the LM over the
gRPC frontend (and checks its clean refusal where grpcio is absent), and
times the kernels, the serial decode, the engine, the train step and the
vision models, then runs the port's perf_analyzer in process over the LM
engines and over gRPC against ResNet-50 from wire, system and CUDA
shared-memory inputs, holds ResNet-50's direct path (requests the
server does not batch) to the batcher's captured graphs and runs
perf_analyzer over HTTP through the port's own HTTP client, and last
drives the same server through the port's asyncio clients and
perf_analyzer's --async, two-rank and non-KServe modes, then balances
the LM and ResNet-50 across it and a second server process through the
port's replica set, kills that process under load, and runs
perf_analyzer over the pair, then through the native C++ load worker,
spawned load processes and TLS, and last runs the port's chaos round
under its lock-order, race and resource witnesses, gRPC streams behind
its fault proxy, and its traceview and profview.

    python3 chip_smoke.py

Phases, one line each or more; any failure exits non-zero:
  1 device      CUDA present; the card's name and power limit
  2 build       the CUDA kernels, from the sources in this checkout; each
                kernel's registers, stack and spills (cuobjdump -res-usage
                on the built library); beside them, in a process of its
                own, the CUDA shared-memory extension (cudashm.cpp)
  3 kernel      int8_matmul (kernel) against int8_matmul_reference on the
                card, on every route (bf16 from M = 5 on the tensor cores,
                and forced onto the CUDA-core tiled kernel and, at M 5-8,
                the GEMV too; the GEMV below and for f32 up to M = 8; f32
                above on the tiled kernel): M in
                {1..9,16,37,40,63,64,128,511}, (K,N) in {(256,256),
                (256,128),(256,768)}, x in bf16 and f32; each call's
                reported route is the one its shape and dtype name
  4 model       DEFAULT_LM_CONFIG int8 forward + 32-token greedy generate
                on cuda (kernel) against the same weights on cpu (plain),
                24 kernel launches per decode step
  5 server      the serving path: the language set behind
                Server(models=..., with_default_models=False), driven
                over HTTP with urllib
                (MAX_TOKENS=1 to lm_streaming_int8 and lm_streaming_batched,
                both on the continuous-batching engine, and to the serial
                lm_streaming), then engine.execute streams 32 tokens from
                each batched model, equal to its engine's own stream; the
                int8 stream against the serial _LmRunner.stream (equal, or
                diverging only at a near-tie: see NEAR_TIE); the launch
                counts are reset just before this phase and read just
                after it, with the launches by route (int8: GEMV and
                tensor cores; paged: CUDA-core and tensor-core splits),
                each of which the path must have run
  6 timings     each served kernel shape at M=1 (GEMV route, the
                tensor cores beside it), M=8 (decode at 8 lanes), the
                engine's prefill and verify M=16, 32, 40, 64, the served
                prompt M=63 and M=128 (tensor-core route, the GEMV beside
                it at M=8 and the CUDA-core tiled route above) beside its
                bound, the plain version
                and torch.matmul on the dequantized weight: device time
                from CUDA-graph replay and back-to-back eager time, both by
                CUDA events; serial decode tokens/s and TTFT
  7 flash       the flash forward, dQ and dK/dV kernels against
                _fa_forward_reference / _fa_backward_reference on the
                card: T in {128,512,100}, D in {32,64,128}, causal and not,
                f32 and bf16, BH in {2,5}, a zero and a nonzero lse
                cotangent, the main path's own shape (BH=64, T=512,
                D=64, bf16, causal) and the two-rank ring's shard shape
                (BH=64, T=256, D=64, bf16, causal and not: the diagonal
                and the past step of phase 19b); flash_attention at T=100 (padded by
                the wrapper) against plain_attention, forward and gradients.
                On an H100 80GB HBM3 (700 W) every bf16 error was at most
                one ulp of the output: 0.0156 for the forward and dQ,
                0.0313 for dK/dV (|dv| in [4, 8)); f32 dQ and dK/dV 0.0
  8 training    the training path: 10 Adam steps of the flagship config
                (__graft_entry__.entry(): vocab 8192, d_model 512, 4
                layers, bf16) on tokens [8, 513] with attn_impl="flash";
                the launch counts are reset just before and read just
                after (4/4/4 flash launches a step, no int8); the same 10
                steps with attn_impl="plain", every loss beside the flash
                one's; 3 float32 steps at 2 layers,
                flash against plain; forward flash against plain; a
                checkpoint save / restore / resume round trip
  9 timings     each flash kernel at the training shape (BH=64, T=512,
                D=64, bf16, causal; all three on the tensor cores) by
                CUDA-graph replay beside its bound, its plain version and
                scaled_dot_product_attention; the three once more at
                [32, 512, 128] (D=128) on a line of their own; the
                train step, plain and flash alternated, with its peak
                memory; a torch.profiler trace of 3 flash steps
 10 paged       paged_attention (kernel) against paged_attention_reference
                at the engine's shapes: decode B in {2,4,8}, T=1; verify
                B=8, T in {2,4,5}; prefill B=1, T in {16,32,64}; contexts 1
                to 511 with partly filled last blocks; hd in {16,32,64,128};
                bf16 and f32; shuffled, non-contiguous block tables.  Every
                pool row the mask excludes (the trash block included) is
                NaN for the kernel; the plain version reads a clean copy.
                Then queries at pos = -1 (no attended key: the mean of the
                whole table's V rows) on clean pools, decode, verify and
                prefill
 11 engine      LmEngine on DEFAULT_LM_CONFIG, every decode, verify and
                prefill tick a replay of a CUDA graph the engine captured
                at start: 16 concurrent greedy streams
                over 8 lanes (prompts of 1 to 200 tokens, two sharing a
                48-token prefix) in float32, each equal to the serial
                generate; the same in bf16 and int8 (equal, or diverging
                only at a near-tie); a preempted and resumed stream and a
                speculative run (k=4, n-gram) against greedy; the launch
                counts a tick, replays included (paged n_layers, int8 6 x
                n_layers); the KV audit clean after close().  Then the
                graphs themselves, in float32, bf16 and int8 (k=4): every
                pool row but the trash block's NaN and the lane buffers
                set while the engine captures, and untouched after; each
                captured program (decode at 2, 4, 8 lanes, verify at every
                (lanes, width), prefill at 16, 32, 64) replayed against
                its eager function on clones of the same pools and
                buffers, bit-equal, with the launches the eager run
                counted; the graphs against their bounds, capture
                seconds, memory_reserved before and after the set, and
                what the set keeps reserved once the cache is emptied
 12 timings     paged_attention by CUDA-graph replay at decode B=8,
                contexts 64, 256 and 511, verify B=8, T in {2,4,5} ending
                at key 256, and at prefill T=64, beside its
                bound, its plain version and scaled_dot_product_attention
                on K/V gathered through the table; the engine's aggregate
                tokens/s, TTFT and host ms a decode tick (tick_trace) at 1,
                4 and 8 concurrent streams (bf16 and int8, 128 tokens
                each); the device-busy share of a decode-heavy window
                under torch.profiler, its kernels and graph launches a
                decode tick, and one decode replay's device time at 8
                lanes (CUDA events) with the busy share it implies
 13 vision      ResNet-50 (_RESNET50_STAGES, 224, 1000 classes, bf16)
                and the CNN at 224, each behind the dynamic batcher with
                warmup: XLA's asymmetric SAME padding on the card (the
                stem 7x7/2 at 224, the 3x3/2 convs at 56, 28, 14, the
                max-pool at 112) against a stride-1 formulation; every
                bucket graph (1..64, 12 of them) replayed against the
                eager forward, bit-equal; the bf16 forward against the
                float32 forward of the same weights (VISION_BF16_TOL);
                device ms of a graph replay at buckets 1, 8, 32, 64 with
                images/s, MFU and the bound; capture seconds and
                memory_reserved; batch-1 binary requests over HTTP at
                concurrency 1, 8 and 32 (infer/s, p50/p99, the mean
                fused batch), then the device-busy share of a served
                window and its H2D and D2H bytes a request
                (torch.profiler); the launch counts reset before
                the serving and read after it: the vision path launches
                none of the hand-written kernels; the vision ensemble at
                224 (SCORES equal to its three steps called in turn, 0
                host hops, 2 device handoffs a request)
 14 cuda shm    ResNet-50 on phase 13's server with its tensors in CUDA
                shared memory: a client process of its own (SHM_CLIENT)
                makes one 602,112-byte input and one 4,000-byte output
                region a client thread, and one pair for a batch-64
                stream, registers them over HTTP (cudasharedmemory; the
                server opens each over CUDA IPC), and sends requests
                whose JSON names the regions: batch-1 at concurrency 1, 8
                and 32 (infer/s, p50/p99, mean fused batch, server ms a
                request) beside phase 13's wire figures, the answers read
                from the regions against the eager forward and, at
                concurrency 1, bit-equal to the wire's; the same three
                with no answer read back (perf_analyzer's own mode); a
                batch-64 stream (38,535,168 bytes a request) beside the
                same stream over the wire, bit-equal; profiled windows
                (after the same traffic, unprofiled) at 1, 8 and 32 of
                both paths: device-busy share and H2D / D2H bytes a
                request (under 1 KB from CUDA regions, at least the image
                and the scores over the wire); one request of the 224
                vision ensemble with its UINT8 images and SCORES in CUDA
                regions (0 host hops, SCORES equal to its steps in turn);
                the launch counts reset before and read after: none
 15 ops         the language set (lm_streaming_batched bf16,
                lm_streaming_int8) and a float32 lm_streaming_f32, all
                on the graph-captured engine at DEFAULT_LM_CONFIG, with
                ResNet-50, behind Server(response_cache, coalescing,
                TenantQoS(default_max_inflight=2, hi priority 10), an SLO
                objective every request breaches (p99 0.001 ms),
                max_inflight 64), tracing at trace_rate 1 into a file;
                every request over HTTP.  The launch counts reset before
                the server starts and read after 16 traced LM requests
                (tenants lo and hi, MAX_TOKENS=1: 8 float32 against
                serial generate, 4 bf16 and 4 int8 against their
                engines' own streams), which must launch int8 and paged
                attention; each request's server span carries its
                client's trace id, and decode and prefill tick spans are
                in the file; a third concurrent request of tenant lo: 429
                with an integer Retry-After; 16 identical ResNet-50
                requests from 8 threads: bit-equal, fewer executions,
                cache hits in the statistics and /metrics; one image from
                a CUDA region twice: no cache hit; /metrics (HELP, TYPE,
                contiguous, successes per model, GPU memory, the lm,
                prof and slo families); /v2/debug/prof (MFU of the
                adopted lm profilers against 989 TFLOP/s), flight (spans,
                prof_tick, ?dump=1), slo (the breach, its dump); the
                cost of the hooks, printed only: engine tokens/s at 8
                streams with and without the hooks and ResNet-50 infer/s
                at concurrency 8 with and without the front door, in
                turns; then drain: ready 503, infer 503 with Retry-After,
                ctpu_draining 1
 16 moe         the mixture-of-experts LM at MOE (the flagship's full
                width, 8 experts, top 2, bf16): the forward flash against
                plain (bf16, and f32 at 2 layers) with the router aux
                loss; 10 flash Adam steps on tokens [8, 513] (launch
                counts reset before and read after: 4/4/4 flash a step)
                beside 10 plain steps, the aux loss of every step; 16
                concurrent engine streams (phase 11's requests): float32
                equal to serial generate, bf16 and int8 from captured
                graphs equal to the same engine's programs run eagerly
                (each run's launches reset before and read after: int8
                4 x n_layers + the LM head a tick, paged attention
                n_layers; the expert stacks stay bf16), each stream's
                first divergence from serial generate, which a router
                near-tie may cause in bf16; every bf16 program replayed
                against its eager function, bit-equal; then, in turns
                with the dense flagship (dense, moe, moe, dense) in this
                process: engine tokens/s and TTFT at 1, 4 and 8 streams
                with MFU on the reference's FLOP count, the decode
                graph's device time at 8 lanes against its bound, the
                kernels a decode tick and the device-busy share
 17 builtin     the builtin set behind Server() (its default models, on
                the card): simple, simple_sequence (two interleaved
                sequences, an end and a restart), classifier with
                classification 2, a durable sequence with a repeated
                sequence_step (kept locally, the repeat replayed), the
                tiny vision pipeline; the launch counts reset before and
                read after: none
 18 fleet       two replicas in this process at DEFAULT_LM_CONFIG, each
                an LmEngine with graphs on a FleetTier bound to loopback,
                peered.  Prefix tier: A serves 16 prompts of 256 tokens
                one at a time (8 sharing prefixes of 64, 128 and 192
                tokens, 8 of 80, 176 and 240), then B: B installs A's
                exported blocks into its pool and its captured prefill
                starts past them; float32 streams equal serial generate
                on both, bf16 and int8 streams of B equal A's where B ran
                chunks A ran over the same KV, else held by NEAR_TIE;
                the KV audit clean on both.  Migration (float32): B parks
                a stream by preemption and drain()s, A resumes prompt +
                delivered tokens from the exported chain, equal to serial
                generate.  The launch counts reset before those runs and
                read after: int8 and paged attention.  Then bytes a block
                on the wire, the peer fetch's and the install's host ms,
                the prefill step's host ms with the tier (its export) and
                without, B's TTFT with the tier against an engine without
                one at 1 and 8 streams (bf16), in turns
 19 parallel    several devices.  (a) A one-rank NCCL world, make_mesh()
                with every dim 1 (programs.graphable: the mesh steps are
                CUDA graphs there), phase 8's tokens, TRAIN_LR: three mesh
                steps, each 3 graphed steps (the first eager, the second
                the capture, then a replay) against 3 eager steps
                (eager=True) from the same weights, losses and params
                bit-equal, the launch counts reset before and read after:
                ring_flash on the flagship's params laid out by
                param_specs (DTensors; 4/4/4 flash a step and a replay;
                against 3 single-device flash steps, losses within phase
                8's limits and params bit-equal), ring_flash on MOE (4/4/4
                a replay) and the GPipe step on pipeline_param_specs'
                layout, 2 microbatches (0 launches of rows 1-5; losses
                within phase 8's limits of 3 single-device plain steps).
                Each step's ms a step graphed and eager in turns (graph,
                eager, eager, graph; ring_flash between two legs of the
                graphed flash step), capture s, held and graph-pool MB,
                memory_reserved.  The NCCL capture probe: an all-reduce
                and a batch_isend_irecv pair to rank 0 itself (the mesh
                layer's collectives), each captured, replayed and held
                against its eager call; a refusal is printed, not raised.
                (b) Two gloo ranks on this one card, each a
                process loading the kernels this process built:
                make_mesh(sp=2) over gloo and ring_attention_sharded(
                impl="flash") forward and backward on DTensors at
                [8, 512, 8, 64] bf16 causal (256-token shards);
                out, dQ, dK, dV against one-rank flash_attention within
                TOL; each rank's launches of the three flash kernels
                (above 0), the largest |lse cotangent| its backward took
                (above 0: the ring's merge), the bytes its permutes staged
                through host memory and its ms a step
 20 kernels     one JSON line: every kernel of the served and trained
                paths (the int8 GEMV and tensor-core routes, the three
                flash kernels, paged attention's CUDA-core and tensor-core
                split routes; an entry is named by its wrapper, with the
                route in kernel_route), its launches on its path (phase 5
                or 8, phase 15's, launches_moe: phase 16's MoE engine
                streams and MoE training, launches_fleet: phase 18's
                replicas, launches_ring_flash and launches_ring_2rank:
                phase 19's, launches_grpc: phase 21's, launches_perf:
                phase 22's in-process legs, launches_http: phase 23's
                -i http LM leg, launches_aio: phase 24's aio calls,
                launches_balance: phase 25's balanced calls,
                launches_native: phase 26a's native-worker streams,
                launches_tls: phase 26c's HTTPS LM leg), its route's own
                error (phase 3, 7 or 10) and its times (phase 6, 9 or 12)
 21 grpc        the gRPC frontend (runs before phase 20's line; needs
                grpcio).  The language set behind Server(grpc_port=0),
                driven through the port's gRPC client (client_tpu_torch.
                grpc; a stream each by start_stream): ready,
                metadata and config of every model, the tokenizer, a
                decoupled ModelInfer refused (INVALID_ARGUMENT), a lone
                stream of lm_streaming_int8 and lm_streaming_batched equal
                to its engine's own, 4 concurrent streams of each against
                the serial runner (equal, or first diverging at a
                near-tie), a stream stopped by the client after 2 tokens,
                from the callback that reads the second (cancel_stream),
                giving its KV blocks back within GRPC_STOP_SLACK tokens of
                the stop (the server cancels the engine handle as the RPC
                ends); the stop's tokens split at the client's cancel,
                the server's notice (a context.add_callback) and the
                handle's cancel, with the delivery of token 2 timed and
                the readbacks in flight counted (StopSplit; the grpc_stops
                line, printed before the stop is checked;
                tools/grpc_phase.py runs the phase alone with
                GRPC_STOP_RUNS, 20, stops); the
                launch counts reset just before the first gRPC call and
                read just after the last, the references run outside
                that window (launches_grpc in phase 20)
 22 perf        the port's perf_analyzer (client_tpu_torch.perf; runs
                after phase 21, before phase 20's line).  (a) In this
                process, --hermetic --hermetic-models language:
                lm_streaming_batched (bf16) at concurrency 1 and 8 with
                --prefix-share 0.5 --shape TOKENS:1,128 (MAX_TOKENS 16,
                the prefix-share budget; the prefix columns must be
                non-zero), and lm_streaming_int8 at concurrency 8 with
                --speculative 4 on a JSON prompt (MAX_TOKENS 32; the
                speculative columns must be there); the launch counts
                reset just before each run's perf main and read just
                after it returns (launches_perf in phase 20).  (b) ResNet-50
                behind this process's Server(grpc_port=0), driven by
                python -m client_tpu_torch.perf -i grpc subprocesses at
                concurrency 1 and 8 with --shared-memory none, system and
                cuda (and cuda with --cuda-shm-sync), each with
                --collect-metrics --collect-local-gpu-metrics
                --probe-device-utilization: the server's success count
                equals the client's count of the run, no failure on
                either side, the CUDA regions seen over
                CudaSharedMemoryStatus and opened over CUDA IPC, the
                ctpu_gpu_memory_* and ctpu_probe_* gauges in the export;
                then a client process's request from CUDA regions equal
                to the wire's bit for bit, and the device probe
                calibrated under a known load, in this process and from
                the client's (from the client's, more samples must read
                busy under the load than without it: the time slice; in
                this process it reads the kernels' occupancy, recorded
                and not checked).  Every leg prints infer/s, p50/p99 and the
                harness's JSON export record
 23 http        the direct path and perf_analyzer over HTTP (runs after
                phase 22, before phase 20's line): ResNet-50 (warmup: a
                graph a bucket) and the language set behind one
                Server(grpc_port=0).  (a) Host requests through the port's
                HTTP client (client_tpu_torch.http) whose output lies in a
                system region, which the server does not batch: 8 each on
                a new connection (a new server thread), 8 on one kept
                connection, one of 3 rows, one with a request parameter,
                one whose input lies in a CUDA region on the card and
                that carries a parameter (the program's device route);
                each must replay the batcher's bucket graph
                (direct_runs, one a request) and run no eager forward
                (model.fn counted from after the capture), launch none of
                the hand-written kernels, and equal the same images'
                answer through the batcher bit for bit; the server's
                compute ms of each request on a new thread and on the kept
                one.  (b) Phase 22's ResNet-50 wire and system-region legs
                over gRPC again, at concurrency 1 and 8, side by side;
                then both at once, each at concurrency 8 in a process of
                its own (the system-region clients on request threads,
                the wire clients on the batcher thread, sharing each
                program's lock): the wire leg's p50/p99 and infer/s beside
                its solo run, the server's successes equal to the two
                clients' counts, the system leg still running when the
                wire leg ends.
                (c) python -m client_tpu_torch.perf -i http subprocesses
                against ResNet-50 with --shared-memory none, system and
                cuda, and against lm_streaming_int8 with MAX_TOKENS 1 (a
                decoupled model answers over HTTP with one response): the
                server's success count equals the client's, no failure,
                the gauges in the export, the CUDA regions opened over
                IPC; the LM leg's launch counts reset just before its
                client starts and read just after it exits must hold
                int8 and paged attention (launches_http in phase 20)
 24 aio         the asyncio clients and perf_analyzer's remaining
                single-endpoint modes, on phase 23's server before it
                stops (runs before phase 20's line).  (a) 8 concurrent
                grpc.aio stream_infer streams on one event loop for
                lm_streaming_int8 and for lm_streaming_batched, each
                equal to the sync client's stream of its prompt
                (grpc_stream) or first diverging at a near-tie, and one
                stream closed after 2 tokens (the call cancelled) giving
                its KV blocks back within GRPC_STOP_SLACK tokens;
                (b) 16 concurrent http.aio calls of lm_streaming_int8
                with MAX_TOKENS 1 against the sync HTTP client's answers
                (the near-tie rule), a binary ResNet-50 request bit-equal
                to the sync client's, and the CUDA verbs: a region on the
                card registered, listed, read by a request (bit-equal to
                the wire) and unregistered; the launch counts are reset
                just before (a)'s and (b)'s aio calls and read just after
                them (launches_aio in phase 20); (c) python -m
                client_tpu_torch.perf -i grpc --max-threads 64 against
                ResNet-50 at concurrency 8 and 64, the thread engine and
                --async from the wire in turns (threads, async, threads),
                then --async from CUDA regions, each with phase 22's
                checks (server successes equal the client's count, no
                failure, the gauges), the perf process's OS threads
                sampled from /proc (the async runs must have fewer than
                the thread engine's); (d) two ranks, --world-size 2
                through the rendezvous, at concurrency 8: both exit 0,
                rank 0 alone prints the aggregate, their counts sum to
                the server's successes; (e) --service-kind torchserve,
                tfserve and tfserve_rest --hermetic against the port's
                host fakes, beside the other legs
 25 balance     the replica set (client_tpu_torch.balance) on phase 23's
                server (replica A, before it stops) and a second server
                process on the card, B (python -m client_tpu_torch.serve
                --models resnet,language: the same seeds), and B's
                replacement, started with B.  (a) ReplicatedClient
                (round-robin) sends 8 MAX_TOKENS-1 lm_streaming_int8
                calls over HTTP and 4 decoupled token streams over gRPC
                (a ReplicatedClient a stream on one shared pool) across
                A and B: each equal to the sync client's answer from A
                alone (the near-tie rule), ctpu_client_routed_total
                within one of even on each pool; (b) 8 threads of
                ResNet-50 over HTTP (least-inflight, probes every 50 ms),
                B SIGKILLed after 2 s: no client-visible error, every
                answer bit-equal to one of A's rows for the image in a
                group 8 one-row clients can form (n copies padded with
                zero rows to the batcher's bucket), B UNREACHABLE and its
                routed count still from then on, the failovers and the
                p50/p99 before and after; (c) python -m client_tpu_torch.
                perf -u A,B' (B's replacement) on ResNet-50 at 8 over
                gRPC and over HTTP: the per-endpoint split printed, each
                endpoint's count of the run equal to its server's
                success delta; then --churn-soak 0.5 over HTTP: exit 0,
                no failure.  The launch counts in A's process are reset
                before (a)'s balanced calls and read after (c): int8 and
                paged attention must have launched (launches_balance in
                phase 20)
 26 native      perf_analyzer's last load engines and SSL, on phase 23's
                server before it stops.  (a) perf_worker, the C++ engine:
                src/cpp/perf/perf_worker.cc over the port's protobuf-free
                client (client_tpu_torch/perf/csrc), built by g++ alone
                into build/torch_cpp (no protoc, no libprotobuf: a build
                that fails fails the phase); its build time and ldd's
                list of its libraries printed, none libprotobuf;
                --native-loadgen on ResNet-50 at 1 and 8 from the wire
                and from CUDA regions, with and without --cuda-shm-sync
                (exit 0, no error at any level, no server failure), the
                wire leg's infer/s, p50 and p99 at 8 beside phase 22's
                Python gRPC wire leg at 8; the worker's 8 decoupled
                lm_streaming_int8 streams (TOKENS 64 of 7, MAX_TOKENS
                16): no error, its count of the streams that ended in
                its window at most the server's successes, int8 and
                paged attention launched (launches_native in phase 20).
                (b) procpool: 2 spawned
                processes x 4 against ResNet-50 from CUDA regions this
                process registered, referenced by name
                (export_region_specs): no error, every request the
                workers sent equal to the server's successes, no worker
                pid among nvidia-smi's compute apps while they run.  (c)
                TLS relays (stdlib ssl, a certificate openssl makes for
                localhost and 127.0.0.1; ALPN h2 for gRPC) in processes of
                their own: ResNet-50 at 8 over -i grpc
                --ssl-grpc-use-ssl with the root certificate, then the
                plain wire, over -i http with the CA, then the plain wire,
                --ssl-https-verify-peer 0 with no CA, a relay that
                requires a client certificate with it (passes) and
                without it (exits non-zero, nothing served);
                lm_streaming_int8 over HTTPS with MAX_TOKENS 1, int8 and
                paged attention launched (launches_tls in phase 20).
                Every client count equals its server's.  Phases 22-26's
                client processes start through tools/torch_free.py:
                those that need no torch (the service kinds, the runs
                across A and B, the TLS relays and the perf runs through
                them, the native legs from the wire) with
                sys.modules["torch"] = None, the rest (CUDA regions, the
                local GPU gauges and probe) with torch; each prints its
                torch_loaded and seconds from spawn to its first request,
                gathered on 26's client_starts line (a torch-free one
                that loaded torch fails it)
 27 chaos       the failure-domain checks on phase 23's server, after
                26.  (a) The port's LockWitness, RaceWitness and
                ResourceWitness installed before anything is built, then
                tests/test_chaos.py's spec-cancel-preempt round under the
                port's ChaosMatrix (scenario seed 5) on an LmEngine at
                DEFAULT_LM_CONFIG's width and depth, CUDA-graph ticks,
                speculative k = 4, its pool sized so the gold admission
                must preempt stream A: float32 (A and gold byte-exact to
                the serial generate), then lm_streaming_int8's weights
                (equal to the same round run first without witnesses,
                the near-tie rule of int8 streams).  After each: a
                preemption, speculation accepted, assert_kv_clean after
                close, the lock graphs acyclic, race-free, the resource
                witness's acquisitions > 0 with none live.  (b) 8
                lm_streaming_int8 streams through the port's gRPC client,
                7 behind one FaultProxy (refused, then restored) and one
                behind another whose link dispatch_fault kills mid-stream:
                that stream ends with a connection-level error, the 7
                equal the undisturbed answers, the server drains and its
                engine's pool is clean after close; the client's and the
                server's trace files joined by the port's traceview: one
                timeline a stream, queue + compute + wire equal to the
                client's duration within 1 ms.  (c) python -m
                client_tpu_torch.profview --live (the cnn on the card,
                exit 0, a device share) and profview over the server's
                /v2/debug/prof report (the LM engine's ticks).  The
                launch counts are reset just before (a)'s witnessed
                rounds and (b)'s streams and read just after: int8 and
                paged attention must have launched (launches_chaos in
                phase 20)
 28 analysis    (runs right after phase 1, so that a failure costs
                seconds) the port's static analyser: python -m
                client_tpu_torch.analysis client_tpu_torch examples_torch
                --no-cache --json in a process of its own, exit 0 and 0
                findings
                (the port's baseline.json grandfathers the syncs that
                ops.CAPTURE_LOCK exists to hold), then each torch key's
                fixture under tests/analysis_fixtures/torch: every _bad
                fixture fires its rule, no _ok fixture fires anything;
                the package's __version__, the rules fired, seconds
 29 examples    (last, after phase 27) the port's examples corpus
                (examples_torch/) against one Server in this process
                serving the language set, ResNet-50 and the builtin set:
                (a) every example with -u (image_client.py with -m
                resnet50, the three replica examples with --device cuda
                and servers of their own), EXAMPLE_JOBS processes at a
                time (model control alone, the system-region examples
                one after another); (b) together, the examples that
                stage tensors in CUDA regions of their own process (both
                cudashm examples and image_client.py --shared-memory cuda
                -m resnet50), opened by the server over CUDA IPC, beside
                llm_streaming_client.py --hermetic: the server's copies
                by direction in that window (torch.profiler; under 1 KiB
                from the host, and to it only ResNet-50's 4,000 bytes
                of logits beside 1 KiB), the regions it
                opened over IPC, its registry empty after; (c) the C++
                HTTP examples and cc_client_test, built at first use with
                g++ alone (beside (a) and (b)), against the same server
                (model control and cc_client_test, which unloads simple,
                alone).  The schedule is tools/examples_suite.py's GROUPS.
                Per run: rc,
                seconds and PASS line; any failing run fails the script.
                The reference's examples (clients of the JAX package)
                are not run on the card; tests/test_torch_examples_
                reference.py runs them against the port's server.  The
                launch counts are reset before (a) and read after (c)
                (launches_examples in phase 20: none of these paths runs
                a hand-written kernel)
Every timing line carries the card's name and power limit.  Before the
kernels line, script_seconds: the process's seconds so far, phase 19's
and phases 22-26's.  The last line is {"ok": true, "device": {...}}.
"""

import asyncio
import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import gzip
import importlib.util
import io
import itertools
import json
import os
import queue
import re
import select
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores

# stated tolerances: kernel against its plain version on the same inputs
TOL = {
    torch.float32: (1e-4, 1e-4),   # atol, rtol: f32 sums in another order
    torch.bfloat16: (2e-2, 1e-2),  # one bf16 ulp of the f32-summed result
}
# model on cuda (kernel) against cpu (plain), both bf16: a few bf16 ulps at
# the logits' magnitude (2..4, ulp 1/64) after four layers of bf16 rounding
LOGIT_ATOL = 0.1
MIN_AGREE = 0.9  # greedy positions; allows the documented bf16 near-ties
# a bf16 or int8 stream of the batched engine against the serial runner
# (other kernels, other sums): equal, or diverging first where the serial
# logits of the two tokens lie within the bf16 logit tolerance above — a
# near-tie, which either order of the sums may resolve either way
NEAR_TIE = LOGIT_ATOL

# the int8 routes (every served N is a multiple of 16): bf16 from M = 5 on
# the tensor cores, the GEMV kernel below that and for f32 up to M = 8, f32
# above on the CUDA-core tiled kernel
M_LIST = tuple(range(1, 10)) + (16, 37, 40, 63, 64, 128, 511)
GEMV_MAX_M = 8
MMA_FROM_M = 5
# int8_matmul.cu's routes, as the binding numbers them for int8_matmul_route
INT8_ROUTE_IDS = {"gemv": 1, "tiled": 2, "mma": 3}
# the engine's int8 shapes timed in phase 6: decode lanes, prefill chunks
# (16, 32, 64), a verify tick (8 lanes x width 5), the served prompt, 128
TIMED_M = (1, 8, 16, 32, 40, 63, 64, 128)
SERVED_KN = ((256, 256), (256, 128), (256, 768))
# the MoE config's (MOE, phase 16) int8 shapes: wq and wo, wk and wv, the
# 8192-wide LM head (the expert stacks stay bf16)
MOE_KN = ((512, 512), (512, 256), (512, 8192))
# one layer's six kernel projections: wq, wk, wv, wo, w_gate, w_up
LAYER_KN = ((256, 256), (256, 128), (256, 128), (256, 256), (256, 768),
            (256, 768))
PROMPT = "KServe-v2 streaming inference on Hopper: the quick brown fox. "

# the flagship LM of __graft_entry__.entry(), at full width and depth
FLAGSHIP = dict(vocab_size=8192, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=4, d_ff=1536, max_seq=512)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, TRAIN_STEPS, TRAIN_LR = 8, 512, 0, 10, 1e-3
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# stated tolerances, training path:
# - bf16, flash against plain from the same weights: the first loss differs
#   only by the attention's rounding (plain and the bf16 kernels round p,
#   and the backward kernels ds, to bf16 before their products, at other
#   points of the softmax), averaged over 4096 tokens; over the 10 Adam
#   steps the two bf16 trajectories drift apart by their own rounding.
#   On an H100 80GB HBM3 (700 W) the losses (9.525 falling to 0.102)
#   differed by 1.4e-4 at step 1, by at most 1.05e-2 (step 5) and by 8.2e-4
#   at step 10 with the tensor-core backward (1.4e-4, 1.1e-2 and 6.9e-4
#   with f32 products in the backward; 1.2e-4, 2.7e-3 and 2.2e-4 with f32
#   products in the forward too, where the limits were set at about 10x);
#   each limit stays well below the loss it bounds
TRAIN_LOSS0_ATOL = 2e-3
TRAIN_LOSS_STEP_ATOL = 0.03
TRAIN_LOSS_LAST_ATOL = 2e-3
# - the MoE config (MOE), bf16, flash against plain: the limits above,
#   with the plain run routed at every step as the flash run was (a token
#   whose router logits lie near a tie would otherwise take other experts
#   on either side, and move both trajectories apart).  On an H100 80GB
#   HBM3 (700 W) the losses (9.540 and 9.518 falling to 0.0725 and 0.0677,
#   seeds 0 and 1) differed by 1.9e-4 and 4.2e-5 at step 1, by at most
#   3.8e-3 and 7.0e-3, and by 1.4e-5 and 3.2e-4 at step 10
MOE_TRAIN_SEEDS = (TRAIN_SEED, TRAIN_SEED + 1)  # the weights' and tokens'
#   (the forward: flash against plain on one routing, the flash run's;
#   where the plain run's own top-k differs at more than this share of
#   the decisions, that is a fault, not a near-tie)
MOE_ROUTING_DIFF = 0.1
#   The logits of that forward, at every position: 4 bf16 ulps (1/32) at
#   logits of 4..8, where LOGIT_ATOL's 0.1 is 3.2.  On an H100 80GB HBM3
#   (700 W) the MoE forward (logits up to 5.97) read 0.1016 and 0.0957
#   (seeds 0, 1) at its worst of 33.5M logits, the dense flagship's 0.078
#   (phase 8): the expert combine rounds once more than the dense MLP
MOE_LOGIT_ATOL = 0.125
# - float32 (TF32 off), flash against plain: sums in another order
F32_LOSS_ATOL = 1e-4
# float32 losses of the graphed train step against the eager step from the
# same weights: cuBLAS may pick other algorithms inside a capture
GRAPH_F32_LOSS_ATOL = 1e-5
F32_LOGIT_ATOL = 1e-4
# - flash_attention through the padding against plain_attention, f32
WRAPPER_TOL = (1e-4, 1e-3)


# every process this script starts (popen), each the leader of a session
# of its own; stop_children ends them and whatever they started, however
# the run ends
CHILDREN = []


def popen(argv, **kw):
    """``subprocess.Popen`` in a new session, registered in CHILDREN."""
    proc = subprocess.Popen(argv, start_new_session=True, **kw)
    CHILDREN.append(proc)
    return proc


def stop_children():
    """Kill every process group popen started that still has a process
    (a child that exited may have left its own children) and every
    multiprocessing child, and reap them."""
    import multiprocessing

    while CHILDREN:
        proc = CHILDREN.pop()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    for child in multiprocessing.active_children():
        child.kill()
        child.join(timeout=30)


# -- client processes that need no torch (phases 22-26) ------------------

HERE = os.path.dirname(os.path.abspath(__file__))
TORCH_FREE = os.path.join(HERE, "tools", "torch_free.py")
TLS_RELAY = os.path.join(HERE, "tools", "tls_relay.py")
# perf CLI options that need torch in the client's own process
TORCH_OPTIONS = ("--collect-local-gpu-metrics",
                 "--probe-device-utilization", "--device")
# one entry a client process started through client_argv, with its
# phase, its start line (tools/torch_free.py) and whether torch was
# blocked in it
CLIENT_STARTS = []
# phases 22-26's seconds, each from its own start to its "done" line
PHASE_SECONDS = {}


def _tool(name):
    """A module of tools/ loaded from its file (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TlsRelay = _tool("tls_relay").TlsRelay


def needs_torch(argv):
    """Whether a client process of *argv* needs torch: a CUDA region,
    the local GPU gauges or the probe, a device (the client code strings
    that use them pass ``torch=True`` to client_argv)."""
    return (any(a in TORCH_OPTIONS for a in argv)
            or any(a == "--shared-memory" and b == "cuda"
                   for a, b in zip(argv, argv[1:])))


def client_argv(argv, torch=None):
    """*argv* (``[sys.executable, ...]``) run through tools/torch_free.py:
    torch blocked (``sys.modules["torch"] = None`` before the process runs
    its module) unless it needs torch (*torch*, else needs_torch), and
    its start timed either way (client_start reads the line)."""
    if torch is None:
        torch = needs_torch(argv)
    return [sys.executable, TORCH_FREE,
            *(["--with-torch"] if torch else []), *argv[1:]]


def client_env(env=None):
    """The environment of a client_argv process: PYTHONPATH this
    checkout, and the spawn time its start is counted from (call this
    in the Popen call, just before the process starts)."""
    return {**(env or {**os.environ, "PYTHONPATH": HERE}),
            "TORCH_FREE_SPAWN_T": repr(time.time())}


def client_start(n, label, argv, stderr, waits=False):
    """Note the start line of a client_argv process (phase *n*) from its
    standard error, and return the rest of it.  Fails where the line is
    missing or where a process started with torch blocked loaded it.
    *waits*: its first request waits on another process's (a relay's
    on its first client's), so its start_s is no start-up time."""
    lines = (stderr or "").splitlines(keepends=True)
    mine = [ln for ln in lines if ln.startswith("torch_free: ")]
    rest = "".join(ln for ln in lines if not ln.startswith("torch_free: "))
    check(len(mine) == 1, f"{label}: {len(mine)} start lines: {rest[-2000:]}")
    rec = json.loads(mine[0][len("torch_free: "):])
    blocked = "--with-torch" not in argv[:3]
    check(not (blocked and rec["torch_loaded"]),
          f"{label} was started torch-free and loaded torch: {rec}")
    CLIENT_STARTS.append({"phase": n, "client": label,
                          "torch_blocked": blocked, "waits": waits, **rec})
    return rest


def client_starts_summary(card):
    """Phase 26's closing line on phases 22-26's client processes: each
    one's torch_loaded and seconds from spawn to its first request, and
    the median and range of each kind (the relays' aside: see
    client_start's *waits*)."""
    kinds = {}
    for rec in CLIENT_STARTS:
        if rec["start_s"] is not None and not rec["waits"]:
            kinds.setdefault(rec["torch_loaded"], []).append(rec["start_s"])
    summary = {("torch_loaded" if k else "torch_free"): {
        "processes": len(v), "start_s_median": float(np.median(v)),
        "start_s_min": min(v), "start_s_max": max(v)}
        for k, v in kinds.items()}
    check(any(not r["torch_loaded"] for r in CLIENT_STARTS),
          "no client process of phases 22-26 ran torch-free")
    phase(26, "client_starts", processes=CLIENT_STARTS, summary=summary,
          start_s_from="the parent's time.time() just before Popen to the "
                       "process's first socket connect or gRPC channel",
          **card)


def process_seconds():
    """Seconds since this process started (its start time in
    /proc/self/stat against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def phase(n, name, **fields):
    print(json.dumps({"phase": n, "name": name, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def eager_ms(fn, iters=200, warmup=20):
    """Mean time of one fn() call issued back to back from Python, by CUDA
    events: the host's launch overhead included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=100, replays=5):
    """Device time of one fn() call: *iters* calls captured in one CUDA
    graph, replayed and timed by CUDA events, so the host's launch
    overhead is out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(m, k, n):
    """Least time for x[m,k] bf16 @ q[k,n] int8 * s[n] f32 -> [m,n] bf16:
    each input read once and the output written once, against HBM; the
    multiply-adds against the bf16 dense peak."""
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    flops = 2 * m * k * n
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3


def int8_route(m, n, dtype=torch.bfloat16):
    """The int8 kernel's route at this shape, as int8_matmul.cu's launch()
    picks it for 16-byte-aligned tensors, K a multiple of 16 and x within
    48 KB (phase 3 checks the route each call reports against this)."""
    mma = dtype == torch.bfloat16 and n % 16 == 0
    if mma and m >= MMA_FROM_M:
        return "mma"
    if m <= GEMV_MAX_M and n % 16 == 0:
        return "gemv"
    return "mma" if mma else "tiled"


def kernel_resources(library):
    """{kernel<D>: {"registers", "stack_bytes", "local_bytes"}} of every
    kernel in the built library, read by the toolkit's cuobjdump
    (-res-usage); "not measured" where the tool is missing or fails.  LOCAL
    is what spills to memory."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return "not measured"
    run = subprocess.run([tool, "-res-usage", library], capture_output=True,
                         text=True, timeout=120)
    if run.returncode:
        return "not measured"
    dump = run.stdout
    out = {}
    for name, reg, stack, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
            dump):
        # the last length-prefixed name ending in _kernel, then its
        # template arguments: integers (Li64E) and the types f and bf16
        kernel = re.search(
            r".*\d((?:fa|int8|paged)_[a-z0-9_]*?_kernel)(?:I(.*?)EE)?", name)
        key = kernel.group(1) if kernel else name
        args = [num or ("f32" if typ == "f" else "bf16")
                for num, typ in re.findall(r"Li(\d+)|(f|13__nv_bfloat16)",
                                           kernel.group(2) or "")
                ] if kernel else []
        key = f"{key}<{','.join(args)}>" if args else key
        out[key] = {"registers": int(reg), "stack_bytes": int(stack),
                    "local_bytes": int(local)}
    return out


def http(addr, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://{addr}{path}", data=body, headers=headers or {},
        method="POST" if body is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def lm_request(tokens, max_tokens):
    return json.dumps({"inputs": [
        {"name": "TOKENS", "shape": [len(tokens)], "datatype": "INT32",
         "data": [int(t) for t in tokens]},
        {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32",
         "data": [max_tokens]},
    ]}).encode()


def dtype_name(dt):
    return str(dt).replace("torch.", "")


def flash_bounds(bh, t, d, causal, elt=2):
    """{kernel: (bound_ms, bound_by)} for the flash kernels on [bh, t, d]
    inputs of elt bytes: each input read once and each output written once
    over HBM, against the operations these inputs need (only the (q, k)
    pairs on or below the diagonal when causal) over the bf16 dense
    peak."""
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    mat, row = bh * t * d * elt, bh * t * 4
    work = {
        # q, k, v in; out, lse out; s = q.k and p.v
        "flash_fwd": (4 * mat + row, 4 * pairs * d),
        # q, k, v, dO, lse, delta, g_lse in; dq out; s, dO.v, ds.k
        "flash_bwd_dq": (5 * mat + 3 * row, 6 * pairs * d),
        # the same in; dk, dv out; s, dO.v, p.dO, ds.q
        "flash_bwd_dkv": (6 * mat + 3 * row, 8 * pairs * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        out[name] = (max(by_bytes, by_ops) * 1e3,
                     "bytes" if by_bytes >= by_ops else "operations")
    return out


def flash_vs_plain(fa, gen, main_shape, ring_shape):
    """Phase 7: every flash kernel against its plain version on the card,
    over a grid of shapes, at ``main_shape`` ([BH, T, D] of the training
    step, bf16, causal) and at ``ring_shape`` (a shard of phase 19b's ring,
    bf16, causal and not).  Returns ({kernel: {dtype: max abs err}}, cases,
    {kernel: max abs err} at ``main_shape``, {"causal" / "past": {kernel:
    max abs err}} at ``ring_shape``)."""
    worst = {name: {} for name in FLASH_KERNELS}

    def hold(name, dt, got, want, what, tol=None):
        atol, rtol = tol or TOL[dt]
        got, want = got.float(), want.float()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"{what}: max abs err {err.max().item()} beyond atol {atol} "
              f"rtol {rtol}")
        key = dtype_name(dt)
        worst[name][key] = max(worst[name].get(key, 0.0), err.max().item())
        return err.max().item()

    def case(dt, bh, t, d, causal):
        errs = dict.fromkeys(FLASH_KERNELS, 0.0)

        def held(name, *args):
            errs[name] = max(errs[name], hold(name, dt, *args))

        q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(dt).cuda()
                      for _ in range(4))
        scale = d ** -0.5
        what = f"{dtype_name(dt)} BH={bh} T={t} D={d} causal={causal}"
        out, lse = fa._fa_forward(q, k, v, scale, causal)
        want_out, want_lse = fa._fa_forward_reference(q, k, v, scale, causal)
        held("flash_fwd", out, want_out, f"flash_fwd out {what}")
        # lse is f32 on both sides, whatever the inputs' dtype
        held("flash_fwd", lse, want_lse, f"flash_fwd lse {what}",
             TOL[torch.float32])
        for g_lse in (torch.zeros_like(lse),
                      torch.randn(bh, t, 1, generator=gen).cuda()):
            dq, dk, dv = fa._fa_backward(q, k, v, out, lse, g, g_lse, scale,
                                         causal)
            rq, rk, rv = fa._fa_backward_reference(q, k, v, out, lse, g,
                                                   g_lse, scale, causal)
            nz = f"{what} g_lse={'0' if not g_lse.any() else 'randn'}"
            held("flash_bwd_dq", dq, rq, f"flash_bwd_dq {nz}")
            held("flash_bwd_dkv", dk, rk, f"flash_bwd_dkv dk {nz}")
            held("flash_bwd_dkv", dv, rv, f"flash_bwd_dkv dv {nz}")
        return errs

    grid = [(dt, (2, 5)[i % 2], t, d, causal)
            for dt in (torch.float32, torch.bfloat16)
            for i, (t, d, causal) in enumerate(itertools.product(
                (128, 512, 100), (32, 64, 128), (True, False)))]
    for args in grid:
        case(*args)
    main = case(torch.bfloat16, *main_shape, True)
    ring = {name: case(torch.bfloat16, *ring_shape, causal)
            for name, causal in (("causal", True), ("past", False))}
    torch.cuda.synchronize()
    return worst, len(grid) + 3, main, ring


def wrapper_vs_plain(fa, plain_attention, gen):
    """flash_attention at T=100 (the wrapper pads to 128 on the causal path)
    against plain_attention, output and gradients, f32 on the card."""
    atol, rtol = WRAPPER_TOL
    qkv = [torch.randn(2, 100, 4, 64, generator=gen).cuda().requires_grad_()
           for _ in range(3)]
    errs = {}
    for name, fn in (("flash", fa.flash_attention), ("plain", plain_attention)):
        out = fn(*qkv)
        grads = torch.autograd.grad((out ** 2).sum(), qkv)
        errs[name] = [out.detach()] + list(grads)
    worst = 0.0
    for got, want in zip(errs["flash"], errs["plain"]):
        err = (got - want).abs()
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"flash_attention T=100 against plain_attention: max abs err "
              f"{err.max().item()} beyond atol {atol} rtol {rtol}")
        worst = max(worst, err.max().item())
    return worst


def flash_d128(ext, fa, gen, graph, shape=(32, 512, 128)):
    """The three bf16 flash kernels once at head dim 128 ([32, 512, 128],
    causal: the training shape's work with half the heads, twice as wide),
    where the kernels hold the most registers and shared memory; each by
    CUDA-graph replay beside its bound and SDPA's forward and backward."""
    bh, t, d = shape
    q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(torch.bfloat16)
                  .cuda() for _ in range(4))
    scale = d ** -0.5
    out, lse = ext.flash_fwd(q, k, v, scale, True)
    delta, g_lse = fa._delta(g, out), torch.zeros_like(lse)
    q4, k4, v4, g4 = (x.view(1, bh, t, d) for x in (q, k, v, g))
    q4r, k4r, v4r = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_ms = graph(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    sdpa_bwd_ms = graph(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True),
        (q4r, k4r, v4r), g4)) - sdpa_ms
    ms = {
        "flash_fwd": graph(lambda: ext.flash_fwd(q, k, v, scale, True)),
        "flash_bwd_dq": graph(lambda: ext.flash_bwd_dq(
            q, k, v, g, lse, delta, g_lse, scale, True)),
        "flash_bwd_dkv": graph(lambda: ext.flash_bwd_dkv(
            q, k, v, g, lse, delta, g_lse, scale, True)),
    }
    bounds = flash_bounds(bh, t, d, causal=True)
    return {"shape": [bh, t, d], "dtype": "bfloat16", "causal": True,
            "timing": "device time from CUDA-graph replay",
            "kernels": {name: {"ms": ms[name], "bound_ms": bounds[name][0],
                               "bound_by": bounds[name][1]} for name in ms},
            "sdpa_ms": sdpa_ms, "sdpa_bwd_ms": sdpa_bwd_ms}


def train_run(tfm, cfg, impl, tokens, steps, params=None, eager=False):
    """``steps`` Adam steps from init_params(seed 0) through the port's
    train-step entry points (one CUDA graph replayed a step from the
    second, or with ``eager`` every step eagerly); returns (params,
    opt_state, losses, step)."""
    if params is None:
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    opt, step = tfm.make_train_step(cfg, attn_impl=impl,
                                    learning_rate=TRAIN_LR, eager=eager)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    return params, state, [float(x) for x in losses], step


def graph_vs_eager_losses(graph, eager, label):
    """The graphed step's losses within the phase's TRAIN_LOSS_* limits of
    the eager step's, from the same weights."""
    diffs = [abs(a - b) for a, b in zip(graph, eager)]
    check(len(graph) == len(eager) and diffs[0] <= TRAIN_LOSS0_ATOL
          and max(diffs) <= TRAIN_LOSS_STEP_ATOL
          and diffs[-1] <= TRAIN_LOSS_LAST_ATOL,
          f"{label}: graphed losses {graph} against eager {eager}")
    return {"loss0_diff": diffs[0], "max_loss_diff": max(diffs),
            "last_loss_diff": diffs[-1]}


def train_graph_pair(tfm, cfg, tokens, label, graph=None):
    """The flash step as one CUDA graph against the eager step from the
    same weights over TRAIN_STEPS (phases 8 and 16): one replay launches
    each flash kernel once a layer, and the graphed losses stay within the
    TRAIN_LOSS_* limits of the eager ones.  ``graph`` is (losses, step) of
    a graphed run already made.  Returns the record."""
    if graph is None:
        _, _, losses, step = train_run(tfm, cfg, "flash", tokens,
                                       TRAIN_STEPS)
    else:
        losses, step = graph
    per_replay = {name: n for (name, _), n in step.program.launches.items()}
    check(per_replay == {n: cfg.n_layers for n in FLASH_KERNELS},
          f"{label}: one replay launches {per_replay}, expected "
          f"{cfg.n_layers} of each flash kernel")
    _, _, eager, _ = train_run(tfm, cfg, "flash", tokens, TRAIN_STEPS,
                               eager=True)
    return {"graph_losses": losses, "eager_losses": eager,
            **graph_vs_eager_losses(losses, eager, label),
            "launches_per_replay": per_replay,
            "capture_s": step.program.capture_s}


def f32_graph_pair(tfm, cfg32, tokens):
    """Phase 8's float32 leg: the graphed flash step's losses within
    GRAPH_F32_LOSS_ATOL of the eager step's over TRAIN_STEPS."""
    _, _, graph, _ = train_run(tfm, cfg32, "flash", tokens, TRAIN_STEPS)
    _, _, eager, _ = train_run(tfm, cfg32, "flash", tokens, TRAIN_STEPS,
                               eager=True)
    diff = max(abs(a - b) for a, b in zip(graph, eager))
    check(diff <= GRAPH_F32_LOSS_ATOL,
          f"float32 graphed flash losses {graph} against eager {eager}")
    return {"graph": graph, "eager": eager, "max_diff": diff,
            "atol": GRAPH_F32_LOSS_ATOL}


def train_step_turns(tfm, tcfg, tokens, card):
    """Phase 9's step times: eager and graphed steps in turns, plain and
    flash, each from fresh weights; then the flash step profiled both
    ways."""
    for eager in (True, False, False, True):
        for impl in (("plain", "flash") if eager else ("flash", "plain")):
            phase(9, "train_step", **step_time(tfm, tcfg, impl, tokens,
                                               eager=eager), **card)
    for eager in (True, False):
        phase(9, "train_profile", attn_impl="flash",
              **profile_steps(tfm, tcfg, tokens, eager=eager), **card)


def moe_train_graph(tfm, cfg, tokens, card):
    """Phase 16's MoE flash step as one CUDA graph against the eager step,
    from the same weights and tokens; then each timed."""
    pair = train_graph_pair(tfm, cfg, tokens, "MoE flash training")
    times = [step_time(tfm, cfg, "flash", tokens, eager=eager)
             for eager in (True, False)]
    phase(16, "moe_train_graph", config=MOE, steps=TRAIN_STEPS, **pair,
          step_times=times, **card)


def checkpoint_round_trip(tfm, CheckpointManager, cfg, tokens):
    """Two flash steps through the step's program (eager, then captured),
    a checkpoint, two more steps (replays).  The checkpoint is then resumed
    two ways, each held bit for bit against the uninterrupted steps: copied
    into the live params and optimizer state (in place: the graph keeps its
    buffers) and the third step replayed; and restored into fresh params
    and a fresh ``opt.init`` state that a new step function steps twice
    (its program's eager first call, then its capture).  Returns the third
    step's loss."""
    opt, step = tfm.make_train_step(cfg, attn_impl="flash",
                                    learning_rate=TRAIN_LR)
    fresh = lambda: tfm.init_params(  # noqa: E731
        torch.Generator().manual_seed(0), cfg, "cuda")
    params = fresh()
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state, tokens)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        with CheckpointManager(d) as mgr:
            mgr.save(2, params=params, opt_state=state.state_dict())
            template = fresh()
            restored = mgr.restore({
                "params": template,
                "opt_state": opt.init(template).state_dict()})
            latest = mgr.latest_step()
    snap = lambda p: [w.detach().clone() for w in tfm._leaves(p)]  # noqa
    uninterrupted = []
    for _ in range(2):
        params, state, loss = step(params, state, tokens)
        uninterrupted.append((float(loss), snap(params)))

    def same(p, loss, k):
        want_loss, want = uninterrupted[k]
        return float(loss) == want_loss and all(
            torch.equal(a, b) for a, b in zip(tfm._leaves(p), want))

    with torch.no_grad():
        for live, saved in zip(tfm._leaves(params),
                               tfm._leaves(restored["params"])):
            live.copy_(saved)
    state.load_state_dict(restored["opt_state"])
    params, state, loss = step(params, state, tokens)
    in_place = same(params, loss, 0)
    check(step.program.launches and latest == 2 and in_place,
          f"the step resumed in place differs from the uninterrupted one: "
          f"loss {float(loss)} against {uninterrupted[0][0]}, replayed "
          f"{bool(step.program.launches)}, latest step {latest}")
    opt2, step2 = tfm.make_train_step(cfg, attn_impl="flash",
                                      learning_rate=TRAIN_LR)
    params2 = restored["params"]
    state2 = opt2.init(params2)
    state2.load_state_dict(restored["opt_state"])
    fresh_same = []
    for k in range(2):
        params2, state2, loss2 = step2(params2, state2, tokens)
        fresh_same.append(same(params2, loss2, k))
    check(step2.program.launches and all(fresh_same),
          f"the steps resumed into fresh objects differ from the "
          f"uninterrupted ones: equal {fresh_same} (eager first call, "
          f"then the capture), captured {bool(step2.program.launches)}")
    return uninterrupted[0][0]


def graph_pool_bytes(pool):
    """(reserved, allocated) bytes of the CUDA-graph memory pool ``pool``
    from the allocator's snapshot; None where the snapshot does not name a
    segment's pool."""
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    mine = [seg for seg in segments
            if tuple(seg["segment_pool_id"]) == tuple(pool)]
    return (sum(seg["total_size"] for seg in mine),
            sum(seg["allocated_size"] for seg in mine))


def held_memory(before, program):
    """(held_mb, graph_pool_mb, peak bytes) of a train step: the peak
    allocated since the last reset above ``before``, plus for a graph
    (``program``, a TrainProgram, or None) what its private pool reserves
    beyond what is allocated in it (the activations freed inside the
    capture stay reserved there for every replay; ``graph_pool_mb`` is the
    pool's whole reservation)."""
    peak = torch.cuda.max_memory_allocated()
    held, pool_mb = (peak - before) / 2**20, None
    if program is not None and program.pool is not None:
        pool = graph_pool_bytes(program.pool)
        if pool is None:
            held = pool_mb = "not measured"
        else:
            held += (pool[0] - pool[1]) / 2**20
            pool_mb = pool[0] / 2**20
    return held, pool_mb, peak


def step_time(tfm, cfg, impl, tokens, steps=10, warmup=2, eager=False):
    """Train-step wall time (host clock around synchronized steps) from
    fresh weights, after ``warmup`` steps of the same step function (for
    the graph: the eager first step and the capture), and the device
    memory the step holds at its most: ``held_mb``, the peak allocated
    during the timed steps above what was allocated before the weights
    were made, plus for the graph what its private pool reserves beyond
    what is allocated in it (the activations freed inside the capture stay
    reserved there for every replay; ``graph_pool_mb`` is the pool's
    whole reservation)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params, state, _, step = train_run(tfm, cfg, impl, tokens, warmup,
                                       eager=eager)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    program = step.program
    held, pool_mb, peak = held_memory(before, program)
    return {"attn_impl": impl, "graph": not eager, "ms_per_step": ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "peak_mb": peak / 2**20, "held_mb": held,
            "graph_pool_mb": pool_mb,
            "capture_s": program.capture_s if program else None,
            "steps": steps, "last_loss": float(loss)}


def profile_steps(tfm, cfg, tokens, steps=3, eager=False):
    """torch.profiler over ``steps`` warm flash steps (graph replays, or
    eager steps): the device-busy share of the wall time and the top
    kernels by device time.  The profiler starts after the capture and
    no other thread launches meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    params, state, _, step = train_run(tfm, cfg, "flash", tokens, 2,
                                       eager=eager)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, state, _ = step(params, state, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"steps": steps, "graph": not eager, **busy_share(prof, wall_us)}


# the serial LM legs of phase 6: greedy tokens a leg streams, and the
# orders the eager loop and the CUDA graphs are timed in
SERIAL_TOKENS = 128
SERIAL_TURNS = ("eager", "graph", "graph", "eager")


def serial_rate(tfm, params, cfg, prompt, depth, eager):
    """One timed serial stream of SERIAL_TOKENS greedy tokens after an
    8-token warm-up of the same path (for the graphs: the decode graph and
    this prompt length's prefill graph are captured by then)."""
    list(tfm.generate(params, cfg, prompt, 8, eager=eager))
    t0 = time.monotonic()
    stamps, tokens = [], []
    for tok in tfm.generate(params, cfg, prompt, SERIAL_TOKENS,
                            readback_depth=depth, eager=eager):
        stamps.append(time.monotonic())
        tokens.append(tok)
    return {"readback_depth": depth, "ttft_ms": (stamps[0] - t0) * 1e3,
            "tokens_per_s": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
            "tokens": len(stamps)}, tokens


def serial_legs(tfm, prompt, card, models):
    """Phase 6's serial legs: each model's ``generate`` through its CUDA
    graphs (the default path) and through the eager loop, at readback
    depth 8 (the served default) and 0 (strict serial), in turns
    (SERIAL_TURNS).  Each graph stream must equal its eager stream token
    for token.  Records what a new prompt length's prefill capture costs
    and one decode replay's launches by kernel and route.  Returns the
    launches and routes counted over the graph legs."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.models import programs

    launches = {name: 0 for name in ops.LAUNCHES}
    routes = {name: {r: 0 for r in rs} for name, rs in ops.ROUTES.items()}
    for model, params, cfg in models:
        for depth in (8, 0):
            streams = {}
            for mode in SERIAL_TURNS:
                eager = mode == "eager"
                before = (dict(ops.LAUNCHES),
                          {k: dict(v) for k, v in ops.ROUTES.items()})
                row, tokens = serial_rate(tfm, params, cfg, prompt, depth,
                                          eager)
                torch.cuda.synchronize()
                if not eager:
                    for name, n in ops.LAUNCHES.items():
                        launches[name] += n - before[0][name]
                    for name, rs in ops.ROUTES.items():
                        for r, n in rs.items():
                            routes[name][r] += n - before[1][name][r]
                streams.setdefault(mode, tokens)
                check(tokens == streams[mode],
                      f"{model} {mode} depth {depth}: two runs streamed "
                      f"{streams[mode]} and {tokens}")
                phase(6, "serial_decode", model=model, dtype=cfg.dtype,
                      graphs=not eager, **row, **card)
            check(streams["graph"] == streams["eager"],
                  f"{model} depth {depth}: the CUDA graphs streamed "
                  f"{streams['graph']}, the eager loop {streams['eager']}")
        # the default path's pool: what its capture cost and a decode
        # replay launches; then a prompt length it has not seen
        pool = programs.serial_pool(params, cfg)
        sets = pool.idle_sets()
        check(len(sets) == 1 and "decode" in sets[0].captures
              and len(prompt) in sets[0].captures,
              f"{model}: generate left {len(sets)} program sets, captures "
              f"{[p.captures for p in sets]}")
        with pool.acquire(params, 1) as progs:
            short = torch.as_tensor(prompt[:-1], dtype=torch.int32,
                                    device="cuda")[None]
            new_length = short.shape[1]
            check(new_length not in progs.captures,
                  f"{model}: length {new_length} captured already")
            progs.prefill(params, short)
            torch.cuda.synchronize()
            captures = dict(progs.captures)
            per_replay = progs.decode_launches
        phase(6, "serial_graphs", model=model, dtype=cfg.dtype,
              tokens=SERIAL_TOKENS, graph_equal_to_eager=True,
              decode_capture_s=captures["decode"],
              prefill_capture_s={"first_length": captures[len(prompt)],
                                 "new_length": captures[new_length]},
              prompt_tokens=len(prompt), new_prompt_tokens=new_length,
              decode_replay_launches={f"{k}/{r}" if r else k: n
                                      for (k, r), n in per_replay.items()},
              **card)
    return {"launches": launches, "routes": routes}


# phase 6's served mix: serial lm_streaming requests beside live
# lm_streaming_batched streams in one process.  Prompt lengths in bytes
# are drawn log-normal (median SERIAL_MIX_MEDIAN, clipped to
# [2, SERIAL_MIX_MAX]) from a seed: byte-level prompts rarely repeat an
# exact length, and each new length captures a prefill graph.
SERIAL_MIX_REQUESTS = 48
SERIAL_MIX_TOKENS = 16
SERIAL_MIX_MEDIAN, SERIAL_MIX_SIGMA, SERIAL_MIX_MAX = 64, 0.75, 384
SERIAL_MIX_STREAMS = 4     # batched streams kept in flight
SERIAL_MIX_ALONE_S = 2.0   # the batched engine alone, seconds


def serial_mix_prompts(language, seed, lengths=None):
    """SERIAL_MIX_REQUESTS printable-byte prompts (BOS included) at the
    mix's lengths, or cycling through ``lengths``."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        drawn = rng.lognormal(np.log(SERIAL_MIX_MEDIAN), SERIAL_MIX_SIGMA,
                              SERIAL_MIX_REQUESTS)
        lengths = np.clip(np.rint(drawn), 2, SERIAL_MIX_MAX).astype(int)
    else:
        lengths = [lengths[i % len(lengths)]
                   for i in range(SERIAL_MIX_REQUESTS)]
    return [language.encode_text(bytes(rng.integers(32, 127, n - 1)
                                       .tolist())) for n in lengths]


def serial_beside_batched(tfm, language, LmEngine, params, cfg, prompt,
                          card):
    """The served serial path's prefill captures beside live batched
    traffic, in one process: SERIAL_MIX_STREAMS batched greedy streams kept
    in flight on an LmEngine over ``params``, first alone, then beside
    serial ``_LmRunner.stream`` requests (one at a time, SERIAL_MIX_TOKENS
    each) at lengths its program set already holds ("warm", no capture),
    then at the mix's lengths ("mix", a capture at each length the set
    does not hold).  Records the batched tokens/s and the gaps between a
    batched stream's tokens in each window, the serial TTFTs split by
    whether the request captured, and the share of requests that
    captured."""
    from client_tpu_torch.serve.models import programs

    runner = language._LmRunner(cfg=cfg, params=params, device="cuda")
    pool = programs.serial_pool(params, cfg)
    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)
    stamps, errors, stop = [], [], threading.Event()
    lock = threading.Lock()

    def batched(p):
        try:
            while not stop.is_set():
                q, _ = eng.submit(p, ENGINE_TOKENS)
                last = None
                while (tok := q.get(timeout=300)) is not LmEngine.CLOSE:
                    now = time.monotonic()
                    with lock:
                        stamps.append((now, now - last if last else None))
                    last = now
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def window(t0, t1):
        with lock:
            inside = [(t, gap) for t, gap in stamps if t0 <= t < t1]
        gaps = sorted(g * 1e3 for t, g in inside if g is not None)
        return {"seconds": t1 - t0, "batched_tokens": len(inside),
                "batched_tokens_per_s": len(inside) / (t1 - t0),
                "gap_ms_p50": float(np.percentile(gaps, 50)),
                "gap_ms_p99": float(np.percentile(gaps, 99)),
                "gap_ms_max": gaps[-1]}

    def serial(prompts):
        rows = []
        t0 = time.monotonic()
        for p in prompts:
            with pool.acquire(params, 1) as progs:
                held = len(p) in progs.prefill_lengths
            start = time.monotonic()
            toks = runner.stream(p, SERIAL_MIX_TOKENS)
            next(toks)
            ttft = (time.monotonic() - start) * 1e3
            for _ in toks:
                pass
            rows.append((len(p), held, ttft))
        t1 = time.monotonic()
        captured = [r[2] for r in rows if not r[1]]
        warm = [r[2] for r in rows if r[1]]
        stat = lambda xs, q: (float(np.percentile(xs, q))  # noqa: E731
                              if xs else None)
        return {**window(t0, t1), "requests": len(rows),
                "distinct_lengths": len({r[0] for r in rows}),
                "captured_share": len(captured) / len(rows),
                "ttft_ms_p50_captured": stat(captured, 50),
                "ttft_ms_max_captured": max(captured) if captured else None,
                "ttft_ms_p50_held": stat(warm, 50),
                "ttft_ms_p99_held": stat(warm, 99)}

    # the set holds the lengths of the last requests it served: here the
    # first of another draw from the mix
    held = [len(p) for p in serial_mix_prompts(language, 24)]
    warm = serial_mix_prompts(language, 25,
                              held[:programs.PREFILL_GRAPHS])
    mix = serial_mix_prompts(language, 23)
    threads = [threading.Thread(target=batched, args=(p,), daemon=True)
               for p in distinct_prompts(prompt, SERIAL_MIX_STREAMS)]
    try:
        q, _ = eng.submit(prompt, 8)  # the engine captures its programs
        while q.get(timeout=300) is not LmEngine.CLOSE:
            pass
        for p in warm[:programs.PREFILL_GRAPHS]:
            list(runner.stream(p, 2))  # the warm lengths' prefills
        for th in threads:
            th.start()
        time.sleep(0.5)
        t0 = time.monotonic()
        time.sleep(SERIAL_MIX_ALONE_S)
        rows = {"alone": window(t0, time.monotonic()),
                "warm": serial(warm), "mix": serial(mix)}
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
        eng.close()
    check(not errors and rows["warm"]["captured_share"] == 0.0,
          f"serial beside batched: errors {errors}, warm window captured "
          f"{rows['warm']['captured_share']}")
    phase(6, "serial_beside_batched", model="lm_streaming",
          batched_model="lm_streaming_batched", dtype=cfg.dtype,
          batched_streams=SERIAL_MIX_STREAMS,
          serial_tokens=SERIAL_MIX_TOKENS,
          length_mix={"median": SERIAL_MIX_MEDIAN,
                      "sigma": SERIAL_MIX_SIGMA, "max": SERIAL_MIX_MAX,
                      "seed": 23},
          prefill_graphs_a_set=programs.PREFILL_GRAPHS, **rows, **card)
    return rows


# -- the continuous-batching engine (phases 5, 10-12) -----------------------

# the engine's JAX defaults: 8 slots, lane counts {2, 4, 8}, 16-token
# blocks, 64-token prefill chunks (buckets {16, 32, 64}), table width 32
ENGINE_KW = dict(max_slots=8, block_size=16, prefill_chunk=64)
PAGED_BS, PAGED_WIDTH = 16, 32
PAGED_HEADS = (8, 4)  # DEFAULT_LM_CONFIG's query and KV heads
ENGINE_TOKENS = 128   # tokens a stream in the engine timings


def paged_case(batch, t, hd, dtype, contexts, seed, heads=PAGED_HEADS):
    """A paged-attention input on the card at the engine's layout: lane b's
    T queries end at key contexts[b] - 1, its blocks are shuffled
    physical blocks scattered over the pool, and its table's tail is the
    trash block 0.  Returns (clean args, the same args with every pool row
    the mask excludes set to NaN, pos as numpy)."""
    rng = np.random.default_rng(seed)
    n_heads, n_kv = heads
    bs = PAGED_BS
    ctx = np.maximum(np.asarray(contexts), t)
    pos = (ctx[:, None] - t + np.arange(t)[None, :]).astype(np.int32)
    own = pos.max(axis=1) // bs + 1
    n_blocks = int(own.sum()) + 3  # three blocks no lane owns
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    tables = np.zeros((batch, PAGED_WIDTH), np.int32)
    live = np.zeros((n_blocks + 1, bs), bool)
    start = 0
    for b in range(batch):
        tables[b, :own[b]] = perm[start:start + own[b]]
        start += own[b]
        for j in range(int(pos[b].max()) + 1):
            live[tables[b, j // bs], j % bs] = True
    shape = (n_blocks + 1, bs, n_kv, hd)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (batch, t, n_heads, hd)).astype(np.float32)).to(dtype)
    kn, vn = k.clone(), v.clone()
    dead = torch.from_numpy(~live)
    kn[dead] = float("nan")
    vn[dead] = float("nan")
    tab, ps = torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda()
    return ((q.cuda(), k.cuda(), v.cuda(), tab, ps),
            (q.cuda(), kn.cuda(), vn.cuda(), tab, ps), pos)


def paged_grid():
    """(kind, batch, t, contexts) of phase 10: the engine's decode, verify
    and prefill shapes, contexts from 1 to 511 (most end mid-block)."""
    grid = [("decode", b, 1, np.linspace(1, 511, b).astype(int))
            for b in (2, 4, 8)]
    grid += [("verify", 8, t, np.linspace(t, 511, 8).astype(int))
             for t in (2, 4, 5)]
    grid += [("prefill", 1, t, [ctx]) for t in (16, 32, 64)
             for ctx in (t, 511)]
    return grid


def paged_route(t, dtype):
    """The split kernel paged_attention.cu picks: the tensor cores for bf16
    prefill chunks (T >= 16), the CUDA cores for the rest."""
    return "mma" if dtype == torch.bfloat16 and t >= 16 else "split"


def paged_vs_plain(pa, ops):
    """Phase 10: the kernel on NaN-poisoned pools against the plain version
    on clean ones, over paged_grid() x hd x dtype.  Returns the worst error
    by dtype, the same by the route each case reported (checked against
    paged_route), and the count of cases."""
    worst, worst_route, cases = {}, {}, 0
    for kind, batch, t, contexts in paged_grid():
        for hd in (16, 32, 64, 128):
            for dt in (torch.float32, torch.bfloat16):
                clean, poisoned, _ = paged_case(batch, t, hd, dt, contexts,
                                                seed=cases)
                route = paged_route(t, dt)
                before = ops.ROUTES["paged_attention"][route]
                got = pa._launch(*poisoned, PAGED_BS).float()
                check(ops.ROUTES["paged_attention"][route] == before + 1,
                      f"paged_attention {kind} T={t} {dtype_name(dt)} did "
                      f"not report the {route} route: "
                      f"{ops.ROUTES['paged_attention']}")
                want = pa.paged_attention_reference(*clean,
                                                    PAGED_BS).float()
                atol, rtol = TOL[dt]
                err = (got - want).abs()
                what = (f"paged_attention {kind} B={batch} T={t} hd={hd} "
                        f"{dtype_name(dt)}")
                check(bool(torch.isfinite(got).all()),
                      f"{what}: non-finite output (read a masked row?)")
                check(bool((err <= atol + rtol * want.abs()).all()),
                      f"{what}: max abs err {err.max().item()} beyond atol "
                      f"{atol} rtol {rtol}")
                key = dtype_name(dt)
                worst[key] = max(worst.get(key, 0.0), err.max().item())
                by = worst_route.setdefault(route, {})
                by[key] = max(by.get(key, 0.0), err.max().item())
                cases += 1
    torch.cuda.synchronize()
    return worst, worst_route, cases


def paged_no_key(pa):
    """Phase 10, second part: queries at pos = -1 attend no key, so the
    reference's softmax is uniform over the whole gathered table; the
    kernel must give the same (the only case that reads past the mask
    bound, so the pools are clean).  Decode, verify and prefill, every hd
    and dtype, beside ordinary rows."""
    worst, cases = {}, 0
    for kind, batch, t in (("decode", 8, 1), ("verify", 8, 5),
                           ("prefill", 1, 64)):
        for hd in (16, 32, 64, 128):
            for dt in (torch.float32, torch.bfloat16):
                (q, k, v, tables, pos), _, _ = paged_case(
                    batch, t, hd, dt, np.linspace(t, 300, batch).astype(int),
                    seed=1000 + cases)
                pos = pos.clone()
                pos[0, :max(1, t // 2)] = -1
                got = pa._launch(q, k, v, tables, pos, PAGED_BS).float()
                want = pa.paged_attention_reference(q, k, v, tables, pos,
                                                    PAGED_BS).float()
                atol, rtol = TOL[dt]
                err = (got - want).abs()
                check(bool(torch.isfinite(got).all())
                      and bool((err <= atol + rtol * want.abs()).all()),
                      f"paged_attention pos=-1 {kind} hd={hd} "
                      f"{dtype_name(dt)}: max abs err {err.max().item()} "
                      f"beyond atol {atol} rtol {rtol}")
                key = dtype_name(dt)
                worst[key] = max(worst.get(key, 0.0), err.max().item())
                cases += 1
    torch.cuda.synchronize()
    return worst, cases


def paged_bound(pos, heads, hd, elt):
    """(bound_ms, bound_by) of one paged-attention call: each input read
    once (the K/V rows up to each lane's last pos, q, tables, pos) and out
    written once, over HBM; q.k and p.v for every attended (query, key)
    pair over the dense peak of the dtype (bf16 tensor cores, or f32)."""
    n_heads, n_kv = heads
    batch, t = pos.shape
    rows = int((pos.max(axis=1) + 1).sum())
    nbytes = (2 * rows * n_kv * hd * elt + 2 * batch * t * n_heads * hd * elt
              + batch * PAGED_WIDTH * 4 + batch * t * 4)
    flops = 4 * n_heads * hd * int((pos.astype(np.int64) + 1).sum())
    peak = BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def paged_timings(pa, ext, graph):
    """Phase 12: the kernel by CUDA-graph replay at the engine's decode
    (B=8, contexts 64, 256, 511) and prefill (B=1, T=64 ending at key 256)
    shapes, bf16, hd 32, beside its bound, its plain version and SDPA on
    K/V gathered through the table (gather included)."""
    rows = []
    for kind, batch, t, ctx in (("decode", 8, 1, 64), ("decode", 8, 1, 256),
                                ("decode", 8, 1, 511), ("verify", 8, 2, 256),
                                ("verify", 8, 4, 256), ("verify", 8, 5, 256),
                                ("prefill", 1, 64, 256)):
        (q, k, v, tables, pos), _, pos_np = paged_case(
            batch, t, 32, torch.bfloat16, [ctx] * batch, seed=ctx + t)
        n_kv, hd = k.shape[2], k.shape[3]
        s_len = PAGED_WIDTH * PAGED_BS
        idx = tables.long()
        mask = (torch.arange(s_len, device="cuda")[None, None, :]
                <= pos[:, :, None])[:, None]  # [B,1,T,S]
        qh = q.transpose(1, 2)

        def library():
            kk = k[idx].reshape(batch, s_len, n_kv, hd).transpose(1, 2)
            vv = v[idx].reshape(batch, s_len, n_kv, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)

        want = pa.paged_attention_reference(q, k, v, tables, pos,
                                            PAGED_BS).float()
        got_lib = library().transpose(1, 2).float()
        check(bool(((got_lib - want).abs() <= 2e-2 + 1e-2 * want.abs()).all()),
              "SDPA on the gathered K/V does not compute the same function")
        bound, bound_by = paged_bound(pos_np, PAGED_HEADS, hd, 2)
        rows.append({
            "shape": kind, "B": batch, "T": t, "context": ctx, "hd": hd,
            "heads": list(PAGED_HEADS), "dtype": "bfloat16",
            "route": paged_route(t, torch.bfloat16),
            "ms": graph(lambda: ext.paged_attention(q, k, v, tables, pos,
                                                    PAGED_BS)),
            "plain_ms": graph(lambda: pa.paged_attention_reference(
                q, k, v, tables, pos, PAGED_BS)),
            "library_ms": graph(library),
            "library": "F.scaled_dot_product_attention(attn_mask, "
                       "enable_gqa=True) on K/V gathered through the table",
            "bound_ms": bound, "bound_by": bound_by,
            "timing": "device time from CUDA-graph replay"})
    return rows


def engine_prompts():
    """Phase 11's 16 concurrent greedy requests: (prompts, token counts).
    Fourteen prompts of 1 to 200 tokens, two sharing a 48-token prefix;
    16 to 48 tokens each.  tools/jax_engine_vs_generate.py gives the same
    requests to the JAX package's engine."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 48).tolist()
    lens = [1, 3, 9, 16, 17, 31, 40, 63, 64, 65, 100, 128, 150, 200]
    prompts = [rng.integers(0, 256, n).tolist() for n in lens]
    prompts += [shared + rng.integers(0, 256, 5).tolist(),
                shared + rng.integers(0, 256, 9).tolist()]
    lengths = [16 + (7 * i) % 33 for i in range(len(prompts))]
    return prompts, lengths


def collect(q, close, timeout=300):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is close:
            return out
        out.append(tok)


def agreement(tfm, params, cfg, prompt, got, want):
    """A batched stream against the serial one: equal, or, where they first
    diverge, the serial model's logits of both tokens (a full forward over
    the common prefix) and their gap.  Fails unless the gap is a near-tie
    (at most NEAR_TIE)."""
    if got == want:
        return {"equal": True, "tokens": len(got)}
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    check(i < min(len(got), len(want)),
          f"stream lengths differ: {len(got)} against {len(want)}")
    seq = torch.as_tensor(list(prompt) + list(want[:i]), dtype=torch.int32,
                          device="cuda")[None]
    with torch.no_grad():
        logits = tfm.forward(params, seq, cfg)[0, -1].float()
    top2 = torch.topk(logits, 2).values
    gap = float(logits[want[i]] - logits[got[i]])
    check(gap <= NEAR_TIE,
          f"stream diverges from serial at position {i} where the serial "
          f"logits differ by {gap} > {NEAR_TIE}: {got} against {want}")
    return {"equal": False, "tokens": len(got), "first_divergence": i,
            "gap": gap, "top2_gap": float(top2[0] - top2[1])}


def engine_run(LmEngine, ops, params, cfg, prompts, lengths, **kw):
    """Submit every (prompt, n) to a fresh engine on the card at once and
    collect the streams; the launch counts are reset just before and read
    just after.  Returns (streams, launches, ticks by kind, stats); fails
    unless the KV audit is clean after close()."""
    eng = LmEngine(params, cfg, device="cuda", **{**ENGINE_KW, **kw})
    ops.reset_launches()
    try:
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        got = [collect(q, LmEngine.CLOSE) for q in qs]
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        ticks = {}
        for rec in eng.tick_trace():
            ticks[rec["kind"]] = ticks.get(rec["kind"], 0) + 1
        stats = {"prefix": eng.prefix_stats(),
                 "preempt": eng.preempt_stats(), "spec": eng.spec_stats(),
                 "graphs": eng.graph_stats()}
    finally:
        eng.close()
    graphs, bounds = stats["graphs"]["graphs"], graph_bounds(eng)
    check(all(graphs[k] <= bounds[k] for k in bounds)
          and graphs["decode"] and graphs["prefill"],
          f"captured graphs {graphs} against their bounds {bounds}")
    stats["graphs"]["bounds"] = bounds
    check(eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {},
          f"KV audit after close: {eng.kv.used_blocks} blocks used, "
          f"refs {eng.kv.ref_counts()}")
    return got, launches, ticks, stats


def graph_bounds(eng):
    """The most graphs an engine may capture: a decode graph per lane
    count, a verify graph per (lane count, verify width), a prefill graph
    per bucket."""
    from client_tpu_torch.serve.lm.policy import verify_widths

    spec = eng._spec
    return {"decode": len(eng.lane_counts),
            "verify": (len(verify_widths(spec.k)) * len(eng.lane_counts)
                       if spec is not None else 0),
            "prefill": len(eng.buckets)}


def int8_per_tick(params):
    """The int8 kernel's launches in one device tick: one for each
    quantized projection whose dims tile (``quant.kernel_takes``; the
    others dequantize and multiply): 6 a layer at DEFAULT_LM_CONFIG
    (w_down's K = 768 and the 258-wide LM head do not tile), 4 a layer and
    the LM head at the MoE config (the expert stacks stay bf16)."""
    from client_tpu_torch.ops.quant import kernel_takes

    weights = [params["lm_head"]] + [
        w for layer in params["layers"]
        for block in ("attn", "mlp") for w in layer.get(block, {}).values()]
    return sum(1 for w in weights
               if isinstance(w, dict) and kernel_takes(*w["q"].shape))


def check_launches(launches, ticks, cfg, params):
    """paged attention n_layers a device tick (decode, verify or prefill
    chunk); int8 ``int8_per_tick(params)`` a tick."""
    device_ticks = sum(n for kind, n in ticks.items() if kind != "draft")
    want = {"paged_attention": cfg.n_layers * device_ticks,
            "int8_matmul": int8_per_tick(params) * device_ticks}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times in {ticks} ticks, "
              f"expected {n}")
    return {"per_tick": {name: n // max(device_ticks, 1)
                         for name, n in want.items()},
            "ticks": ticks, "launches": launches}


def distinct_prompts(prompt, n):
    """n copies of prompt, each with its own second token: no prefix is
    shared, so every stream prefills its own chunk."""
    out = []
    for i in range(n):
        p = np.array(prompt, np.int32)
        p[1] = 32 + i
        out.append(p)
    return out


def engine_rate(LmEngine, params, cfg, prompt, n_streams, hooks=None):
    """Aggregate tokens/s and TTFT of n_streams concurrent greedy streams of
    ENGINE_TOKENS tokens each, after a warm-up run; host clock from the
    first submit to the last token.  ``hooks(eng)``, when given, binds the
    server's observability and QoS hooks to the engine first."""
    return engine_rates(LmEngine, params, cfg, prompt, (n_streams,),
                        hooks)[0]


def engine_rates(LmEngine, params, cfg, prompt, counts, hooks=None):
    """``engine_rate`` at each stream count of ``counts``, in turn, on one
    engine (its graphs captured once)."""
    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)
    if hooks is not None:
        hooks(eng)

    def run(n, tokens):
        stamps = [[] for _ in range(n)]
        t0 = time.monotonic()
        qs = [eng.submit(p, tokens)[0] for p in distinct_prompts(prompt, n)]

        def drain(i):
            while qs[i].get(timeout=300) is not LmEngine.CLOSE:
                stamps[i].append(time.monotonic())

        threads = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        return t0, stamps

    rows = []
    try:
        run(8, 8)  # warm-up: every lane count and the prefill width
        for n_streams in counts:
            t0, stamps = run(n_streams, ENGINE_TOKENS)
            t_end = time.monotonic()
            ticks = [r for r in eng.tick_trace()
                     if r["kind"] == "decode" and t0 <= r["t0"] < t_end]
            total = sum(len(s) for s in stamps)
            check(total == n_streams * ENGINE_TOKENS,
                  f"{total} tokens delivered")
            end = max(s[-1] for s in stamps)
            ttft = [(s[0] - t0) * 1e3 for s in stamps]
            starts = [r["t0"] for r in ticks]
            rows.append({
                "streams": n_streams, "tokens_each": ENGINE_TOKENS,
                "tokens_per_s": total / (end - t0),
                "ttft_ms_mean": float(np.mean(ttft)),
                "ttft_ms_max": max(ttft),
                "decode_ticks": len(ticks),
                # host clock: one scheduler pass from decode tick to
                # decode tick, and the tick's dispatch alone (pack, copy,
                # replay)
                "host_ms_per_tick": float(np.mean(np.diff(starts)) * 1e3),
                "dispatch_ms_per_tick": float(np.mean(
                    [r["t1"] - r["t0"] for r in ticks]) * 1e3)})
    finally:
        eng.close()
    return rows


def busy_share(prof, wall_us, window=None):
    """Device-busy share of the wall time from a torch.profiler trace:
    kernels and copies merged on the device timeline (a user annotation,
    which spans the gaps between its kernels, is left out), and the top
    kernels by device time.  With ``window`` (start, end), in the trace's
    microseconds, only what ran inside it counts."""
    from torch.autograd import DeviceType

    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi),
                    e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > lo and e.time_range.start < hi)
    if not spans:
        return {"device_busy_share": "not measured",
                "top_kernels": "not measured"}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, _ in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    by_name = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    graph_launches = sum(1 for e in prof.events()
                         if e.device_type != DeviceType.CUDA
                         and "cudaGraphLaunch" in e.name
                         and lo <= e.time_range.start < hi)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "kernel_launches": len(spans), "graph_launches": graph_launches,
            "top_kernels": [{"name": n[:120], "ms": us / 1e3,
                             "share_of_busy": us / busy} for n, us in top]}


def engine_profile(LmEngine, params, cfg, prompt, window_s=0.5):
    """torch.profiler over a decode-heavy window of the engine: 8 greedy
    streams, the window (a ``record_function`` span) opened once every
    stream has its first token (all prefill done).  The profiler starts
    before the streams and stops after they are cancelled: CUPTI is
    switched on and off while the engine launches nothing (switched on
    under another thread's graph launches, it traced no kernel or
    hung)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)
    try:
        collect(eng.submit(prompt, 8)[0], LmEngine.CLOSE)  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            subs = [eng.submit(p, 400) for p in distinct_prompts(prompt, 8)]
            for q, _ in subs:
                q.get(timeout=300)
            with record_function("decode_window"):
                t0 = time.monotonic()
                time.sleep(window_s)
                t1 = time.monotonic()
            for q, handle in subs:
                eng.cancel(handle)
                collect(q, LmEngine.CLOSE)
            time.sleep(0.1)  # the scheduler's last pass ends
            torch.cuda.synchronize()
        ticks = sum(1 for r in eng.tick_trace()
                    if r["kind"] == "decode" and t0 <= r["t0"] < t1)
    finally:
        eng.close()
    win = next(e for e in prof.events() if e.name == "decode_window")
    lo, hi = win.time_range.start, win.time_range.end
    share = busy_share(prof, hi - lo, window=(lo, hi))
    if "kernel_launches" in share and ticks:
        share["kernels_per_decode_tick"] = share["kernel_launches"] / ticks
    return {"window_s": window_s, "streams": 8, "decode_ticks": ticks,
            **share}


def decode_replay_ms(LmEngine, params, cfg, context=128, replays=200):
    """Device time of one decode tick at 8 lanes, context ``context``:
    the captured decode graph of an idle engine replayed back to back,
    timed by CUDA events (every lane's table on the trash block, so it
    writes no live row)."""
    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)
    with eng._cv:
        eng._init_device_locked()
    eng._build_programs()
    try:
        prog = eng._decode_programs[8]
        width = eng._table_width
        prog.feed({"tables": np.zeros((8, width), np.int32),
                   "lens": np.full((8,), context - 1, np.int32),
                   "temps": np.zeros((8,), np.float32),
                   "topks": np.zeros((8,), np.int32)})
        for _ in range(3):
            prog.run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            prog.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / replays
    finally:
        eng.close()


def program_values(kind, shape, rng, context, width, vocab):
    """Host inputs of one engine program at ``context``: every lane on
    blocks of its own (decode, verify; greedy and sampled lanes, top-k on
    and off), or a prefill chunk ending 3 tokens into its bucket
    padding."""
    bs = ENGINE_KW["block_size"]
    perm = rng.permutation(np.arange(1, 8 * width + 1))
    own = min(-(-(context + 8) // bs), width)
    if kind == "prefill":
        table = np.zeros((width,), np.int32)
        table[:own] = perm[:own]
        return {"chunk": rng.integers(0, vocab, (1, shape)), "table": table,
                "start": context - shape + 3, "prompt_len": context,
                "key": (123, 2), "temperature": 0.8, "top_k": 10}
    n = shape if kind == "decode" else shape[0]
    tables = np.zeros((n, width), np.int32)
    for b in range(n):
        tables[b, :own] = perm[b * width:b * width + own]
    values = {"tables": tables,
              "lens": rng.integers(context - 8, context, n),
              "temps": np.where(np.arange(n) % 2, 0.7, 0.0),
              "topks": np.arange(n) % 3 * 5}
    if kind == "verify":
        values["props"] = rng.integers(0, vocab, (n, shape[1] - 1))
        values["counts"] = rng.integers(0, shape[1], n)
    return values


def replay_vs_eager(ops, eng, prog, values, gen):
    """One program's eager function on clones of its state against its
    graph's replay on the live state, same feeds: fails unless every
    output, lane buffer and pool row outside the trash block is bit-equal
    and the replay counted the eager run's launches and routes.  Returns
    the replay's launches."""
    for pool in eng.kv.pools["k"] + eng.kv.pools["v"]:
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    eng._tokens.copy_(torch.randint(0, eng.cfg.vocab_size,
                                    eng._tokens.shape, generator=gen,
                                    device="cuda"))
    eng._keys.copy_(torch.randint(0, 2 ** 31, eng._keys.shape,
                                  generator=gen, device="cuda"))
    prog.feed(values)
    clone = {name: ({k: [p.clone() for p in v] for k, v in buf.items()}
                    if name == "pools" else buf.clone())
             for name, buf in prog.state.items()}

    def counted(fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        return (dict(ops.LAUNCHES),
                {k: dict(v) for k, v in ops.ROUTES.items()})

    eager = counted(lambda: prog.body(prog.feeds, clone))
    replay = counted(prog.run)
    check(replay == eager, f"replay counted {replay}, eager {eager}")
    for name, buf in prog.state.items():
        # the pools from block 1: several writes of one tick may land in
        # the trash block, in any order, and nothing reads it
        pairs = ([(a[1:], b[1:]) for k in ("k", "v")
                  for a, b in zip(buf[k], clone["pools"][k])]
                 if name == "pools" else [(buf, clone[name])])
        for got, want in pairs:
            check(torch.equal(got, want),
                  f"replayed {name} differs from the eager program's: max "
                  f"abs err {(got.float() - want.float()).abs().max()}")
    return {k: v for k, v in replay[0].items() if v}


def engine_graphs(LmEngine, ops, params, cfg, vocab):
    """Phase 11's graph checks for one set of weights (k = 4, so every
    verify shape is captured too)."""
    eng = LmEngine(params, cfg, device="cuda",
                   speculative={"k": 4, "drafter": "ngram"}, **ENGINE_KW)
    try:
        with eng._cv:
            eng._init_device_locked()
            for pool in eng.kv.pools["k"] + eng.kv.pools["v"]:
                pool[1:] = float("nan")
            eng._tokens.fill_(7)
            eng._keys.fill_(9)
            # the graphs' memory: what capturing the set keeps reserved
            # once every cached block is released
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
        eng._build_programs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved() - reserved
        check(all(bool(torch.isnan(pool[1:]).all())
                  for pool in eng.kv.pools["k"] + eng.kv.pools["v"])
              and bool((eng._tokens == 7).all())
              and bool((eng._keys == 9).all()),
              "warm-up or capture wrote a live pool row or lane buffer")
        stats = dict(eng.graph_stats(), bounds=graph_bounds(eng),
                     graph_memory_bytes=reserved)
        check(stats["graphs"] == stats["bounds"],
              f"graphs captured against their bounds: {stats}")
        rng = np.random.default_rng(8)
        gen = torch.Generator(device="cuda").manual_seed(8)
        width = eng._table_width
        launches = {}
        for kind, progs in (("decode", eng._decode_programs),
                            ("verify", eng._verify_programs),
                            ("prefill", eng._prefill_programs)):
            for shape, prog in progs.items():
                launches[f"{kind} {shape}"] = replay_vs_eager(
                    ops, eng, prog, program_values(
                        kind, shape, rng, 200, width, vocab), gen)
    finally:
        eng.close()
    check(eng.decode_executables() == 0, "close() kept its graphs")
    return {**stats, "live_rows_after_capture": "untouched",
            "replay_vs_eager": "bit-equal", "context": 200,
            "launches_a_replay": launches}


# -- the vision path (phase 13) ---------------------------------------------

VISION_IMAGE = 224
# bf16 forward against the float32 forward of the same weights (cast up;
# the image rounds to bf16 in both, TF32 off): the bf16 activations round
# after every one of ResNet-50's 53 convs, about 2**-9 of each value, and
# the roundings accumulate through the residual sums, so the scores agree
# within 5e-2 of the largest f32 score; top-1 agrees wherever the f32
# top-2 gap is larger than that
VISION_BF16_TOL = 5e-2
# timed buckets, and the served concurrencies with their request counts
VISION_TIMED_BUCKETS = (1, 8, 32, 64)
VISION_CONCURRENCY = ((1, 64), (8, 256), (32, 768))
VISION_BYTES_PER_REQUEST = 3 * VISION_IMAGE * VISION_IMAGE * 4


def same_pad_reference(x, w=None, k=3, stride=2):
    """SAME conv (or, with w None, 3x3 max-pool) written another way: a
    stride-1 op with the symmetric padding ``hi``, then every stride-th
    row and column from ``hi - lo`` (the windows XLA's asymmetric
    padding starts)."""
    from client_tpu_torch.serve.models.vision import _same_pads

    lo, hi = _same_pads(x.shape[2], k, stride)
    out = -(-x.shape[2] // stride)
    if w is None:
        y = F.max_pool2d(x, k, 1, padding=hi)
    else:
        y = F.conv2d(x, w, padding=hi)
    return y[:, :, hi - lo::stride, hi - lo::stride][:, :, :out, :out]


def same_pad_cases(vision, gen):
    """The asymmetric SAME cases of ResNet-50 at 224 on the card, float32:
    the stem 7x7/2 at 224 (2, 3), the 3x3/2 convs at 56, 28 and 14 (0, 1),
    the max-pool 3x3/2 at 112 (0, 1); each against same_pad_reference."""
    cases = []
    for size, cin, k in ((224, 3, 7), (56, 64, 3), (28, 128, 3),
                         (14, 256, 3)):
        x = torch.randn(2, cin, size, size, generator=gen).cuda()
        w = (torch.randn(8, cin, k, k, generator=gen) * 0.1).cuda()
        got = vision._conv(x, w, stride=2)
        err = (got - same_pad_reference(x, w, k)).abs().max().item()
        check(err <= 1e-4, f"SAME conv at {size}, k={k}: {err}")
        cases.append({"op": f"conv {k}x{k}/2", "size": size,
                      "pads": vision._same_pads(size, k, 2),
                      "max_abs_err": err})
    x = torch.randn(2, 64, 112, 112, generator=gen).cuda()
    err = (vision._max_pool(x) - same_pad_reference(x)).abs().max().item()
    check(err == 0.0, f"SAME max-pool at 112: {err}")
    cases.append({"op": "max_pool 3x3/2", "size": 112,
                  "pads": vision._same_pads(112, 3, 2), "max_abs_err": err})
    return cases


def vision_images(n, seed):
    return torch.randn(n, 3, VISION_IMAGE, VISION_IMAGE,
                       generator=torch.Generator().manual_seed(seed))


def graphs_vs_eager(model, batcher):
    """Every bucket's graph replayed on seeded images against the eager
    forward of the same images: bit-equal.  Returns the buckets checked."""
    progs = batcher.programs()
    for b, prog in sorted(progs.items()):
        x = vision_images(b, 100 + b).cuda()
        prog.inputs["INPUT0"].copy_(x)
        prog.run()
        got = prog.outputs["OUTPUT0"].clone()
        want = model.fn({"INPUT0": x}, {}, None)["OUTPUT0"]
        check(torch.equal(got, want),
              f"{model.name} bucket {b}: graph differs from eager by "
              f"{(got - want).abs().max().item()}")
        check(bool(torch.isfinite(got).all()), f"{model.name}: non-finite")
    return sorted(progs)


def bf16_vs_f32(forward, params, n=16):
    """The bf16 forward against the float32 forward of the same weights
    cast up: the largest error relative to the largest f32 score, and
    top-1 equal wherever the f32 top-2 gap exceeds the tolerance."""
    x = vision_images(n, 7).cuda()
    p32 = tree_to(params, torch.float32)
    got, want = forward(params, x), forward(p32, x)
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    top2 = want.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > VISION_BF16_TOL * scale
    agree = (got.argmax(1) == want.argmax(1))[decided]
    check(rel <= VISION_BF16_TOL, f"bf16 against f32: {rel}")
    check(bool(agree.all()), "bf16 top-1 differs where the f32 gap is wide")
    return {"images": n, "max_err_of_largest_score": rel,
            "largest_f32_score": scale, "tolerance": VISION_BF16_TOL,
            "top1_decided": int(decided.sum()), "top1_equal": int(agree.sum())}


def param_bytes(params):
    leaves = params if isinstance(params, list) else [params]
    total = 0
    while leaves:
        item = leaves.pop()
        if isinstance(item, dict):
            leaves.extend(item.values())
        elif isinstance(item, list):
            leaves.extend(item)
        else:
            total += item.numel() * item.element_size()
    return total


def replay_timings(model, batcher, weight_bytes):
    """Device time of one bucket graph replay, back to back, by CUDA
    events, for each timed bucket: images/s, MFU over the bf16 dense peak,
    and the bound (FLOPs over the peak, or weights once + input + output
    over HBM, whichever is larger)."""
    progs = batcher.programs()
    rows = []
    for b in VISION_TIMED_BUCKETS:
        graph = progs[b].graph
        for _ in range(3):
            graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 20
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        flops = model.flops_per_item * b
        nbytes = weight_bytes + b * VISION_BYTES_PER_REQUEST + b * 1000 * 4
        by_flops = flops / BF16_FLOPS_PER_S * 1e3
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "bucket": b, "device_ms": ms, "images_per_s": b / ms * 1e3,
            "mfu": flops / (ms / 1e3) / BF16_FLOPS_PER_S,
            "bound_ms": max(by_flops, by_bytes),
            "bound_by": "operations" if by_flops >= by_bytes else "bytes",
        })
    return rows


# the load generator of phase 13: its own process (as perf_analyzer is),
# so the clients do not share the server's interpreter lock.  argv: one
# JSON object {addr, model, concurrency, requests, batch, images, out}; it
# sends binary requests of `batch` images from `concurrency` threads, one
# keep-alive connection each (request body k holds images k, k+1, ...,
# cycling), and saves each request's body index, latency and output to
# `out` (.npz); stdout: {"wall_s", "errors"}
VISION_CLIENT = r"""
import http.client, json, sys, threading, time
import numpy as np

args = json.loads(sys.argv[1])
host, port = args["addr"].split(":")
images = np.load(args["images"])
batch = args["batch"]
bodies = []
for k in range(len(images) if batch == 1 else 1):
    rows = images[[(k + r) % len(images) for r in range(batch)]]
    raw = np.ascontiguousarray(rows, dtype=np.float32).tobytes()
    header = json.dumps({
        "inputs": [{"name": "INPUT0", "shape": list(rows.shape),
                    "datatype": "FP32",
                    "parameters": {"binary_data_size": len(raw)}}],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"binary_data": True}}],
    }).encode()
    bodies.append((header + raw, len(header)))
per_client = args["requests"] // args["concurrency"]
n = per_client * args["concurrency"]
lat = np.zeros(n)
index = np.zeros(n, dtype=np.int64)
outs = [None] * n
errors = []
path = "/v2/models/%s/infer" % args["model"]


def client(c):
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        for i in range(per_client):
            j = c * per_client + i
            k = j % len(bodies)
            body, hlen = bodies[k]
            t0 = time.monotonic()
            conn.request("POST", path, body=body, headers={
                "Inference-Header-Content-Length": str(hlen)})
            resp = conn.getresponse()
            data = resp.read()
            lat[j] = time.monotonic() - t0
            if resp.status != 200:
                raise RuntimeError("HTTP %d: %r" % (resp.status, data[:200]))
            jlen = int(resp.getheader("Inference-Header-Content-Length"))
            index[j] = k
            outs[j] = np.frombuffer(data[jlen:], dtype=np.float32)
    except Exception as e:
        errors.append(repr(e))
    finally:
        conn.close()


threads = [threading.Thread(target=client, args=(c,))
           for c in range(args["concurrency"])]
t0 = time.monotonic()
for th in threads:
    th.start()
for th in threads:
    th.join()
wall = time.monotonic() - t0
if not errors:
    np.savez(args["out"], lat=lat, index=index, outs=np.stack(outs))
print(json.dumps({"wall_s": wall, "errors": errors[:3]}))
"""


# the CUDA-shm load generator of phase 14, a process of its own that
# stays up across runs.  argv: one JSON object {addr, model, images,
# threads, big, classes}.  It makes, fills once and registers over HTTP
# (cudasharedmemory) one input and one output region for each of
# `threads` batch-1 clients (client c's holds image c) and one pair for
# a batch-`big` stream (images 0, 1, ..., cycling), then prints
# {"ready": ...}.  Each stdin line {concurrency, requests, batch, out} is
# one run: requests whose tensors are in the regions (a JSON body, no
# tensor bytes), each answer read from the client's output region after
# its response (outside the latency); it saves (latency, client index,
# answer) to `out` (.npz) and prints {"wall_s", "errors"}.  An empty
# line or EOF: unregister, destroy the regions, exit.  One reader
# thread copies the answers to the host, a batch of them at a time, with
# one CUDA wait that blocks (a spinning wait on every client thread
# would take the cores the server runs on).
SHM_CLIENT = r"""
import base64, http.client, json, queue, sys, threading, time
import numpy as np
import torch
from client_tpu_torch.utils import cuda_shared_memory as cudashm

args = json.loads(sys.argv[1])
host, port = args["addr"].split(":")
images = np.load(args["images"])
classes = args["classes"]
path = "/v2/models/%s/infer" % args["model"]
JSON = {"Content-Type": "application/json"}


def post(conn, url, body):
    conn.request("POST", url, body=body, headers=JSON)
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError("HTTP %d %s: %r" % (resp.status, url, data[:300]))
    return data


conn = http.client.HTTPConnection(host, int(port), timeout=120)
slots = {}
for batch, clients in ((1, args["threads"]), (args["big"], 1)):
    for c in range(clients):
        rows = images[[(c + r) % len(images) for r in range(batch)]]
        name = "shm%d_%d" % (batch, c)
        h_in = cudashm.create_shared_memory_region(name + "_in", rows.nbytes)
        h_out = cudashm.create_shared_memory_region(name + "_out",
                                                    4 * classes * batch)
        cudashm.set_shared_memory_region(h_in, [rows])
        for h in (h_in, h_out):
            post(conn, "/v2/cudasharedmemory/region/%s/register" % h.name,
                 json.dumps({"raw_handle": {"b64": base64.b64encode(
                     cudashm.get_raw_handle(h)).decode()},
                     "device_id": 0, "byte_size": h.byte_size}).encode())
        body = json.dumps({
            "inputs": [{"name": "INPUT0", "shape": list(rows.shape),
                        "datatype": "FP32", "parameters": {
                            "shared_memory_region": h_in.name,
                            "shared_memory_byte_size": h_in.byte_size}}],
            "outputs": [{"name": "OUTPUT0", "parameters": {
                "shared_memory_region": h_out.name,
                "shared_memory_byte_size": h_out.byte_size}}],
        }).encode()
        slots[batch, c] = (h_in, h_out, body)
print(json.dumps({"ready": len(slots)}), flush=True)
reads = queue.Queue()


def reader():
    while True:
        batch = [reads.get()]
        while not reads.empty():
            batch.append(reads.get())
        try:
            hosts = []
            for h_out, box, done in batch:
                src = h_out.span(0, h_out.byte_size)
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=src.is_cuda)
                host.copy_(src, non_blocking=src.is_cuda)
                hosts.append(host)
            if src.is_cuda:
                done = torch.cuda.Event(blocking=True)
                done.record()
                done.synchronize()
            for (h_out, box, done), host in zip(batch, hosts):
                box.append(host.numpy().view(np.float32).copy())
        except Exception as e:
            for h_out, box, done in batch:
                box.append(e)
        for h_out, box, done in batch:
            done.set()


threading.Thread(target=reader, daemon=True).start()


def client(c, batch, per_client, read, lat, index, outs, errors):
    h_in, h_out, body = slots[batch, c]
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        for i in range(per_client):
            j = c * per_client + i
            t0 = time.monotonic()
            post(conn, path, body)
            lat[j] = time.monotonic() - t0
            index[j] = c
            if not read:
                continue
            # the next request overwrites the region: read it first
            box, done = [], threading.Event()
            reads.put((h_out, box, done))
            done.wait()
            if isinstance(box[0], Exception):
                raise box[0]
            outs[j] = box[0]
    except Exception as e:
        errors.append(repr(e))
    finally:
        conn.close()


for line in sys.stdin:
    if not line.strip():
        break
    run = json.loads(line)
    batch, concurrency = run["batch"], run["concurrency"]
    per_client = run["requests"] // concurrency
    n = per_client * concurrency
    lat, index = np.zeros(n), np.zeros(n, np.int64)
    outs, errors = [None] * n, []
    threads = [threading.Thread(target=client, args=(
        c, batch, per_client, run["read"], lat, index, outs, errors))
        for c in range(concurrency)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.monotonic() - t0
    if not errors:
        np.savez(run["out"], lat=lat, index=index,
                 outs=np.stack(outs) if run["read"] else np.zeros(0))
    print(json.dumps({"wall_s": wall, "errors": errors[:3]}), flush=True)
post(conn, "/v2/cudasharedmemory/unregister", b"")
conn.close()
for h_in, h_out, _ in slots.values():
    cudashm.destroy_shared_memory_region(h_in)
    cudashm.destroy_shared_memory_region(h_out)
print(json.dumps({"closed": len(slots)}), flush=True)
"""


class ShmClient:
    """SHM_CLIENT in a process of its own (spawned: this process has CUDA
    up, so no fork).  Each ``run`` is one stream; ``close`` unregisters
    and destroys its regions and waits for the process."""

    def __init__(self, addr, model, images, tmp, threads, big):
        img_path = os.path.join(tmp, "shm_images.npy")
        np.save(img_path, images)
        self.stderr = open(os.path.join(tmp, "shm_client.err"), "w+")
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = popen(
            [sys.executable, "-c", SHM_CLIENT, json.dumps({
                "addr": addr, "model": model, "images": img_path,
                "threads": threads, "big": big, "classes": 1000})],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.stderr, text=True,
            env={**os.environ, "PYTHONPATH": here})
        self.ready = self._reply(300)

    def _reply(self, timeout):
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.proc.kill()
            self.stderr.seek(0)
            fail(f"shm client: no reply: {self.stderr.read()[-3000:]}")
        return json.loads(line)

    def run(self, args):
        self.proc.stdin.write(json.dumps(args) + "\n")
        self.proc.stdin.flush()
        return self._reply(600)

    def close(self):
        try:
            if self.proc.poll() is None:
                self.proc.stdin.write("\n")
                self.proc.stdin.flush()
                closed = self._reply(120)
                self.proc.wait(timeout=60)
                return closed
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.stderr.close()


def served_rate(addr, engine, name, images, want, concurrency, requests,
                batch=1, shm_client=None, read=True):
    """``requests`` requests of ``batch`` images over HTTP from
    ``concurrency`` clients in a process of their own: binary wire
    requests (VISION_CLIENT), or with ``shm_client`` requests whose
    tensors are in CUDA regions (SHM_CLIENT).  Returns infer/s, images/s,
    p50/p99 latency (client clock), the mean fused batch (inferences over
    executions in the window), where a request's time goes on the server,
    and each answer against the eager forward of its image (within twice
    the bf16 tolerance of its largest score: both are bf16, at other
    batch sizes); under ``_answers`` the last answer of each body or
    client index.  With ``read=False`` (CUDA regions only) the clients
    read no answer back, as perf_analyzer does not: nothing is checked
    but the counts."""
    before = engine.statistics(name)[0]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.npz")
        run = {"concurrency": concurrency, "requests": requests,
               "batch": batch, "out": out_path, "read": read}
        if shm_client is not None:
            report = shm_client.run(run)
        else:
            img_path = os.path.join(tmp, "images.npy")
            np.save(img_path, images)
            proc = subprocess.run(
                [sys.executable, "-c", VISION_CLIENT, json.dumps({
                    "addr": addr, "model": name, "images": img_path,
                    **run})],
                capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0,
                  f"load generator: {proc.stderr[-2000:]}")
            report = json.loads(proc.stdout.strip().splitlines()[-1])
        check(not report["errors"], f"served {name}: {report['errors']}")
        got = np.load(out_path)
        lat, index = got["lat"], got["index"]
        outs = got["outs"] if read else []
    after = engine.statistics(name)[0]
    n = len(lat)
    worst = 0.0 if read else "not read"
    for o, k in zip(outs, index):
        for r, row in enumerate(o.reshape(batch, -1)):
            w = want[(k + r) % len(want)]
            worst = max(worst, float(np.abs(row - w).max() / np.abs(w).max()))
    check(not read or worst <= 2 * VISION_BF16_TOL,
          f"served {name}: response off its eager forward by {worst}")
    inferences = after["inference_count"] - before["inference_count"]
    executions = after["execution_count"] - before["execution_count"]
    check(inferences == n * batch,
          f"served {name}: {inferences} inferences for {n * batch}")
    lat_ms = lat * 1e3

    def ms(key, per):  # server-side ns of one statistics entry, in ms
        ns = (after["inference_stats"][key]["ns"]
              - before["inference_stats"][key]["ns"])
        return ns / max(per, 1) / 1e6

    return {"concurrency": concurrency, "requests": n, "batch": batch,
            "infer_per_s": n / report["wall_s"],
            "images_per_s": n * batch / report["wall_s"],
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p99": float(np.percentile(lat_ms, 99)),
            "latency_ms_mean": float(lat_ms.mean()),
            "executions": executions,
            "mean_fused_batch": inferences / max(executions, 1),
            # where a request's time goes on the server: all of it (body
            # parsed to response rendered), the batcher's queue, and one
            # execution (copy-in, replay, copy-out, split)
            "server_ms_per_request": ms("success", n),
            "queue_ms_per_request": ms("queue", n),
            "execution_ms": (ms("compute_input", executions)
                             + ms("compute_infer", executions)
                             + ms("compute_output", executions)),
            "max_err_of_largest_score": worst,
            "_answers": {int(k): o for o, k in zip(outs, index)}}


def public(row):
    """A result without its private (underscored) entries."""
    return {k: v for k, v in row.items() if not k.startswith("_")}


def memcpy_bytes(prof, window):
    """Bytes and copies the device made by direction inside the user
    annotation ``window`` of a torch.profiler trace (the memcpy records
    of the exported trace, each with its byte count); "not measured" if
    a copy has no count."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    win = next(e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == window)
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    out = {f"{kind}_{what}": 0 for kind in ("HtoD", "DtoH", "DtoD")
           for what in ("bytes", "copies")}
    for e in events:
        if e.get("cat") != "gpu_memcpy" or not lo <= float(e["ts"]) <= hi:
            continue
        nbytes = (e.get("args") or {}).get("bytes")
        if nbytes is None:
            return "not measured"
        for kind in ("HtoD", "DtoH", "DtoD"):
            if kind in e.get("name", ""):
                out[f"{kind}_bytes"] += int(nbytes)
                out[f"{kind}_copies"] += 1
    return out


def served_busy_share(addr, engine, name, images, want, concurrency=32,
                      requests=256, shm_client=None):
    """The device-busy share of a served window at ``concurrency``
    clients, and the bytes the device copied a request by direction:
    torch.profiler switched on before the clients start and off after
    they end (no graph is launched then), the window a
    ``record_function`` span around them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the same traffic before the window, so records the tracer drops
        # as it starts are not the window's
        served_rate(addr, engine, name, images, want, concurrency,
                    2 * concurrency, shm_client=shm_client)
        with record_function("served_window"):
            rate = served_rate(addr, engine, name, images, want,
                               concurrency, requests, shm_client=shm_client)
        torch.cuda.synchronize()
    win = next(e for e in prof.events() if e.name == "served_window")
    lo, hi = win.time_range.start, win.time_range.end
    # the share of the clients' own run: the window also holds the start
    # of a one-shot load generator's process, when the device idles
    n = rate["requests"]
    run_us = n / rate["infer_per_s"] * 1e6
    share = busy_share(prof, run_us, window=(lo, hi))
    copies = memcpy_bytes(prof, "served_window")
    per_request = ({f"{kind}_bytes_per_request": copies[f"{kind}_bytes"] / n
                    for kind in ("HtoD", "DtoH", "DtoD")}
                   if isinstance(copies, dict) else {"copies": copies})
    return {"concurrency": concurrency, "requests": n,
            "infer_per_s_under_profiler": rate["infer_per_s"],
            "executions": rate["executions"], **per_request,
            "copies": copies, "window_ms": (hi - lo) / 1e3, **share}


VISION_STEPS = ("preprocess", "backbone", "postprocess")
VISION_STEP_INPUTS = {"preprocess": "IMAGE", "backbone": "PIXELS",
                      "postprocess": "FEATURES"}
VISION_STEP_ROWS = (1, 3)    # the shapes every step captures at first sight
VISION_STEP_TIMED = (1, 8)   # images a timed request
VISION_STEP_REPS = 10


def pipeline_images(rows, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (rows, VISION_IMAGE, VISION_IMAGE, 3), dtype=np.uint8)


def vision_step_plain(vision, runners, step, x):
    """The eager composition a step's program must equal bit for bit."""
    with torch.cuda.stream(torch.cuda.default_stream()):
        if step == "preprocess":
            return vision._preprocess_forward(x)
        if step == "backbone":
            return vision._resnet_features(
                runners.params, x, stage_strides=runners.strides).float()
        return torch.softmax(vision._resnet_head(runners.params, x), dim=-1)


def vision_step_input(vision, runners, step, rows, seed):
    """A seeded input of ``step`` on the card: images, or the pixels or
    features the eager functions make of them."""
    x = torch.from_numpy(pipeline_images(rows, seed)).cuda()
    for prior in VISION_STEPS[:VISION_STEPS.index(step)]:
        x = vision_step_plain(vision, runners, prior, x)
    return x


def vision_step_call(runners, step, x):
    out = getattr(runners, step)({VISION_STEP_INPUTS[step]: x}, {}, None)
    return next(iter(out.values()))


def vision_step_times(vision, runners, step, rows):
    """One request's device ms (CUDA events around the call, the device
    drained before it) and host ms (until the call returns), the median
    of VISION_STEP_REPS, through the step's program and eagerly."""
    x = vision_step_input(vision, runners, step, rows, 300 + rows)
    row = {}
    for leg, fn in (("replayed", lambda: vision_step_call(runners, step, x)),
                    ("eager", lambda: vision_step_plain(vision, runners,
                                                        step, x))):
        fn()
        device, host = [], []
        for _ in range(VISION_STEP_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record(torch.cuda.default_stream())
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record(torch.cuda.default_stream())
            end.synchronize()
            device.append(start.elapsed_time(end))
        row[f"{leg}_device_ms"] = float(np.median(device))
        row[f"{leg}_host_ms"] = float(np.median(host))
    return row


VISION_THREAD_ROWS = (1, 3, 1, 3)  # one thread each, two graphs a pool
VISION_THREAD_CALLS = 20


def vision_steps_concurrently(vision, runners, step):
    """Threads call ``step`` at once at VISION_THREAD_ROWS (held shapes
    whose graphs share the step's memory pool), VISION_THREAD_CALLS times
    each on their own seeded input; every result must equal the eager
    function of that input bit for bit.  Returns the calls checked."""
    inputs = [vision_step_input(vision, runners, step, r, 500 + i)
              for i, r in enumerate(VISION_THREAD_ROWS)]
    want = [vision_step_plain(vision, runners, step, x) for x in inputs]
    torch.cuda.synchronize()
    bad, errors = [], []
    start = threading.Barrier(len(inputs))

    def worker(i):
        try:
            start.wait(timeout=60)
            for _ in range(VISION_THREAD_CALLS):
                got = vision_step_call(runners, step, inputs[i])
                if not torch.equal(got, want[i]):
                    bad.append((VISION_THREAD_ROWS[i], (
                        got - want[i]).abs().max().item()))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(inputs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not errors and not bad and not any(t.is_alive() for t in threads),
          f"vision {step} from {len(threads)} threads at rows "
          f"{VISION_THREAD_ROWS}: errors {errors}, differing (rows, max "
          f"abs) {bad[:4]}")
    return len(threads) * VISION_THREAD_CALLS


def vision_programs_check(vision, runners, buckets, card):
    """Each step's programs at 224: every captured shape (rows 1 and 3 of
    each step, every backbone bucket of the warm-up) replayed on seeded
    inputs bit-equal to the eager function, called in turn and from
    threads at two shapes at once; held shapes run no eager forward and
    capture nothing more; each step's device and host ms a
    request, replayed against eager, at 1 and 8 images."""
    from client_tpu_torch import ops

    launches = dict(ops.LAUNCHES)
    warm = runners.graph_stats()
    check(warm["backbone"]["graphs"] == len(buckets)
          and sorted(k[0][1][0] for k in
                     runners.programs()["backbone"].shapes()) == buckets,
          f"backbone after warm-up: {warm['backbone']}, buckets {buckets}")
    checked = {}
    for step in VISION_STEPS:
        rows = sorted(set(VISION_STEP_ROWS)
                      | (set(buckets) if step == "backbone" else set()))
        for r in rows:
            for seed in (r, 1000 + r):  # the first sight, then held
                x = vision_step_input(vision, runners, step, r, seed)
                got = vision_step_call(runners, step, x)
                want = vision_step_plain(vision, runners, step, x)
                check(torch.equal(got, want),
                      f"vision {step} at {r} rows: the graph differs from "
                      f"eager by {(got - want).abs().max().item()}")
        checked[step] = rows
    concurrent = {step: vision_steps_concurrently(vision, runners, step)
                  for step in VISION_STEPS}
    held = runners.graph_stats()
    for step in VISION_STEPS:
        n = len(checked[step]) - (len(buckets) if step == "backbone" else 0)
        check(held[step]["eager_runs"] == 0
              and held[step]["graphs"] == warm[step]["graphs"] + n
              and held[step]["replays"] > 0,
              f"vision {step}: {held[step]} after {checked[step]}")
    # the timed row counts capture at their first sight too
    times = {step: {str(r): vision_step_times(vision, runners, step, r)
                    for r in VISION_STEP_TIMED} for step in VISION_STEPS}
    after = dict(ops.LAUNCHES)
    check(after == launches,
          f"the vision programs launched {launches} -> {after}")
    timed = runners.graph_stats()
    phase(13, "vision_programs", config="224, _RESNET50_STAGES, 1000 classes",
          graphs_vs_eager="bit-equal", shapes_checked=checked,
          concurrent_calls_bit_equal=concurrent,
          backbone_buckets=buckets, warm=warm, checked_stats=held,
          timed_stats=timed, times=times, hand_written_launches=0, **card)
    return timed


def vision_pipeline_run(pipeline_models, InferenceEngine, card):
    """The vision ensemble at 224 (ResNet-50 stages, 1000 classes) with
    the backbone warmed up (a graph per bucket): each step's programs
    against its eager function (``vision_programs_check``), then requests
    of 1 and 3 images, SCORES equal to the three composing models called
    in turn, 0 host hops, 2 device handoffs a request, no eager forward
    and no new capture at held shapes."""
    from client_tpu_torch.serve.dynamic_batcher import _buckets_up_to
    from client_tpu_torch.serve.models import vision

    models = pipeline_models(device="cuda", warmup=True)
    runners = models[0].fn.__self__
    engine = InferenceEngine(models)
    try:
        steps = [engine.get_model(f"vision_{s}") for s in VISION_STEPS]
        held = vision_programs_check(
            vision, runners, _buckets_up_to(steps[1].max_batch_size), card)
        results = []
        for rows in (1, 3, 1, 3):
            img = np.random.default_rng(rows).integers(
                0, 256, (rows, VISION_IMAGE, VISION_IMAGE, 3), dtype=np.uint8)
            raw = img.tobytes()
            request = {"inputs": [{"name": "IMAGE", "datatype": "UINT8",
                                   "shape": list(img.shape),
                                   "parameters": {"binary_data_size":
                                                  len(raw)}}],
                       "outputs": [{"name": "SCORES",
                                    "parameters": {"binary_data": True}}]}
            response, blobs = engine.execute("vision_pipeline", "", request,
                                             raw)
            got = np.frombuffer(blobs[0], dtype=np.float32).reshape(rows,
                                                                    1000)
            h = {"IMAGE": img}
            for step in steps:
                h = step.fn(h, {}, None)
            want = h["SCORES"].cpu().numpy()
            check(np.array_equal(got, want),
                  f"pipeline SCORES differ from the steps in turn by "
                  f"{np.abs(got - want).max()}")
            check(np.allclose(got.sum(1), 1.0, atol=1e-3), "SCORES sums")
            results.append(rows)
        hops = engine.metrics.get("ctpu_ensemble_host_hops_total",
                                  {"model": "vision_pipeline"}) or 0
        handoffs = engine.metrics.get("ctpu_ensemble_device_handoffs_total",
                                      {"model": "vision_pipeline"}) or 0
        check(hops == 0, f"{hops} host hops")
        check(handoffs == 2 * len(results),
              f"{handoffs} device handoffs for {len(results)} requests")
        served = runners.graph_stats()
        for step in VISION_STEPS:
            check(served[step]["eager_runs"] == 0
                  and served[step]["graphs"] == held[step]["graphs"],
                  f"held shapes: {step} {held[step]} -> {served[step]}")
        backbone = engine.statistics("vision_backbone")[0]
    finally:
        engine.close()
    return {"config": "224, _RESNET50_STAGES, 1000 classes",
            "requests_rows": results, "scores": "equal to the steps in turn",
            "host_hops": hops, "device_handoffs": handoffs,
            "backbone_executions": backbone["execution_count"],
            "held_shapes": "0 eager forwards, 0 captures",
            "graph_stats": served}


def vision_phase(card):
    """Phase 13: ResNet-50 and the CNN served through the dynamic batcher
    (graphs, precision, replay times, HTTP), then the vision ensemble."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models import pipeline_models, vision

    t_vision = time.monotonic()
    gen = torch.Generator().manual_seed(0)
    phase(13, "vision_same_padding", cases=same_pad_cases(vision, gen))
    served = {"resnet50": vision.resnet50_model(warmup=True),
              "cnn_classifier": vision.cnn_classifier_model(warmup=True)}
    forwards = {"resnet50": vision._resnet_forward,
                "cnn_classifier": vision._cnn_forward}
    ops.reset_launches()
    with Server(models=list(served.values()), http_port=0,
                with_default_models=False) as vserver:
        engine = vserver.engine
        for name, model in served.items():
            batcher = engine._batchers[name]
            params = model.fn.params
            weight_bytes = param_bytes(params)
            phase(13, "vision_graphs", model=name,
                  buckets=graphs_vs_eager(model, batcher),
                  replay_vs_eager="bit-equal", **batcher.graph_stats(),
                  weight_bytes=weight_bytes)
            phase(13, "vision_bf16_vs_f32", model=name,
                  **bf16_vs_f32(forwards[name], params))
            for row in replay_timings(model, batcher, weight_bytes):
                phase(13, "vision_replay_time", model=name,
                      flops_per_image=model.flops_per_item, **row, **card)
        # served over HTTP through the batcher: batch-1 binary requests
        model = served["resnet50"]
        images = vision_images(8, 1).numpy()
        want = model.fn({"INPUT0": images}, {}, None)["OUTPUT0"].cpu()
        want = [w.numpy() for w in want]  # the eager forward at batch 8
        wire = {}
        for concurrency, requests in VISION_CONCURRENCY:
            wire[concurrency] = served_rate(
                vserver.http_address, engine, "resnet50", images, want,
                concurrency, requests)
            phase(13, "vision_served", model="resnet50",
                  request_bytes=VISION_BYTES_PER_REQUEST,
                  **public(wire[concurrency]), **card)
        wire["profile"] = served_busy_share(vserver.http_address, engine,
                                           "resnet50", images, want)
        phase(13, "vision_served_profile", model="resnet50",
              **wire["profile"], **card)
        vision_launches = dict(ops.LAUNCHES)
        # the vision path runs library calls only: none of the hand-written
        # kernels (rows 1-5 of the kernel table) may have launched
        check(not any(vision_launches.values()),
              f"the vision path launched {vision_launches}")
        phase(13, "vision_pipeline",
              **vision_pipeline_run(pipeline_models, InferenceEngine, card))
        phase(13, "vision_done", launches=vision_launches,
              seconds=time.monotonic() - t_vision)
        # -- 14: the same server, its inputs and outputs in CUDA regions
        shm_phase(card, vserver, model, images, want, wire)


# -- CUDA shared memory (phase 14) ------------------------------------------

# the batch-1 concurrencies and request counts are phase 13's
SHM_PROFILE = ((1, 64), (8, 128), (32, 256))  # profiled windows
SHM_BIG = 64  # the bucket-64 stream (perf_analyzer -b 64 --shared-memory)
SHM_BIG_REQUESTS = 16
SHM_COPY_LIMIT = 1024  # H2D and D2H bytes a request on the CUDA-shm path


def copy_bytes(row, kind):
    value = row.get(f"{kind}_bytes_per_request")
    check(isinstance(value, float), f"{kind} bytes not measured: {row}")
    return value


def pipeline_shm_run(pipeline_models, InferenceEngine, cudashm, rows=3):
    """One request of the vision ensemble at 224 with its UINT8 images in
    a CUDA region and SCORES written to another (regions of this process,
    resolved through the broker): SCORES equal to the three composing
    models called in turn, 0 host hops, 2 device handoffs."""
    engine = InferenceEngine(pipeline_models(device="cuda"))
    img = np.random.default_rng(5).integers(
        0, 256, (rows, VISION_IMAGE, VISION_IMAGE, 3), dtype=np.uint8)
    h_in = cudashm.create_shared_memory_region("pipe_in", img.nbytes)
    h_out = cudashm.create_shared_memory_region("pipe_out", rows * 4000)
    try:
        cudashm.set_shared_memory_region(h_in, [img])
        for h in (h_in, h_out):
            engine.shm.register_cuda(h.name, cudashm.get_raw_handle(h), 0,
                                     h.byte_size)
        response, blobs = engine.execute("vision_pipeline", "", {
            "inputs": [{"name": "IMAGE", "datatype": "UINT8",
                        "shape": list(img.shape), "parameters": {
                            "shared_memory_region": "pipe_in",
                            "shared_memory_byte_size": img.nbytes}}],
            "outputs": [{"name": "SCORES", "parameters": {
                "shared_memory_region": "pipe_out",
                "shared_memory_byte_size": rows * 4000}}]}, b"")
        check(not blobs, "the ensemble answered tensor bytes")
        got = cudashm.get_contents_as_numpy(h_out, "FP32", [rows, 1000])
        h = {"IMAGE": img}
        for s in ("preprocess", "backbone", "postprocess"):
            h = engine.get_model(f"vision_{s}").fn(h, {}, None)
        want = h["SCORES"].cpu().numpy()
        check(np.array_equal(got, want),
              f"pipeline SCORES from the region differ from the steps in "
              f"turn by {np.abs(got - want).max()}")
        hops = engine.metrics.get("ctpu_ensemble_host_hops_total",
                                  {"model": "vision_pipeline"}) or 0
        handoffs = engine.metrics.get("ctpu_ensemble_device_handoffs_total",
                                      {"model": "vision_pipeline"}) or 0
        check(hops == 0, f"{hops} host hops")
        check(handoffs == 2, f"{handoffs} device handoffs for one request")
    finally:
        engine.close()
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)
    return {"config": "224, _RESNET50_STAGES, 1000 classes", "rows": rows,
            "input": f"UINT8 {list(img.shape)} in a CUDA region",
            "output": "SCORES in a CUDA region",
            "scores": "equal to the steps in turn", "host_hops": hops,
            "device_handoffs": handoffs}


def shm_phase(card, vserver, model, images, want, wire):
    """Phase 14: ResNet-50 on phase 13's server, its inputs and outputs in
    CUDA regions of a client process of its own (SHM_CLIENT): batch-1
    requests at concurrency 1, 8 and 32 beside phase 13's wire figures,
    a batch-64 stream beside the same stream over the wire, profiled
    windows (device-busy share, H2D and D2H bytes a request) of both
    paths, then one ensemble request from a CUDA region."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models import pipeline_models
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils.cuda_shared_memory import _build as shm_build

    t_shm = time.monotonic()
    # built in phase 2; loaded here before the client process starts, so
    # the two processes never wait on one build's lock
    shm_build.extension()
    addr, engine, name = vserver.http_address, vserver.engine, model.name
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        client = ShmClient(addr, name, images, tmp,
                           threads=max(c for c, _ in VISION_CONCURRENCY),
                           big=SHM_BIG)
        try:
            regions = engine.shm.cuda_status()
            check(len(regions) == 2 * client.ready["ready"],
                  f"{len(regions)} regions registered")
            check(all(e["opened"] for e in engine.shm._cuda.values()),
                  "a client process's region did not open over CUDA IPC")
            for concurrency, requests in VISION_CONCURRENCY:
                rate = served_rate(addr, engine, name, images, want,
                                   concurrency, requests, shm_client=client)
                if concurrency == 1:
                    for k, got in rate["_answers"].items():
                        check(np.array_equal(got, wire[1]["_answers"][k]),
                              f"CUDA-shm answer {k} differs from the wire's "
                              "at concurrency 1")
                phase(14, "cuda_shm_served", model=name,
                      request_bytes=VISION_BYTES_PER_REQUEST,
                      **public(rate), wire=public(wire[concurrency]),
                      **card)
            for concurrency, requests in VISION_CONCURRENCY:
                # perf_analyzer's own mode: no answer read back
                phase(14, "cuda_shm_served_unread", model=name,
                      **public(served_rate(addr, engine, name, images, want,
                                           concurrency, requests,
                                           shm_client=client, read=False)),
                      **card)
            big = served_rate(addr, engine, name, images, want, 1,
                              SHM_BIG_REQUESTS, batch=SHM_BIG,
                              shm_client=client)
            big_wire = served_rate(addr, engine, name, images, want, 1,
                                   SHM_BIG_REQUESTS, batch=SHM_BIG)
            check(np.array_equal(big["_answers"][0], big_wire["_answers"][0]),
                  "batch-64 CUDA-shm answers differ from the wire's")
            phase(14, "cuda_shm_batch64", model=name,
                  request_bytes=SHM_BIG * VISION_BYTES_PER_REQUEST,
                  **public(big), wire=public(big_wire), **card)
            for concurrency, requests in SHM_PROFILE:
                prof = served_busy_share(addr, engine, name, images, want,
                                         concurrency, requests,
                                         shm_client=client)
                wprof = (wire["profile"] if concurrency == 32 else
                         served_busy_share(addr, engine, name, images, want,
                                           concurrency, requests))
                phase(14, "cuda_shm_profile", model=name, **prof,
                      wire=wprof, **card)
                for kind in ("HtoD", "DtoH"):
                    check(copy_bytes(prof, kind) < SHM_COPY_LIMIT,
                          f"the CUDA-shm path copied {kind} "
                          f"{prof[f'{kind}_bytes_per_request']} bytes a "
                          "request")
                # the wire's image and scores in its copies; the tracer
                # can lose a copy record in a window (one in 64 on an
                # H100), so one request's worth may be missing
                seen = (wprof["requests"] - 1) / wprof["requests"]
                check(copy_bytes(wprof, "HtoD")
                      >= VISION_BYTES_PER_REQUEST * seen
                      and copy_bytes(wprof, "DtoH") >= 4000 * seen,
                      f"the wire path's copies were not counted: {wprof}")
        finally:
            closed = client.close()
    pipeline = pipeline_shm_run(pipeline_models, InferenceEngine, cudashm)
    phase(14, "cuda_shm_pipeline", **pipeline)
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"the CUDA-shm path launched {launches}")
    check(engine.shm.cuda_status() == {}, "regions left registered")
    phase(14, "cuda_shm_done", launches=launches,
          regions_closed=closed, seconds=time.monotonic() - t_shm)


# -- the operational surface (phase 15) -------------------------------------

OPS_SLO = {"*": {"p99_ms": 0.001}}  # an objective every request breaches
OPS_RATE_IMAGES = 128  # distinct images: the front door finds no repeat
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text):
    """A /metrics payload as {family: {"help", "type", "samples":
    [(name, labels, value)]}} and the family of each sample line in
    order."""
    meta, order = {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_ = line[7:].split(" ", 1)
            meta.setdefault(name, {"samples": []})["help"] = help_
        elif line.startswith("# TYPE "):
            name, type_ = line[7:].split(" ", 1)
            meta.setdefault(name, {"samples": []})["type"] = type_
        elif line.strip():
            name_part, _, value = line.rpartition(" ")
            name = name_part.split("{")[0]
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in meta:
                    family = name[:-len(suffix)]
            check(family in meta, f"/metrics sample {line!r} has no TYPE")
            meta[family]["samples"].append(
                (name, dict(_LABEL_RE.findall(name_part)), float(value)))
            order.append(family)
    return meta, order


def metric(meta, family, **labels):
    """The sum of a family's samples whose labels include *labels*."""
    return sum(v for _, got, v in meta.get(family, {"samples": []})["samples"]
               if all(got.get(k) == str(w) for k, w in labels.items()))


def binary_request(x):
    """(body, headers) of a binary ResNet-50 request for images *x*."""
    raw = np.ascontiguousarray(x, np.float32).tobytes()
    header = json.dumps({
        "inputs": [{"name": "INPUT0", "shape": list(x.shape),
                    "datatype": "FP32",
                    "parameters": {"binary_data_size": len(raw)}}],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"binary_data": True}}],
    }).encode()
    return header + raw, {"Inference-Header-Content-Length": str(len(header))}


def client_trace(i):
    """The trace id and span id a client sends for request *i*."""
    return f"{0x5e7a0000 + i:032x}", f"{0x5ba0 + i:016x}"


def ops_lm(addr):
    """16 LM requests over HTTP from 4 client threads (2 a tenant, so no
    tenant passes its cap of 2), each with a traceparent: 8 to the float32
    model, 4 each to the bf16 and int8 models.  MAX_TOKENS=1, the
    decoupled rule over HTTP (decode ticks still run: the scheduler
    dispatches them before the first token's readback).  Returns {i:
    (model, tenant, prompt, token)}."""
    prompts, _ = engine_prompts()
    models = ("lm_streaming_f32", "lm_streaming_int8", "lm_streaming_f32",
              "lm_streaming_batched")
    plan = {t: [(i, models[i // 4], prompts[i % len(prompts)])
                for i in range(t, 16, 4)] for t in range(4)}
    answers, errors = {}, []

    def client(t):
        tenant = "lo" if t % 2 == 0 else "hi"
        try:
            for i, model, prompt in plan[t]:
                trace_id, span_id = client_trace(i)
                _, body, _ = http(
                    addr, f"/v2/models/{model}/infer", lm_request(prompt, 1),
                    {"x-tenant-id": tenant,
                     "traceparent": f"00-{trace_id}-{span_id}-01"})
                token = json.loads(body)["outputs"][0]["data"][0]
                answers[i] = (model, tenant, prompt, token)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not errors and len(answers) == 16, f"LM requests: {errors}")
    return answers


def ops_check_lm(answers, engines, tfm, p32, cfg32, LmEngine):
    """Each answer against the same request with every hook off: the
    float32 model's against serial generate (the phase 11 rule), the bf16
    and int8 models' against their engines' own streams (phase 5's)."""
    for i, (model, _, prompt, got) in sorted(answers.items()):
        if model == "lm_streaming_f32":
            want = list(tfm.generate(p32, cfg32, prompt, 1,
                                     readback_depth=0))[0]
        else:
            want = collect(engines[model].submit(prompt, 1)[0],
                           LmEngine.CLOSE)[0]
        check(got == want, f"traced request {i} to {model} answered "
                           f"{got}, with the hooks off {want}")
    return {"requests": len(answers), "equal_to_hooks_off": True,
            "float32_vs_serial_generate": 8, "bf16_int8_vs_own_engine": 8}


def ops_trace_file(path, answers):
    """Every traced request's server span carries its client's trace id
    and span, its model and tenant; the tick spans are there."""
    records = [json.loads(line) for line in open(path)]
    by_trace = {r["trace_id"]: r for r in records
                if r.get("source") == "server"}
    for i, (model, tenant, _, _) in answers.items():
        trace_id, span_id = client_trace(i)
        span = by_trace.get(trace_id)
        check(span is not None, f"request {i}: no server span of trace "
                                f"{trace_id} in the trace file")
        names = [e["name"] for e in span["timestamps"]]
        check(span["parent_span_id"] == span_id
              and span["model_name"] == model
              and span.get("tenant") == tenant
              and names[0] == "REQUEST_START"
              and names[-1] == "RESPONSE_SENT",
              f"request {i}: server span {span}")
    ticks = {}
    for r in records:
        if r["model_name"].startswith("__lm_"):
            ticks[r["model_name"]] = ticks.get(r["model_name"], 0) + 1
    check(ticks.get("__lm_decode__", 0) > 0
          and ticks.get("__lm_prefill_chunk__", 0) > 0,
          f"tick spans in the trace file: {ticks}")
    return {"records": len(records), "request_spans": len(answers),
            "tick_spans": ticks}


def ops_resnet(addr, engine, model, cudashm):
    """16 identical batch-1 requests from 8 threads through the front door
    (bit-equal answers, fewer executions than requests, cache hits), then
    one image from a CUDA region twice, its answer into another: the
    cache is bypassed.  Returns (report, cache hits)."""
    x = vision_images(1, 77).numpy()
    want = model.fn({"INPUT0": x}, {}, None)["OUTPUT0"].float().cpu().numpy()
    body, headers = binary_request(x)
    before = engine.statistics("resnet50")[0]
    outs, errors = [], []

    def client():
        try:
            for _ in range(2):
                _, got, h = http(addr, "/v2/models/resnet50/infer", body,
                                 headers)
                outs.append(got[int(h["Inference-Header-Content-Length"]):])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not errors and len(outs) == 16, f"resnet50 requests: {errors}")
    check(len(set(outs)) == 1, "16 identical requests, answers not equal")
    answer = np.frombuffer(outs[0], np.float32).reshape(want.shape)
    err = float(np.abs(answer - want).max() / np.abs(want).max())
    check(err <= 2 * VISION_BF16_TOL, f"resnet50 answer off eager by {err}")
    mid = engine.statistics("resnet50")[0]
    _, stats_body, _ = http(addr, "/v2/models/resnet50/stats")
    http_stats = json.loads(stats_body)["model_stats"][0]
    executions = mid["execution_count"] - before["execution_count"]
    hits = (http_stats["inference_stats"]["cache_hit"]["count"]
            - before["inference_stats"]["cache_hit"]["count"])
    check(executions < 16, f"{executions} executions for 16 requests")
    check(hits >= 1, f"{hits} cache hits on 16 identical requests")
    n_in, n_out = x.nbytes, want.nbytes
    regions = {name: cudashm.create_shared_memory_region(name, n)
               for name, n in (("ops_in", n_in), ("ops_out", n_out))}
    shm_answers = []
    try:
        cudashm.set_shared_memory_region(regions["ops_in"], [x])
        for name, region in regions.items():
            http(addr, f"/v2/cudasharedmemory/region/{name}/register",
                 json.dumps({"raw_handle": {"b64": base64.b64encode(
                     cudashm.get_raw_handle(region)).decode()},
                     "device_id": 0,
                     "byte_size": region.byte_size}).encode())
        shm_body = json.dumps({
            "inputs": [{"name": "INPUT0", "shape": list(x.shape),
                        "datatype": "FP32", "parameters": {
                            "shared_memory_region": "ops_in",
                            "shared_memory_byte_size": n_in}}],
            "outputs": [{"name": "OUTPUT0", "parameters": {
                "shared_memory_region": "ops_out",
                "shared_memory_byte_size": n_out}}]}).encode()
        for _ in range(2):
            http(addr, "/v2/models/resnet50/infer", shm_body)
            shm_answers.append(cudashm.get_contents_as_numpy(
                regions["ops_out"], "FP32", list(want.shape)))
    finally:
        for name, region in regions.items():
            http(addr, f"/v2/cudasharedmemory/region/{name}/unregister",
                 b"{}")
            cudashm.destroy_shared_memory_region(region)
    after = engine.statistics("resnet50")[0]
    shm_hits = (after["inference_stats"]["cache_hit"]["count"]
                - mid["inference_stats"]["cache_hit"]["count"])
    shm_execs = after["execution_count"] - mid["execution_count"]
    check(shm_hits == 0 and shm_execs == 2,
          f"CUDA-region requests: {shm_hits} cache hits, {shm_execs} "
          "executions")
    for got in shm_answers:
        e = float(np.abs(got - want).max() / np.abs(want).max())
        check(e <= 2 * VISION_BF16_TOL, f"CUDA-region answer off by {e}")
    return {"requests": 16, "threads": 8, "executions": executions,
            "cache_hits": hits, "answers_bit_equal": True,
            "max_err_of_largest_score": err,
            "cuda_region": {"requests": 2, "cache_hits": shm_hits,
                            "executions": shm_execs,
                            "bit_equal_to_wire": all(
                                np.array_equal(g, answer)
                                for g in shm_answers)}}, hits


def ops_hook_cost(addr, engine, LmEngine, pbf, cfg, prompt, card):
    """The cost of the hooks, printed only: engine tokens/s at 8 streams
    with every hook bound (tracing each tick into the phase's trace file),
    with the hooks bound and tracing off, and with none, in turns; served
    ResNet-50 infer/s at concurrency 8 with the front door on and off, in
    turns (on, off, off, on), tracing on in both.  ResNet-50 gets distinct images and the cache is emptied before
    each turn, so the front door pays its digest, lookup and fill and
    finds no repeat; its tenant cap is lifted (8 clients of one
    tenant)."""
    from client_tpu_torch.serve.frontdoor import Coalescer, TenantQoS
    from client_tpu_torch.serve.model_runtime import InferenceEngine

    sources = {}
    for hooks in ("traced", "untraced"):
        sources[hooks] = InferenceEngine(qos=TenantQoS(
            default_max_inflight=2, tenants={"hi": {"priority": 10.0}}))
    sources["traced"].update_trace_settings(dict(engine.trace_settings))

    def binder(source):
        def bind(eng):  # what the served model's binder does
            eng.set_registry(source.metrics)
            eng.tracer = source.tracer
            eng.flight = source.flight
            source.prof.adopt(eng.prof)
            eng.tenant_lane_share = source.qos.lane_share
            eng.tenant_priority = source.qos.priority
        return bind

    lm = []
    for hooks in ("traced", "none", "untraced", "untraced", "none",
                  "traced"):
        row = engine_rate(LmEngine, pbf, cfg, prompt, 8, hooks=(
            binder(sources[hooks]) if hooks in sources else None))
        lm.append({"hooks": hooks, "tokens_per_s": row["tokens_per_s"],
                   "ttft_ms_mean": row["ttft_ms_mean"],
                   "host_ms_per_tick": row["host_ms_per_tick"],
                   "dispatch_ms_per_tick": row["dispatch_ms_per_tick"]})
    model = engine.get_model("resnet50")
    images = vision_images(OPS_RATE_IMAGES, 78).numpy()
    want = [w.float().cpu().numpy()
            for lo in range(0, OPS_RATE_IMAGES, 32)
            for w in model.fn({"INPUT0": images[lo:lo + 32]}, {},
                              None)["OUTPUT0"]]
    front = (engine.response_cache, engine._coalescer, engine.qos)
    uncapped = TenantQoS(registry=engine.metrics)
    served = []
    try:
        for on in (True, False, False, True):
            engine.response_cache, engine._coalescer, engine.qos = (
                (front[0], front[1] or Coalescer(), uncapped) if on
                else (None, None, None))
            front[0].clear()  # no turn may answer from an earlier one
            row = served_rate(addr, engine, "resnet50", images, want, 8,
                              OPS_RATE_IMAGES)
            served.append({"front_door": on,
                           "infer_per_s": row["infer_per_s"],
                           "latency_ms_p50": row["latency_ms_p50"],
                           "latency_ms_p99": row["latency_ms_p99"],
                           "mean_fused_batch": row["mean_fused_batch"]})
    finally:
        engine.response_cache, engine._coalescer, engine.qos = front
    phase(15, "ops_hook_cost", lm_streams=8, lm_tokens_each=ENGINE_TOKENS,
          lm=lm, resnet50_concurrency=8, resnet50_requests=OPS_RATE_IMAGES,
          resnet50=served,
          note="printed only: no claim, no limit; traced: every hook "
               "bound and every tick traced into a file (trace_rate 1); "
               "untraced: the hooks bound, tracing off; ResNet-50 traced "
               "at trace_rate 1 in every turn",
          **card)


def ops_phase(card, p32, cfg32, pbf, cfg, prompt):
    """Phase 15: the server's operational surface around the served LM
    engines and ResNet-50 with every hook on, its cost, then a drain.
    Returns the launch counts and routes of the traced LM requests (reset
    just before the server starts, read just after them)."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.frontdoor import ResponseCache, TenantQoS
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language, vision
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.serve.slo import SloWatchdog
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils.cuda_shared_memory import _build as shm_build

    t_ops = time.monotonic()
    shm_build.extension()  # built in phase 2
    models = language.language_models(device="cuda")
    models.append(language.lm_streaming_batched_model(
        name="lm_streaming_f32",
        runner=language._LmRunner(cfg=cfg32, params=p32, device="cuda")))
    resnet = vision.resnet50_model(warmup=True)
    engines = {m.name: m.closer.__self__ for m in models
               if m.closer is not None}
    qos = TenantQoS(default_max_inflight=2,
                    tenants={"hi": {"priority": 10.0}})
    slo = SloWatchdog(objectives=OPS_SLO, min_samples=1, check_every=1)
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp, Server(
            models=models + [resnet], with_default_models=False,
            response_cache=ResponseCache(),
            coalescing=True, qos=qos, slo=slo, max_inflight=64) as server:
        addr, engine = server.http_address, server.engine
        engine.flight.dump_dir = tmp
        trace_path = os.path.join(tmp, "trace.jsonl")
        _, body, _ = http(addr, "/v2/trace/setting", json.dumps({
            "trace_level": ["TIMESTAMPS"], "trace_rate": "1",
            "trace_file": trace_path}).encode())
        check(json.loads(body)["trace_rate"] == "1", f"settings {body}")
        # -- traced LM streams, split over tenants lo and hi
        answers = ops_lm(addr)
        sent = {"resnet50": 16 + 2}  # model -> requests answered 200
        for model, *_ in answers.values():
            sent[model] = sent.get(model, 0) + 1
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        routes = {name: dict(r) for name, r in ops.ROUTES.items()}
        check(launches["int8_matmul"] > 0 and launches["paged_attention"] > 0,
              f"the traced LM requests launched {launches}")
        lm = ops_check_lm(answers, engines, tfm, p32, cfg32, LmEngine)
        # -- a third concurrent request of tenant lo: 429
        held = [engine.execute("lm_streaming_batched", "",
                               json.loads(lm_request(prompt, 1)), b"",
                               tenant="lo") for _ in range(2)]
        try:
            http(addr, "/v2/models/lm_streaming_batched/infer",
                 lm_request(prompt, 1), {"x-tenant-id": "lo"})
            fail("a third concurrent request of tenant lo was admitted")
        except urllib.error.HTTPError as e:
            retry_after = e.headers.get("Retry-After")
            check(e.code == 429 and retry_after is not None
                  and retry_after.isdigit() and int(retry_after) >= 1,
                  f"over the tenant cap: {e.code}, Retry-After "
                  f"{retry_after!r}")
        finally:
            for stream in held:
                stream.close()
        # -- ResNet-50 through the front door, and from a CUDA region
        front, hits = ops_resnet(addr, engine, resnet, cudashm)
        # -- /metrics
        engine.slo.check_now()
        time.sleep(0.3)  # the LM schedulers' last drain pass
        engine.prof.report()  # flushes every profiler's series
        _, text, _ = http(addr, "/metrics")
        meta, order = parse_metrics(text.decode())
        runs = [k for k, _ in itertools.groupby(order)]
        check(len(runs) == len(set(runs)), "interleaved /metrics families")
        check(all(info.get("help") and info.get("type")
                  for info in meta.values()), "a family without HELP/TYPE")
        for model, n in sent.items():
            got = metric(meta, "ctpu_inference_request_success", model=model)
            check(got == n, f"ctpu_inference_request_success {model}: {got}, "
                            f"{n} answered")
        used = metric(meta, "ctpu_gpu_memory_used_bytes")
        total = metric(meta, "ctpu_gpu_memory_total_bytes")
        check(0 < used <= total, f"GPU memory used {used} of {total}")
        check(metric(meta, "ctpu_cache_hits_total") >= hits,
              "ctpu_cache_hits_total below the statistics' hits")
        for prefix in ("ctpu_lm_", "ctpu_prof_", "ctpu_slo_"):
            check(any(f.startswith(prefix) for f in meta),
                  f"no {prefix}* family on /metrics")
        # -- debug endpoints
        _, body, _ = http(addr, "/v2/debug/prof?window=0")
        lm_prof = [e for e in json.loads(body)["engines"]
                   if e["engine"] == "lm" and e["kinds"].get("decode")]
        mfu = [e["models"]["lm"]["mfu_pct"] for e in lm_prof
               if "mfu_pct" in e["models"].get("lm", {})
               and e["peak_tflops"] == 989.0]
        check(mfu, f"/v2/debug/prof: adopted lm profilers {lm_prof}")
        _, body, _ = http(addr, "/v2/debug/flight")
        kinds = {json.loads(line)["kind"] for line in body.splitlines()}
        check({"span", "prof_tick", "slo_breach"} <= kinds,
              f"/v2/debug/flight kinds {kinds}")
        _, body, _ = http(addr, "/v2/debug/flight?dump=1")
        dumped = json.loads(body)["dumped"]
        check(dumped and os.path.isfile(dumped), f"?dump=1 wrote {dumped}")
        _, body, _ = http(addr, "/v2/debug/slo")
        slo_view = json.loads(body)
        breaches = metric(meta, "ctpu_slo_breaches_total")
        slo_dumps = [p for p in engine.flight.dumps if "slo_breach" in p]
        check(any(v["breaches"] >= 1 for v in slo_view.values())
              and breaches >= 1 and slo_dumps
              and all(os.path.isfile(p) for p in slo_dumps),
              f"SLO breach: {breaches} counted, dumps {slo_dumps}")
        engine.tracer.flush()
        traces = ops_trace_file(trace_path, answers)
        phase(15, "ops", models=[e["name"] for e in
                                 engine.repository_index()],
              lm=lm, traces=traces,
              tenant_cap={"tenant": "lo", "cap": 2, "third": 429,
                          "retry_after_s": retry_after},
              resnet50=front, metrics_families=len(meta),
              gpu_memory={"used_bytes": used, "total_bytes": total},
              lm_prof={"profilers": len(lm_prof), "mfu_pct": mfu,
                       "peak_tflops": 989.0},
              slo={"objective": OPS_SLO, "breaches": breaches,
                   "dumps": len(slo_dumps)},
              launches=launches, launches_by_route=routes)
        # -- the cost of the hooks (printed only)
        ops_hook_cost(addr, engine, LmEngine, pbf, cfg, prompt, card)
        # -- drain
        check(engine.drain(timeout_s=30), "drain did not finish in 30 s")
        try:
            http(addr, "/v2/health/ready")
            fail("ready answered 200 after the drain")
        except urllib.error.HTTPError as e:
            check(e.code == 503, f"ready answered {e.code} after the drain")
        try:
            http(addr, "/v2/models/resnet50/infer",
                 *binary_request(vision_images(1, 79).numpy()))
            fail("a drained server admitted a request")
        except urllib.error.HTTPError as e:
            drained_retry = e.headers.get("Retry-After")
            check(e.code == 503 and drained_retry == "1",
                  f"drained infer: {e.code}, Retry-After {drained_retry!r}")
        _, text, _ = http(addr, "/metrics")
        draining = metric(parse_metrics(text.decode())[0], "ctpu_draining")
        check(draining == 1, f"ctpu_draining {draining}")
        phase(15, "ops_drain", drained=True, ready=503, infer=503,
              retry_after_s=drained_retry, ctpu_draining=draining,
              seconds=time.monotonic() - t_ops)
    return launches, routes


# -- the mixture-of-experts LM (phase 16) ------------------------------------

# the card's MoE config: the flagship at full width with 8 experts, top 2
# (Mixtral's routing); bf16 weights, the expert stacks never quantized
MOE = dict(FLAGSHIP, n_experts=8, top_k=2)
MOE_RATE_STREAMS = (1, 4, 8)
DECODE_CONTEXT = 128  # the context of the timed decode replay


@contextlib.contextmanager
def aux_recorded(tfm, out):
    """Record the router aux loss of every ``forward(..., with_aux=True)``
    (the train step's loss_fn calls it so) into ``out``: the step itself
    runs unchanged."""
    forward = tfm.forward

    def observed(*args, **kwargs):
        result = forward(*args, **kwargs)
        if kwargs.get("with_aux"):
            out.append(result[1].detach())
        return result

    tfm.forward = observed
    try:
        yield out
    finally:
        tfm.forward = forward


@contextlib.contextmanager
def routing_recorded(tfm, out, forced=None):
    """Record, for every MoE block a forward runs, each token's top-k
    expert set (sorted) and its router's gap between the k-th and the
    next logit, recomputed from the block's own input.  With ``forced``
    (what an earlier run recorded), the i-th block routes its tokens to
    the experts recorded for the i-th block there, in place of its own
    top-k; otherwise the block runs unchanged."""
    moe_block = tfm._moe_block

    def observed(layer, x, cfg, with_aux=True, region=tfm._ONE_DEVICE):
        with torch.no_grad():
            h = tfm._rms_norm(x, layer["ln_mlp"])
            logits = h.float() @ layer["moe"]["router"].float()
            top, idx = torch.topk(logits, cfg.top_k + 1, dim=-1)
        route = None if forced is None else forced[len(out)][0]
        out.append((idx[..., :cfg.top_k].sort(dim=-1).values,
                    top[..., cfg.top_k - 1] - top[..., cfg.top_k]))
        return moe_block(layer, x, cfg, with_aux, route=route,
                         region=region)

    tfm._moe_block = observed
    try:
        yield out
    finally:
        tfm._moe_block = moe_block


def routed_vs(tfm, params, tokens, cfg, atol):
    """The MoE forward, flash against plain attention on the same weights
    and on one routing: the plain run routes every token of every layer to
    the experts the flash run chose (a token whose router logits lie near
    a tie may otherwise take another expert on either side, and its
    changed state reaches every later token of its sequence through
    attention).  The logits are held to ``atol`` and their argmax
    agreement to MIN_AGREE at every position.  Fails otherwise, or if the
    plain run's own top-k differs from the flash run's at more than
    MOE_ROUTING_DIFF of the (token, layer) decisions."""
    routes = {}
    outs = {}
    for impl in ("flash", "plain"):
        rec = []
        with routing_recorded(tfm, rec, routes.get("flash")):
            outs[impl] = tfm.forward(params, tokens, cfg, attn_impl=impl,
                                     with_aux=True)
        routes[impl] = rec
    (lf, aux_f), (lp, aux_p) = outs["flash"], outs["plain"]
    diff = (lf - lp).abs()
    worst = int(diff.argmax())
    err, at = diff.flatten()[worst].item(), lp.flatten()[worst].item()
    agree = (lf.argmax(-1) == lp.argmax(-1)).float().mean().item()
    flips = [(a != b).any(dim=-1)
             for (a, _), (b, _) in zip(routes["flash"], routes["plain"])]
    decisions = torch.stack(flips).float().mean().item()
    gaps = torch.cat([g[f] for (_, g), f in zip(routes["plain"], flips)])
    check(bool(torch.isfinite(lf).all()) and err <= atol
          and agree >= MIN_AGREE and decisions <= MOE_ROUTING_DIFF,
          f"MoE {cfg.dtype} forward flash against plain on one routing: "
          f"max abs err {err} (atol {atol}) at a logit of {at}, argmax "
          f"agreement {agree}; the plain run's own top-k differs at "
          f"{decisions} of the decisions (at most {MOE_ROUTING_DIFF})")
    return {"layers": cfg.n_layers, "positions": lf.shape[0] * lf.shape[1],
            "max_abs_err": err, "logit_at_max_err": at,
            "max_abs_logit": lp.abs().max().item(), "atol": atol,
            "argmax_agree": agree,
            "routing_diff_max": MOE_ROUTING_DIFF,
            "own_routing_differs_share": decisions,
            "router_gap_where_it_differs_max":
                gaps.max().item() if gaps.numel() else None,
            "aux_flash": float(aux_f), "aux_plain": float(aux_p)}


@contextlib.contextmanager
def eager_programs(lm_engine):
    """Engines built inside run every program eagerly (the capture is
    skipped, so ``_Program.run`` calls its body): the eager side of a
    graph-against-eager stream comparison."""
    capture = lm_engine._Program.capture
    lm_engine._Program.capture = lambda self, pool, stream: None
    try:
        yield
    finally:
        lm_engine._Program.capture = capture


def first_divergence(got, want):
    """Where two greedy streams first differ (None: equal)."""
    if got == want:
        return None
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def decode_bound(params, cfg, lanes=8, context=DECODE_CONTEXT):
    """The least device time of one decode tick at ``lanes`` lanes, each at
    ``context``: every weight read once (the embedding: ``lanes`` rows;
    the MoE stacks in full, as the dense formulation reads them), each
    lane's K/V read once, the logits written once; the operations are
    2 a weight element a lane (every expert's) at the bf16 peak."""
    weight_bytes = param_bytes(params) - param_bytes(params["embed"])
    weight_bytes += lanes * cfg.d_model * params["embed"].element_size()
    from client_tpu_torch.serve.models.transformer import _leaves

    weight_elems = sum(w.numel() for w in _leaves(params)) \
        - params["embed"].numel()
    elt = torch.finfo(cfg.tdtype).bits // 8
    kv = lanes * context * cfg.n_kv_heads * cfg.head_dim * 2 * elt \
        * cfg.n_layers
    logits = lanes * cfg.vocab_size * 4
    total = weight_bytes + kv + logits
    flops = 2 * lanes * weight_elems
    bytes_ms = total / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": total, "weight_bytes": weight_bytes}


def moe_tokens(seed):
    """The MoE train batch [TRAIN_BATCH, TRAIN_SEQ + 1] from ``seed``."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, MOE["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()


def moe_phase(card, prompt):
    """Phase 16: the MoE LM at the card's MoE config (MOE), through every
    LM path of the port: forward, training, the engine's captured ticks;
    timed in turns with the dense flagship.  Returns the launches of its
    counted runs: {"train": ..., "bfloat16": ..., "int8": ...}, each
    {"launches": ..., "routes": ...}."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.lm import engine as lm_engine
    from client_tpu_torch.serve.models import transformer as tfm

    t_phase = time.monotonic()
    cfg = tfm.TransformerConfig(**MOE)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dense = tfm.TransformerConfig(**FLAGSHIP)
    init = lambda c: tfm.init_params(  # noqa: E731
        torch.Generator().manual_seed(0), c, "cuda")
    tokens = moe_tokens(TRAIN_SEED)

    # forward: flash against plain, bf16 at 4 layers from each seed's
    # weights and tokens, f32 at 2
    forward = {}
    cfg32_2 = dataclasses.replace(cfg32, n_layers=2)
    with torch.no_grad():
        for seed in MOE_TRAIN_SEEDS:
            forward[f"bfloat16_seed{seed}"] = routed_vs(
                tfm, tfm.init_params(torch.Generator().manual_seed(seed),
                                     cfg, "cuda"),
                moe_tokens(seed)[:, :-1], cfg, MOE_LOGIT_ATOL)
        forward["float32"] = routed_vs(tfm, init(cfg32_2), tokens[:, :-1],
                                       cfg32_2, F32_LOGIT_ATOL)

    # training: 10 flash Adam steps against plain attention, from the
    # weights and tokens of each seed (the first seed's flash run counted),
    # the plain run routed at every step as the flash run was
    train = {}
    for seed in MOE_TRAIN_SEEDS:
        run, routes = {}, {}
        seed_tokens = moe_tokens(seed)
        for impl in ("flash", "plain"):
            counted = impl == "flash" and seed == MOE_TRAIN_SEEDS[0]
            auxes = []
            params = tfm.init_params(torch.Generator().manual_seed(seed),
                                     cfg, "cuda")
            if counted:
                ops.reset_launches()
            forced = routes.get("flash")
            routes[impl] = []
            with aux_recorded(tfm, auxes), routing_recorded(
                    tfm, routes[impl], forced):
                t0 = time.monotonic()
                # eager: the hooks record (and the plain run forces)
                # every step's routing, which a replay would not re-run
                _, _, losses, _ = train_run(tfm, cfg, impl, seed_tokens,
                                            TRAIN_STEPS, params, eager=True)
                torch.cuda.synchronize()
                seconds = time.monotonic() - t0
            if counted:
                train_launches = {"launches": dict(ops.LAUNCHES),
                                  "routes": {k: dict(v) for k, v
                                             in ops.ROUTES.items()}}
            auxes = [float(a) for a in auxes]
            check(len(auxes) == TRAIN_STEPS and all(np.isfinite(auxes))
                  and all(a > 0 for a in auxes),
                  f"MoE {impl} router aux losses {auxes} (seed {seed})")
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"MoE {impl} training losses {losses} (seed {seed})")
            run[impl] = {"losses": losses, "aux": auxes,
                         "seconds_10_steps": seconds}
        diffs = [abs(a - b) for a, b in zip(run["flash"]["losses"],
                                            run["plain"]["losses"])]
        check(diffs[0] <= TRAIN_LOSS0_ATOL
              and max(diffs) <= TRAIN_LOSS_STEP_ATOL
              and diffs[-1] <= TRAIN_LOSS_LAST_ATOL,
              f"MoE flash losses {run['flash']['losses']} against plain "
              f"{run['plain']['losses']} (seed {seed})")
        check(len(routes["plain"]) == len(routes["flash"])
              == TRAIN_STEPS * cfg.n_layers,
              f"MoE training ran {len(routes['flash'])} flash and "
              f"{len(routes['plain'])} plain MoE blocks (seed {seed})")
        own = torch.stack([(a != b).any(dim=-1).float().mean()
                           for (a, _), (b, _)
                           in zip(routes["flash"], routes["plain"])])
        train[seed] = {**run, "loss0_diff": diffs[0],
                       "max_loss_diff": max(diffs),
                       "last_loss_diff": diffs[-1],
                       "plain_own_routing_differs_share": own.mean().item()}
    per_step = {n: c / TRAIN_STEPS
                for n, c in train_launches["launches"].items()}
    check(per_step == {"int8_matmul": 0, "paged_attention": 0,
                       **{n: cfg.n_layers for n in FLASH_KERNELS}},
          f"MoE flash training launched {train_launches['launches']} in "
          f"{TRAIN_STEPS} steps, expected {cfg.n_layers} of each flash "
          f"kernel a step")
    phase(16, "moe_training", config=MOE, dtype=cfg.dtype,
          tokens=[TRAIN_BATCH, TRAIN_SEQ + 1], steps=TRAIN_STEPS, lr=TRAIN_LR,
          router_aux_coef=cfg.router_aux_coef, forward_flash_vs_plain=forward,
          launches=train_launches["launches"], launches_per_step=per_step,
          seeds=train, loss0_atol=TRAIN_LOSS0_ATOL,
          max_loss_atol=TRAIN_LOSS_STEP_ATOL,
          last_loss_atol=TRAIN_LOSS_LAST_ATOL, **card)

    moe_train_graph(tfm, cfg, tokens, card)

    # the engine: float32 streams equal to serial generate; bf16 and int8
    # graph streams equal to the same engine's programs run eagerly
    prompts, lengths = engine_prompts()
    p32, pbf = init(cfg32), init(cfg)
    p8 = tfm.quantize_params(pbf)
    check(all(w is pbf["layers"][i]["moe"][k]
              for i, layer in enumerate(p8["layers"])
              for k, w in layer["moe"].items()),
          "quantize_params changed an MoE expert stack")
    report, counted = {}, {"train": train_launches}
    got, launches, ticks, stats = engine_run(LmEngine, ops, p32, cfg32,
                                             prompts, lengths)
    for p, n, g in zip(prompts, lengths, got):
        s = list(tfm.generate(p32, cfg32, p, n, readback_depth=0))
        check(g == s, f"MoE float32 engine stream of a {len(p)}-token "
                      f"prompt {g} != serial generate {s}")
    report["float32"] = {"streams": len(prompts), "equal_to_serial": True,
                         **check_launches(launches, ticks, cfg32, p32),
                         "graphs": stats["graphs"]}
    for name, params in (("bfloat16", pbf), ("int8", p8)):
        got, launches, ticks, stats = engine_run(LmEngine, ops, params, cfg,
                                                 prompts, lengths)
        routes = {k: dict(v) for k, v in ops.ROUTES.items()}
        with eager_programs(lm_engine):
            eager, eager_launches, eager_ticks, _ = engine_run(
                LmEngine, ops, params, cfg, prompts, lengths)
        for p, g, e in zip(prompts, got, eager):
            check(g == e, f"MoE {name} graph stream of a {len(p)}-token "
                          f"prompt {g} != the eager programs' {e}")
        serial = [list(tfm.generate(params, cfg, p, n, readback_depth=0))
                  for p, n in zip(prompts, lengths)]
        divergent = [{"prompt_tokens": len(p), "first_divergence": i}
                     for p, g, s in zip(prompts, got, serial)
                     if (i := first_divergence(g, s)) is not None]
        report[name] = {
            "streams": len(prompts), "graph_equal_to_eager": True,
            "eager_launches": eager_launches,
            "equal_to_serial": len(prompts) - len(divergent),
            "divergent_from_serial": divergent,
            **check_launches(launches, ticks, cfg, params),
            "launches_by_route": routes, "graphs": stats["graphs"]}
        counted[name] = {"launches": launches, "routes": routes}
    check(counted["int8"]["launches"]["int8_matmul"] > 0
          and all(counted[n]["launches"]["paged_attention"] > 0
                  for n in ("bfloat16", "int8")),
          f"the MoE engine launched {counted}")
    graphs = engine_graphs(LmEngine, ops, pbf, cfg, cfg.vocab_size)
    phase(16, "moe_engine", config=MOE, engine=ENGINE_KW,
          prompt_tokens=[len(p) for p in prompts], tokens=lengths,
          graphs_bfloat16=graphs, **report)

    # timings, in turns with the dense flagship in this process
    models = {"dense": (init(dense), dense), "moe": (pbf, cfg)}
    flops_factor = cfg.n_experts / cfg.top_k
    for name in ("dense", "moe", "moe", "dense"):
        params, c = models[name]
        context = len(prompt) + ENGINE_TOKENS // 2
        for row in engine_rates(LmEngine, params, c, prompt,
                                MOE_RATE_STREAMS):
            # MFU on the reference's count (lm_flops_per_token: the
            # top_k experts a token is routed to, not the dense
            # formulation's n_experts / top_k times that FFN work)
            row["mfu_reference_count"] = (
                row["tokens_per_s"] * tfm.lm_flops_per_token(c, context)
                / BF16_FLOPS_PER_S)
            phase(16, "moe_engine_rate", model=name, weights="bfloat16",
                  **row, **card)
    for name in ("dense", "moe"):
        params, c = models[name]
        replay_ms = decode_replay_ms(LmEngine, params, c,
                                     context=DECODE_CONTEXT)
        profile = engine_profile(LmEngine, params, c, prompt)
        phase(16, "moe_engine_profile", model=name, weights="bfloat16",
              lanes=8, context=DECODE_CONTEXT, decode_replay_ms=replay_ms,
              **decode_bound(params, c),
              ffn_flops_factor=flops_factor if name == "moe" else 1.0,
              **profile, **card)
    phase(16, "moe_done", seconds=time.monotonic() - t_phase)
    return counted


# -- the builtin model set (phase 17) -----------------------------------------


def builtin_phase(card):
    """Phase 17: the builtin set behind Server() (its default models, the
    tiny vision pipeline on the card) over HTTP: simple, simple_sequence,
    the classification extension on classifier.  The launch counts reset
    before the server starts and read after: this path launches none of
    the hand-written kernels."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve import Server

    t0 = time.monotonic()
    ops.reset_launches()
    with Server(http_port=0) as server:
        addr = server.http_address
        _, body, _ = http(addr, "/v2")
        extensions = json.loads(body)["extensions"]
        check("classification" in extensions and "sequence" in extensions,
              f"server extensions {extensions}")
        a = np.arange(16, dtype=np.int32)
        b = np.full(16, 3, np.int32)
        _, body, _ = http(addr, "/v2/models/simple/infer", json.dumps({
            "inputs": [{"name": n, "shape": [1, 16], "datatype": "INT32",
                        "data": x.tolist()}
                       for n, x in (("INPUT0", a), ("INPUT1", b))]}).encode())
        out = {o["name"]: o["data"] for o in json.loads(body)["outputs"]}
        check(out == {"OUTPUT0": (a + b).tolist(),
                      "OUTPUT1": (a - b).tolist()}, f"simple answered {out}")
        steps = ((10, 42, {"sequence_start": True}), (5, 42, {}),
                 (100, 43, {"sequence_start": True}),
                 (1, 42, {"sequence_end": True}),
                 (2, 42, {"sequence_start": True}))
        sums = []
        for value, seq, extra in steps:
            _, body, _ = http(addr, "/v2/models/simple_sequence/infer",
                              json.dumps({
                                  "inputs": [{"name": "INPUT", "shape": [1],
                                              "datatype": "INT32",
                                              "data": [value]}],
                                  "parameters": {"sequence_id": seq,
                                                 **extra}}).encode())
            sums.append(json.loads(body)["outputs"][0]["data"][0])
        check(sums == [10, 15, 100, 16, 2], f"simple_sequence sums {sums}")
        _, body, _ = http(addr, "/v2/models/classifier/infer", json.dumps({
            "inputs": [{"name": "INPUT0", "shape": [1, 4],
                        "datatype": "FP32", "data": [0.1, 3.0, 0.5, 1.0]}],
            "outputs": [{"name": "OUTPUT0",
                         "parameters": {"classification": 2}}]}).encode())
        top = json.loads(body)["outputs"][0]
        check(top["datatype"] == "BYTES" and top["shape"] == [1, 2]
              and top["data"][0].split(":")[1:] == ["1", "dog"],
              f"classifier answered {top}")
        durable = []
        for value, step in ((1, 1), (4, 2), (4, 2)):
            _, body, _ = http(addr, "/v2/models/simple_sequence/infer",
                              json.dumps({
                                  "inputs": [{"name": "INPUT", "shape": [1],
                                              "datatype": "INT32",
                                              "data": [value]}],
                                  "parameters": {
                                      "sequence_id": 44,
                                      "sequence_start": step == 1,
                                      "sequence_durable": True,
                                      "sequence_step": step}}).encode())
            durable.append(json.loads(body)["outputs"][0]["data"][0])
        # no tier: durable state kept locally, the repeated step replayed
        check(durable == [1, 5, 5], f"durable sequence sums {durable}")
        images = np.random.default_rng(17).integers(
            0, 256, (2, 32, 32, 3)).astype(np.uint8)
        _, body, _ = http(addr, "/v2/models/vision_pipeline/infer",
                          json.dumps({"inputs": [{
                              "name": "IMAGE", "shape": [2, 32, 32, 3],
                              "datatype": "UINT8",
                              "data": images.ravel().tolist()}]}).encode())
        scores = json.loads(body)["outputs"][0]
        rows = np.array(scores["data"], np.float32).reshape(scores["shape"])
        check(scores["shape"] == [2, 16]
              and np.allclose(rows.sum(axis=1), 1.0, atol=1e-3),
              f"vision_pipeline answered {scores['shape']}")
        models = [m["name"] for m in server.engine.repository_index()]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"the builtin path launched a hand-written kernel: {launches}")
    phase(17, "builtin", models=models, simple=out, sequence_sums=sums,
          classification=top["data"], durable_sums=durable,
          vision_pipeline_shape=scores["shape"], launches=launches,
          seconds=time.monotonic() - t0, **card)



# -- the fleet tier (phase 18) ------------------------------------------------

# a fleet stream's tokens; the shared prefixes of phase 18's prompts: on the
# engine's 64-token chunk boundaries, and off them (240 is where a peer's
# chain ends for a 256-token prompt: (256 - 1) // 16 full blocks)
FLEET_TOKENS = 16
FLEET_PROMPT_LEN = 256
FLEET_PREFIXES = ((64, 128, 192), (80, 176, 240))
FLEET_TIMED = 8  # prompts a TTFT run: 1 stream each in turn, then 8 at once


def fleet_prompts(seed=12):
    """Phase 18's 16 prompts of 256 tokens, in serving order: for each
    prefix set of FLEET_PREFIXES, 8 prompts in three groups, a group's
    prompts sharing that group's prefix, each with a tail of its own."""
    rng = np.random.default_rng(seed)
    out = []
    for lengths in FLEET_PREFIXES:
        bases = [rng.integers(0, 256, n).tolist() for n in lengths]
        for i in range(8):
            base = bases[i % 3]
            out.append(base + rng.integers(
                0, 256, FLEET_PROMPT_LEN - len(base)).tolist())
    return out


def timed(obj, name, sink):
    """Wrap ``obj.name`` so every call appends its host ms to *sink*."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, wrapper)


def fleet_pair(LmEngine, FleetTier, params, cfg, a_kw=None, b_kw=None):
    """Two replicas in this process: engines A and B at ENGINE_KW, each on
    a started FleetTier bound to loopback, the tiers peered."""
    from client_tpu_torch.serve.metrics import Registry

    tiers = [FleetTier(gossip_interval_s=0).start() for _ in range(2)]
    tiers[0].set_peers([tiers[1].address])
    tiers[1].set_peers([tiers[0].address])
    engines = [LmEngine(params, cfg, device="cuda", fleet=tier,
                        registry=Registry(), **{**ENGINE_KW, **kw})
               for tier, kw in zip(tiers, (a_kw or {}, b_kw or {}))]
    return engines, tiers


def close_pair(engines, tiers, label):
    for eng in engines:
        eng.close()
    for tier in tiers:
        tier.close()
    for eng in engines:
        if eng.kv is None:  # never started
            continue
        check(eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {},
              f"{label}: KV audit after close: {eng.kv.used_blocks} blocks "
              f"used, refs {eng.kv.ref_counts()}")


def serve_each(eng, prompts, n, LmEngine):
    """Serve *prompts* one at a time (every decode tick at one lane of the
    same lane count on either replica); returns the streams and, for each,
    where its prefill started: the blocks it adopted from the local trie
    and installed from the peer, in tokens."""
    got, starts = [], []
    for p in prompts:
        hits = eng.prefix_stats().get("hits", 0)
        remote = eng.fleet_stats()["remote_blocks"]
        got.append(collect(eng.submit(p, n)[0], LmEngine.CLOSE))
        starts.append(eng.block_size * (
            eng.prefix_stats()["hits"] - hits
            + eng.fleet_stats()["remote_blocks"] - remote))
    return got, starts


def fleet_streams(LmEngine, FleetTier, tfm, name, params, cfg, prompts):
    """A serves the prompts, then B: B installs A's exported blocks and
    its graph-captured prefill starts past them.  float32: B's streams
    equal serial generate.  bf16 and int8: B's stream equals A's where B's
    prefill ran chunks A's prefill ran too (the same plan from B's start,
    over the same installed KV); elsewhere the NEAR_TIE rule against A's."""
    from client_tpu_torch.serve.lm.policy import chunk_plan

    (eng_a, eng_b), tiers = fleet_pair(LmEngine, FleetTier, params, cfg)
    fetch_ms, install_ms, export_ms = [], [], []
    timed(tiers[1], "prefix_lookup", fetch_ms)
    timed(eng_b, "_install_remote", install_ms)
    timed(eng_a, "_export_prefix", export_ms)
    try:
        got_a, starts_a = serve_each(eng_a, prompts, FLEET_TOKENS, LmEngine)
        got_b, starts_b = serve_each(eng_b, prompts, FLEET_TOKENS, LmEngine)
        fleet_b = eng_b.fleet_stats()
        saved = eng_b.registry.get("ctpu_fleet_prefix_tokens_saved_total")
        store_blocks = tiers[0].stats()["store_blocks"]
        buckets = eng_b.buckets
    finally:
        close_pair((eng_a, eng_b), tiers, f"fleet {name}")
    check(fleet_b["remote_blocks"] > 0 and (saved or 0) > 0,
          f"{name}: B installed no block from A: {fleet_b}, saved {saved}")
    equal, near = 0, []
    for p, a, b, sa, sb in zip(prompts, got_a, got_b, starts_a, starts_b):
        if name == "float32":
            want = list(tfm.generate(params, cfg, p, FLEET_TOKENS,
                                     readback_depth=0))
            check(a == want and b == want,
                  f"float32 fleet streams from {sa}/{sb}: A {a}, B {b}, "
                  f"serial {want}")
            equal += 1
            continue
        plan_a = chunk_plan(len(p), buckets, start=sa)
        plan_b = chunk_plan(len(p), buckets, start=sb)
        if plan_a[-len(plan_b):] == plan_b:
            check(b == a, f"{name}: B's stream from {sb} ran A's chunks "
                          f"{plan_b} over A's KV but differs: {b} != {a}")
            equal += 1
        else:
            verdict = agreement(tfm, params, cfg, p, b, a)
            equal += verdict["equal"]
            near.append(dict(verdict, start_a=sa, start_b=sb))
    return {"streams": len(prompts), "equal_streams": equal,
            "near_tie_held": near, "starts_a": starts_a,
            "starts_b": starts_b, "remote": fleet_b,
            "prefix_tokens_saved": saved, "store_blocks_a": store_blocks,
            "fetch_host_ms": fetch_ms, "install_ms": install_ms,
            "export_host_ms": export_ms}


def fleet_migration(LmEngine, FleetTier, tfm, p32, cfg32):
    """B parks a stream by preemption ('lo' holds 25 of B's 32 blocks when
    'hi' asks for 19) and drain()s; A resumes prompt + delivered tokens,
    its prefill from B's exported swap chain (the 40-token prompt's two
    full blocks at least), byte-exact against serial generate
    (float32)."""
    (eng_a, eng_b), tiers = fleet_pair(
        LmEngine, FleetTier, p32, cfg32,
        b_kw={"pool_tokens": 512, "tenant_priority": {"hi": 10.0}})
    prompt = [256] + np.random.default_rng(19).integers(0, 256, 39).tolist()
    n = 360
    try:
        q_lo, _ = eng_b.submit(prompt, n, tenant="lo")
        first = q_lo.get(timeout=300)
        q_hi, _ = eng_b.submit([256, 7], 300, tenant="hi")
        deadline = time.monotonic() + 120
        while (eng_b.preempt_stats()["swapped_streams"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.002)
        check(eng_b.preempt_stats()["swapped_streams"] == 1,
              f"no parked stream on B: {eng_b.preempt_stats()}")
        migrated = eng_b.drain()
        delivered = [first] + collect(q_lo, LmEngine.CLOSE)
        collect(q_hi, LmEngine.CLOSE)
        check(migrated == 1, f"drain migrated {migrated} streams")
        sessions = eng_b.registry.get("ctpu_fleet_sessions_migrated_total")
        rest = collect(eng_a.submit(prompt + delivered,
                                    n - len(delivered))[0], LmEngine.CLOSE)
        resumed = eng_a.fleet_stats()
    finally:
        close_pair((eng_a, eng_b), tiers, "fleet migration")
    want = list(tfm.generate(p32, cfg32, prompt, n, readback_depth=0))
    check(delivered + rest == want,
          f"migrated stream ({len(delivered)} delivered on B) differs from "
          f"serial generate")
    check(resumed["remote_blocks"] > 0,
          f"A's resumed prefill installed no block: {resumed}")
    return {"delivered_on_b": len(delivered), "resumed_on_a": len(rest),
            "tokens": n, "equal_to_serial": True, "migrated": migrated,
            "sessions_migrated_metric": sessions, "remote_on_a": resumed}


def ttft_runs(eng, singles, together, LmEngine):
    """TTFT of each of *singles* alone, in turn, then of *together* all at
    once (host clock from submit to the first token)."""
    single = []
    for p in singles:
        t0 = time.monotonic()
        q, _ = eng.submit(p, FLEET_TOKENS)
        q.get(timeout=300)
        single.append((time.monotonic() - t0) * 1e3)
        collect(q, LmEngine.CLOSE)
    firsts = [None] * len(together)
    t0 = time.monotonic()
    qs = [eng.submit(p, FLEET_TOKENS)[0] for p in together]

    def drain(i):
        qs[i].get(timeout=300)
        firsts[i] = (time.monotonic() - t0) * 1e3
        collect(qs[i], LmEngine.CLOSE)

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(together))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return single, firsts


def fleet_ttft(LmEngine, FleetTier, pbf, cfg):
    """bf16: B's TTFT with the tier (its prefill from A's exported blocks)
    against an engine without a tier, on 256-token prompts A served, in
    turns without, with, with, without, every turn on prompts neither
    engine has seen: 4 one at a time, then 8 at once.  The prefill step's
    host ms with the tier attached (A, which exports) and without."""
    rng = np.random.default_rng(18)
    turns = [(label, [[256] + rng.integers(
        0, 256, FLEET_PROMPT_LEN - 1).tolist() for _ in range(4 + 8)])
        for label in ("without", "with", "with", "without")]
    (eng_a, eng_b), tiers = fleet_pair(LmEngine, FleetTier, pbf, cfg)
    plain = LmEngine(pbf, cfg, device="cuda", **ENGINE_KW)
    with_tier, without_tier, fetch_ms, install_ms = [], [], [], []
    timed(eng_a, "_prefill_step", with_tier)
    timed(plain, "_prefill_step", without_tier)
    timed(tiers[1], "prefix_lookup", fetch_ms)
    timed(eng_b, "_install_remote", install_ms)
    rows = []
    try:
        for eng in (eng_a, eng_b, plain):  # capture every graph first
            collect(eng.submit([256, 9, 9], 4)[0], LmEngine.CLOSE)
        for _, prompts in turns:
            for p in prompts:
                collect(eng_a.submit(p, 1)[0], LmEngine.CLOSE)
        for label, prompts in turns:
            eng = eng_b if label == "with" else plain
            single, together = ttft_runs(eng, prompts[:4], prompts[4:],
                                         LmEngine)
            rows.append({"tier": label,
                         "ttft_ms_1_stream": single,
                         "ttft_ms_1_stream_mean": float(np.mean(single)),
                         "ttft_ms_8_streams_mean": float(np.mean(together)),
                         "ttft_ms_8_streams_max": max(together)})
        remote = eng_b.fleet_stats()
    finally:
        plain.close()
        close_pair((eng_a, eng_b), tiers, "fleet ttft")
    check(plain.kv.used_blocks == 0 and plain.kv.ref_counts() == {},
          "fleet ttft: KV audit of the engine without a tier")
    check(remote["remote_blocks"] == 2 * 12 * 15,
          f"the timed prefills did not install A's chains: {remote}")
    return rows, {"prefill_step_host_ms_with_tier": float(
                      np.mean(with_tier)),
                  "prefill_step_host_ms_without_tier": float(
                      np.mean(without_tier)),
                  "fetch_host_ms_15_blocks": float(np.mean(fetch_ms)),
                  "install_ms_15_blocks": float(np.mean(install_ms))}


def fleet_wire(FleetTier, pbf, cfg):
    """Bytes of one bf16 block on the wire, raw and in the JSON frame a
    15-block fetch answers with (base64)."""
    kv = [torch.randn((15, 16, cfg.n_kv_heads, cfg.d_model // cfg.n_heads),
                      generator=torch.Generator().manual_seed(i))
          .to(torch.bfloat16) for i in range(cfg.n_layers)]
    tier = FleetTier(gossip_interval_s=0)
    row = list(range(FLEET_PROMPT_LEN))
    tier.export_prefix(row, 15, 16, kv, kv)
    reply = tier._handle_prefix_get({"tokens": row, "block_size": 16,
                                     "max_blocks": 15, "start": 0})
    raw = 2 * sum(t[0].numel() * t.element_size() for t in kv)
    return {"block_bytes_raw": raw,
            "frame_bytes_15_blocks": len(json.dumps(reply)),
            "frame_bytes_a_block": len(json.dumps(reply)) / 15}


def fleet_phase(card, p32, cfg32, pbf, cfg, p8):
    """Phase 18: two replicas in this process on the one card, each an
    LmEngine with graphs on a FleetTier bound to loopback, peered: the
    prefix tier in float32, bf16 and int8 (16 prompts of 256 tokens, A
    then B), parked-stream migration, then the costs: bytes a block on
    the wire, the peer RPC's host ms a fetch, the install's ms, the
    export's host ms a prefill, B's TTFT with the tier against without.
    The launch counts reset before the prefix-tier and migration runs and
    read after them: int8 (the int8 run) and paged attention."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.fleet import FleetTier
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import transformer as tfm

    t0 = time.monotonic()
    prompts = fleet_prompts()
    ops.reset_launches()
    report = {name: fleet_streams(LmEngine, FleetTier, tfm, name, params, c,
                                  prompts)
              for name, params, c in (("float32", p32, cfg32),
                                      ("bfloat16", pbf, cfg),
                                      ("int8", p8, cfg))}
    migration = fleet_migration(LmEngine, FleetTier, tfm, p32, cfg32)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    routes = {name: dict(r) for name, r in ops.ROUTES.items()}
    for name in ("int8_matmul", "paged_attention"):
        check(launches[name] > 0,
              f"the fleet phase launched {name} no time")
    for name, r in report.items():
        for key in ("fetch_host_ms", "install_ms", "export_host_ms"):
            ms = r.pop(key)
            r[key] = {"n": len(ms), "mean": float(np.mean(ms)) if ms else None,
                      "max": max(ms) if ms else None}
    phase(18, "fleet_prefix_tier", config="DEFAULT_LM_CONFIG",
          engine=ENGINE_KW, prompt_tokens=FLEET_PROMPT_LEN,
          shared_prefixes=FLEET_PREFIXES, tokens=FLEET_TOKENS,
          near_tie=NEAR_TIE, kv_audit_after_close="clean", **report, **card)
    phase(18, "fleet_migration", kv_audit_after_close="clean", **migration,
          launches=launches, launches_by_route=routes, **card)
    rows, host = fleet_ttft(LmEngine, FleetTier, pbf, cfg)
    for row in rows:
        phase(18, "fleet_ttft", weights="bfloat16", prompt_tokens=
              FLEET_PROMPT_LEN, **row, **card)
    phase(18, "fleet_costs", weights="bfloat16", **fleet_wire(
              FleetTier, pbf, cfg), **host,
          seconds=time.monotonic() - t0, **card)
    return launches, routes


# -- several devices (phase 19) ---------------------------------------------

# 19a: the flagship training config on a one-rank mesh (every dim 1),
# attn_impl="ring_flash", against phase 8's single-device flash steps from
# the same weights and tokens, TRAIN_LR, this many Adam steps
RING_STEPS = 3
# stated tolerance, 19a's updated params (bf16) against the flash steps':
# none.  On one rank the ring's merge is exact (its lse cotangent is
# exactly 0 and its weights exp(0) = 1), so the ring_flash step runs the
# flash step's kernels on the same bf16 inputs and gives its gradients bit
# for bit; an H100 80GB HBM3 (700 W) read 0.0 in every run
RING_PARAM_ATOL = 0.0
# 19a's GPipe step: microbatches a step (on the one-rank mesh, pp = 1: one
# stage, which is also the last; the schedule's loop runs once, at the
# capture)
PIPE_MICROBATCHES = 2
# 19b: ring_attention_sharded(impl="flash") on make_mesh(sp=2) over two
# gloo ranks on the one card, at the flagship's attention shape [B, T, H,
# D], causal (shards of 256 tokens, which tile the kernels' blocks); held
# against one-rank flash_attention within phase 7's bf16 tolerance (TOL).
# Phase 7 holds the kernels against their plain versions at this shard's
# shape, causal (the diagonal step) and not (the past step).
RING_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 8, 64)
RING_SEED = 19
RING_TIMED = 10  # timed forward+backward steps a rank, after one warm-up


def ring_inputs(device):
    """19b's q, k, v and output cotangent, bf16, from RING_SEED (the same
    on every rank and in the parent)."""
    gen = torch.Generator().manual_seed(RING_SEED)
    return [torch.randn(RING_SHAPE, generator=gen).to(device, torch.bfloat16)
            for _ in range(4)]


def ring_rank(rank, n, out_path):
    """One rank of phase 19b: its sequence shard of ring_inputs, as a
    DTensor on make_mesh(sp=2) over the world's gloo group, through
    ring_attention_sharded(impl="flash"), forward and backward; writes its
    shard's out and gradients, its launch counts, the largest |lse
    cotangent| the flash backward took, the bytes staged through host
    memory and the ms a step."""
    import pickle

    from torch.distributed.tensor import DTensor

    from client_tpu_torch import ops, parallel
    from client_tpu_torch.ops import _build
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import collectives
    from client_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded,
    )

    _build.kernels()  # the parent built it: this loads it
    mesh = parallel.make_mesh(sp=n)
    layout = parallel.placements(mesh, parallel.P("dp", "sp", "tp", None))
    q, k, v, g = ring_inputs("cuda")
    t = RING_SHAPE[1] // n
    shard = slice(rank * t, (rank + 1) * t)
    g = g[:, shard].contiguous()
    g_lse_max = []
    backward = fa._fa_backward

    def recorded(*args):  # args[6] is the lse cotangent
        g_lse_max.append(args[6].abs().max().item())
        return backward(*args)

    def step():
        ql, kl, vl = (x[:, shard].clone().requires_grad_()
                      for x in (q, k, v))
        dq, dk, dv = (DTensor.from_local(x, mesh, layout, run_check=False,
                                         shape=q.shape, stride=q.stride())
                      for x in (ql, kl, vl))
        out = ring_attention_sharded(dq, dk, dv, mesh, causal=True,
                                     impl="flash").to_local()
        out.backward(g)
        return out, ql.grad, kl.grad, vl.grad

    fa._fa_backward = recorded
    try:
        ops.reset_launches()
        collectives.reset_stats()
        out, dq, dk, dv = step()
        torch.cuda.synchronize()
        launches, stats = dict(ops.LAUNCHES), dict(collectives.STATS)
    finally:
        fa._fa_backward = backward
    step()  # warm
    torch.cuda.synchronize()
    torch.distributed.barrier()
    collectives.reset_stats()
    t0 = time.perf_counter()
    for _ in range(RING_TIMED):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / RING_TIMED
    timed_stats = dict(collectives.STATS)
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump({
            "shard": [shard.start, shard.stop],
            **{name: x.detach().float().cpu().numpy() for name, x in
               (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))},
            "launches": launches, "permutes": stats["ppermute"],
            "bytes_staged_per_step": timed_stats["bytes_staged"] / RING_TIMED,
            "g_lse_max_abs": max(g_lse_max), "ms_per_step": ms}, f)


def ring_vs_one_rank(world_out, n):
    """19b's shards against one-rank flash_attention on the same inputs:
    {name: max abs err}, each within TOL[bf16]."""
    import pickle

    from client_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, g = ring_inputs("cuda")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v)
    out.backward(g)
    want = {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    atol, rtol = TOL[torch.bfloat16]
    errs, ranks = {}, []
    for rank in range(n):
        with open(f"{world_out}.{rank}", "rb") as f:
            got = pickle.load(f)
        shard = slice(*got["shard"])
        for name, ref in want.items():
            ref = ref[:, shard].detach().float().cpu().numpy()
            err = np.abs(got[name] - ref)
            check(bool((err <= atol + rtol * np.abs(ref)).all()),
                  f"phase 19b rank {rank}: {name} differs from one-rank "
                  f"flash_attention by {err.max()} (atol {atol}, rtol "
                  f"{rtol})")
            errs[name] = max(errs.get(name, 0.0), float(err.max()))
        ranks.append({k: got[k] for k in (
            "launches", "permutes", "bytes_staged_per_step",
            "g_lse_max_abs", "ms_per_step")})
    return errs, ranks


def mesh_legs(tfm, mesh):
    """Phase 19a's three mesh steps on ``mesh``, through the port's entry
    points at TRAIN_LR: {name: (cfg, make, fresh)}, ``make(eager)`` giving
    (opt, step) and ``fresh()`` the config's weights from seed 0 laid out
    on the mesh as the step takes them (DTensors): ring_flash on the
    flagship, ring_flash on MOE, and the GPipe step on the flagship's
    pipeline stages (PIPE_MICROBATCHES a step)."""
    from client_tpu_torch import parallel

    dense = tfm.TransformerConfig(**FLAGSHIP)
    moe = tfm.TransformerConfig(**MOE)
    stages = mesh.size(parallel.AXES.index("pp"))

    def laid(cfg, pipeline=False):
        def fresh():
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cuda")
            if pipeline:
                params = tfm.stack_pipeline_params(params, stages)
                specs = tfm.pipeline_param_specs(params)
            else:
                specs = parallel.param_specs(cfg)
            return parallel.device_put(
                params, parallel.named_shardings(mesh, specs))
        return fresh

    return {
        "ring_flash": (dense, lambda eager: tfm.make_train_step(
            dense, "ring_flash", TRAIN_LR, mesh=mesh, eager=eager),
            laid(dense)),
        "moe_ring_flash": (moe, lambda eager: tfm.make_train_step(
            moe, "ring_flash", TRAIN_LR, mesh=mesh, eager=eager),
            laid(moe)),
        "gpipe": (dense, lambda eager: tfm.make_pipeline_train_step(
            dense, mesh, PIPE_MICROBATCHES, TRAIN_LR, eager=eager),
            laid(dense, pipeline=True)),
    }


def one_device(tfm, cfg, impl):
    """(make, fresh) of the single-device step with ``impl`` at TRAIN_LR,
    from the same seed as mesh_legs' weights."""
    return (lambda eager: tfm.make_train_step(cfg, impl, TRAIN_LR,
                                              eager=eager),
            lambda: tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                    "cuda"))


def run_steps(make, params, tokens, steps, eager=False):
    """``steps`` steps of ``make(eager)``'s step from ``params``; returns
    (params, opt_state, losses, step)."""
    opt, step = make(eager)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return params, state, losses, step


def mesh_graph_vs_eager(tfm, name, cfg, make, fresh, tokens):
    """RING_STEPS steps of a mesh step as one CUDA graph (the first call
    eager, the second the capture, then replays), the launch counts reset
    before and read after, against RING_STEPS eager steps from the same
    weights: losses and every param bit-equal.  Returns the graphed
    params and the record."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.models.programs import TrainProgram

    ops.reset_launches()
    params, _, losses, step = run_steps(make, fresh(), tokens, RING_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    program = step.program
    check(isinstance(program, TrainProgram),
          f"19a {name}: the step on the NCCL mesh is not a program "
          f"({program!r})")
    replay = {n: c for (n, _), c in program.launches.items()}
    flash = cfg.n_layers if name != "gpipe" else 0
    want = {n: flash for n in FLASH_KERNELS} if flash else {}
    check(replay == want,
          f"19a {name}: one replay launches {replay}, expected {want}")
    per_step = {n: c / RING_STEPS for n, c in launches.items()}
    check(per_step == {"int8_matmul": 0, "paged_attention": 0,
                       **{n: flash for n in FLASH_KERNELS}},
          f"19a {name}: {RING_STEPS} steps launched {launches}, expected "
          f"{flash} of each flash kernel a step")
    eager_params, _, eager_losses, eager_step = run_steps(
        make, fresh(), tokens, RING_STEPS, eager=True)
    check(eager_step.program is None, f"19a {name}: eager=True made a "
          f"program")
    check(losses == eager_losses and all(np.isfinite(losses)),
          f"19a {name}: graphed losses {losses} against eager "
          f"{eager_losses}")
    differ = [i for i, (a, b) in enumerate(zip(
        tfm._leaves(params), tfm._leaves(eager_params)))
        if not torch.equal(a.to_local(), b.to_local())]
    check(not differ, f"19a {name}: graphed params differ from eager at "
          f"leaves {differ}")
    return params, {"graph_losses": losses, "eager_losses": eager_losses,
                    "params_bit_equal": True, "launches": launches,
                    "launches_per_step": per_step,
                    "launches_per_replay": replay,
                    "capture_s": program.capture_s}


def mesh_step_time(make, fresh, tokens, eager, steps=10, warmup=2):
    """Train-step wall time (host clock around synchronized steps) of
    ``make(eager)``'s step from ``fresh()`` weights after ``warmup``
    steps (for the graph: the eager first step and the capture), with the
    capture's seconds, the memory the step holds (step_time's
    accounting: the graph's pool included) and what the allocator
    reserves after."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params, state, _, step = run_steps(make, fresh(), tokens, warmup, eager)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    held, pool_mb, peak = held_memory(before, step.program)
    return {"graph": step.program is not None, "ms_per_step": ms,
            "capture_s": step.program.capture_s if step.program else None,
            "held_mb": held, "graph_pool_mb": pool_mb,
            "peak_mb": peak / 2**20,
            "reserved_mb": torch.cuda.memory_reserved() / 2**20,
            "steps": steps, "last_loss": float(loss)}


def nccl_capture_probe(ops, collectives):
    """Phase 19a's probe on the one-rank NCCL world: the mesh layer's two
    collectives (``collectives._all_reduce``, a ``dist.all_reduce``, and
    ``collectives._sendrecv``, a ``dist.batch_isend_irecv`` pair, here to
    rank 0 itself) each run eagerly on one input, then captured through
    ``ops.capture_graph`` on a buffer holding another, the buffer set to
    the first and the graph replayed: its output against the eager
    call's.  {name: {"captured", "equal", "error"}}; a refusal is the
    probe's finding and is recorded, not raised."""
    import torch.distributed as dist

    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(RING_SEED)
    x, other = (torch.randn((TRAIN_BATCH, 1 << 16), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2))
    probes = {
        "all_reduce": lambda buf: collectives._all_reduce(
            [buf], (group,))[0],
        "batch_isend_irecv": lambda buf: collectives._sendrecv(
            buf, group, 1),
    }
    out = {}
    for name, op in probes.items():
        want = op(x)
        torch.cuda.synchronize()
        buf, box = other.clone(), {}
        rec = {"captured": False, "equal": None, "error": None}
        try:
            graph = ops.capture_graph(lambda: box.update(y=op(buf)), None,
                                      None, torch.cuda.Stream())
            rec["captured"] = True
            buf.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            rec["equal"] = torch.equal(box["y"], want)
        except Exception as e:  # noqa: BLE001 -- the refusal is recorded
            cause = e.__context__
            rec["error"] = (f"{type(e).__name__}: {e}"
                            + (f" (during {type(cause).__name__}: {cause})"
                               if cause is not None else ""))[:3000]
        out[name] = rec
    return out


def parallel_phase(card, tokens):
    """Phase 19: (a) on a one-rank NCCL mesh, the mesh train steps as CUDA
    graphs (ring_flash on the flagship and on MOE, the GPipe step) against
    their eager steps, ring_flash against the single-device flash steps
    and GPipe against the plain ones, their times graphed and eager, and
    the NCCL capture probe; (b) a two-rank ring of the flash kernels on
    this one card over gloo.  Returns the launch counts (19a's graphed
    ring_flash run, each 19b rank's) and the phase's seconds."""
    import torch.distributed as dist

    from client_tpu_torch import ops, parallel
    from client_tpu_torch.ops import _build
    from client_tpu_torch.parallel import collectives
    from client_tpu_torch.serve.models import programs
    from client_tpu_torch.serve.models import transformer as tfm

    t_phase = time.monotonic()
    cfg = tfm.TransformerConfig(**FLAGSHIP)
    _build.kernels()
    # -- 19a: one rank, NCCL, every mesh dim 1 --------------------------
    store = dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True)
    backend = parallel.init_world(0, 1, store, device="cuda")
    try:
        check(backend == "nccl", f"19a's one-rank world took {backend}")
        mesh = parallel.make_mesh()
        check(tuple(mesh.shape) == (1,) * 5
              and mesh.mesh_dim_names == parallel.AXES,
              f"make_mesh() gave {mesh}")
        check(programs.graphable(mesh), "19a's NCCL mesh is not graphable")
        legs = mesh_legs(tfm, mesh)
        flash_make, flash_fresh = one_device(tfm, cfg, "flash")
        flat, _, flash_losses, _ = run_steps(flash_make, flash_fresh(),
                                             tokens, RING_STEPS)
        records = {}
        for name, (lcfg, make, fresh) in legs.items():
            params, records[name] = mesh_graph_vs_eager(
                tfm, name, lcfg, make, fresh, tokens)
            if name == "ring_flash":
                ring_launches = records[name]["launches"]
                ring_losses = records[name]["graph_losses"]
                param_err = max(
                    (a.full_tensor().float() - b.float()).abs().max().item()
                    for a, b in zip(tfm._leaves(params), tfm._leaves(flat)))
                check(param_err <= RING_PARAM_ATOL,
                      f"ring_flash params differ from flash's by "
                      f"{param_err} > {RING_PARAM_ATOL}")
            del params
        del flat
        diffs = [abs(a - b) for a, b in zip(ring_losses, flash_losses)]
        check(all(np.isfinite(ring_losses)) and diffs[0] <= TRAIN_LOSS0_ATOL
              and max(diffs) <= TRAIN_LOSS_STEP_ATOL
              and diffs[-1] <= TRAIN_LOSS_LAST_ATOL,
              f"ring_flash losses {ring_losses} against flash "
              f"{flash_losses}")
        plain_make, plain_fresh = one_device(tfm, cfg, "plain")
        _, _, plain_losses, _ = run_steps(plain_make, plain_fresh(), tokens,
                                          RING_STEPS)
        pipe_losses = records["gpipe"]["graph_losses"]
        pipe_diffs = [abs(a - b) for a, b in zip(pipe_losses, plain_losses)]
        check(pipe_diffs[0] <= TRAIN_LOSS0_ATOL
              and max(pipe_diffs) <= TRAIN_LOSS_STEP_ATOL
              and pipe_diffs[-1] <= TRAIN_LOSS_LAST_ATOL,
              f"GPipe losses {pipe_losses} against single-device plain "
              f"{plain_losses}")
        limits = {"first": TRAIN_LOSS0_ATOL, "any": TRAIN_LOSS_STEP_ATOL,
                  "last": TRAIN_LOSS_LAST_ATOL}
        phase(19, "mesh_ring_flash", config=FLAGSHIP, dtype=cfg.dtype,
              mesh={n: 1 for n in parallel.AXES}, backend=backend,
              tokens=list(tokens.shape), steps=RING_STEPS, lr=TRAIN_LR,
              **records["ring_flash"], ring_flash_losses=ring_losses,
              flash_losses=flash_losses, loss_diffs=diffs,
              loss_atol=limits, param_max_abs_err=param_err,
              param_atol=RING_PARAM_ATOL, **card)
        phase(19, "mesh_moe_ring_flash", config=MOE, steps=RING_STEPS,
              **records["moe_ring_flash"], **card)
        phase(19, "mesh_gpipe", config=FLAGSHIP, stages=1,
              microbatches=PIPE_MICROBATCHES, steps=RING_STEPS,
              **records["gpipe"], plain_losses=plain_losses,
              loss_diffs=pipe_diffs, loss_atol=limits, **card)
        # graphed and eager in turns; ring_flash between two legs of the
        # graphed single-device flash step, which runs the same kernels
        for name, (_, make, fresh) in legs.items():
            turns = [(True, make, fresh, eager)
                     for eager in (False, True, True, False)]
            if name == "ring_flash":
                flash = (False, flash_make, flash_fresh, False)
                turns = [flash, *turns, flash]
            times = [{"mesh": on_mesh, **mesh_step_time(m, f, tokens, e)}
                     for on_mesh, m, f, e in turns]
            phase(19, "mesh_step_times", step=name, in_turns=times, **card)
        probe = nccl_capture_probe(ops, collectives)
        for name, rec in probe.items():
            check(rec["equal"] is not False,
                  f"19a's captured {name} replayed to another result than "
                  f"its eager call")
        phase(19, "nccl_capture_probe", backend=backend, world=1,
              probes=probe, **card)
    finally:
        dist.destroy_process_group()
    # -- 19b: two gloo ranks on this card -------------------------------
    t0 = time.monotonic()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        world_out = os.path.join(d, "ring")
        parallel.spawn_world("chip_smoke:ring_rank", 2, args=(world_out,),
                             device="cuda", backend="gloo", timeout_s=300)
        world_s = time.monotonic() - t0
        errs, ranks = ring_vs_one_rank(world_out, 2)
    for r, got in enumerate(ranks):
        for name in FLASH_KERNELS:
            check(got["launches"][name] > 0,
                  f"phase 19b rank {r} launched {name} no time")
        check(got["bytes_staged_per_step"] > 0,
              f"phase 19b rank {r} staged nothing through host memory")
    g_lse = max(got["g_lse_max_abs"] for got in ranks)
    check(g_lse > 0, "phase 19b: every lse cotangent was 0")
    phase(19, "two_rank_ring_flash", shape=list(RING_SHAPE),
          dtype="bfloat16", causal=True, sp=2, backend="gloo",
          shard_tokens=RING_SHAPE[1] // 2, max_abs_err=errs,
          tolerance=TOL[torch.bfloat16], g_lse_max_abs=g_lse, ranks=ranks,
          world_seconds=world_s, **card)
    seconds = time.monotonic() - t_phase
    phase(19, "parallel_done", seconds=seconds)
    return ring_launches, [got["launches"] for got in ranks], seconds


# the static analyser's torch fixtures and the rule each is about, by
# its name's prefix (tests/test_torch_analysis.py holds the same set)
ANALYSIS_FIXTURES = os.path.join("tests", "analysis_fixtures", "torch")
ANALYSIS_RULES = {
    "lock_dispatch_": "LOCK-DISPATCH",
    "jit_unbounded_shape_": "JIT-UNBOUNDED-SHAPE",
    "npy_truth_": "NPY-TRUTH",
    "async_block_": "ASYNC-BLOCK",
    "block_under_lock_": "BLOCK-UNDER-LOCK",
}


def analysis_phase(card):
    """Phase 28: the port's static analyser over its own tree and its
    examples, in a process of its own (rc 0, 0 findings), then over each torch
    fixture in this process (every _bad fixture fires its rule, no _ok
    fixture fires)."""
    import client_tpu_torch
    from client_tpu_torch.analysis import scan_paths

    t0 = time.monotonic()
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.analysis",
         "client_tpu_torch", "examples_torch", "--no-cache", "--json"],
        cwd=here, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": here})
    tree_s = time.monotonic() - t0
    check(proc.returncode == 0,
          f"the port's analyser exited {proc.returncode} on its own tree: "
          f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    check(report["count"] == 0 and not report["findings"],
          f"the port's analyser found {report['findings']}")
    fixtures = sorted(f for f in os.listdir(
        os.path.join(here, ANALYSIS_FIXTURES)) if f.endswith(".py"))
    fired = {}
    for name in fixtures:
        rule = next((r for p, r in ANALYSIS_RULES.items()
                     if name.startswith(p)), None)
        check(rule is not None, f"no rule is named for fixture {name}")
        found = scan_paths([os.path.join(here, ANALYSIS_FIXTURES, name)])
        rules = sorted({f.rule for f in found})
        fired[name] = len(found)
        if name.endswith("_bad.py"):
            check(rules == [rule],
                  f"{name}: fired {rules}, where {rule} was expected")
        else:
            check(not found, f"{name} fired {[f.render() for f in found]}")
    bad = [n for n in fixtures if n.endswith("_bad.py")]
    check(len(bad) == len(fixtures) - len(bad) == 7,
          f"the torch fixtures are not 7 pairs: {fixtures}")
    phase(28, "analysis", version=client_tpu_torch.__version__,
          findings=report["count"],
          grandfathered=len(report["grandfathered"]),
          rules=len(report["rules"]), tree_seconds=tree_s,
          fixtures=fired,
          rules_fired=sorted({ANALYSIS_RULES[p] for p in ANALYSIS_RULES
                              if any(n.startswith(p) for n in bad)}),
          seconds=time.monotonic() - t0, **card)


def grpc_lm_inputs(grpcclient, tokens, max_tokens):
    inputs = []
    for name, arr in (("TOKENS", np.asarray(tokens, np.int32)),
                      ("MAX_TOKENS", np.array([max_tokens], np.int32))):
        inp = grpcclient.InferInput(name, list(arr.shape), "INT32")
        inp.set_data_from_numpy(arr)
        inputs.append(inp)
    return inputs


def grpc_stream(grpcclient, address, model, tokens, max_tokens,
                stop_after=None, on_cancel=None):
    """One ModelStreamInfer request's tokens, on a client of its own
    (start_stream, async_stream_infer, stop_stream); with *stop_after* the
    client cancels the stream once it has read that many: from the
    callback that reads the last of them (``cancel_stream``), calling
    *on_cancel* just before.  A cancel from another thread woken by that
    callback waits for the interpreter lock while the engine decodes on:
    that way 1 of 20 stops of tools/grpc_phase.py made 11 tokens where 2
    were read, all of them before the cancel (NVIDIA H100 80GB HBM3,
    700.00 W)."""
    toks, errors, enough = [], [], threading.Event()
    client = grpcclient.InferenceServerClient(address)

    def on_response(result, error):
        if error is not None:
            errors.append(error)
            enough.set()
        elif not enough.is_set():
            toks.append(int(result.as_numpy("TOKEN")[0]))
            if stop_after is not None and len(toks) == stop_after:
                if on_cancel is not None:
                    on_cancel()
                client.cancel_stream()
                enough.set()

    with client:
        client.start_stream(on_response, stream_timeout=300)
        client.async_stream_infer(
            model, grpc_lm_inputs(grpcclient, tokens, max_tokens))
        if stop_after is not None:
            enough.wait(timeout=300)
        client.stop_stream(cancel_requests=stop_after is not None)
    check(not errors, f"{model} streamed an error: {errors}")
    return toks


GRPC_TOKENS = 32   # tokens a gRPC stream in phase 21
GRPC_STREAMS = 4   # concurrent gRPC streams a batched model
GRPC_STOP_MAX = 256  # MAX_TOKENS of the stream the client stops
GRPC_STOP_AFTER = 2  # tokens the client reads before it stops
# decode ticks the engine may run past the client's stop: the server
# notices the cancel at its next yield and closes the stream there (3
# tokens made in all on the H100)
GRPC_STOP_SLACK = 8
GRPC_STOP_RUNS = 20  # streams tools/grpc_phase.py stops, one after another


class StopSplit:
    """Where the tokens of one stopped gRPC stream are made.  Marks, each
    the monotonic time beside the engine's ``ctpu_lm_tokens_total``:
    ``cancel`` just before the client cancels, ``notice`` when the server
    learns of it (a ``context.add_callback`` of the RPC's own, which fires
    as the RPC ends) and ``close`` at the first cancel of the stream's
    own engine handle, where the readbacks still in flight and the
    tokens its lane held for the server (a windowed stream's, past
    ``BatchedLmRunner.stream_window`` unread) are counted too (their
    tokens are dropped, never delivered).  Within the time
    before the cancel: ``sent`` when the server renders the
    GRPC_STOP_AFTER-th response, the engine's delivery time of every
    token (``tokens``), and the interpreter's garbage collections
    (``gc``, generation and seconds).  Only an armed split marks."""

    def __init__(self):
        self.metrics = self.eng = None
        self.armed = False
        self.marks = {}
        self.token_times = []
        self.rendered = 0
        self.collections = []
        self._gc_t0 = None
        # the armed stream's engine handle and the server thread that
        # submitted it (a stream stopped before may still finish its
        # cleanup inside this window: only this stream's marks count)
        self.handle = self.thread = None

    def on_submit(self, handle):
        if self.armed and self.handle is None:
            self.handle = handle
            self.thread = threading.current_thread()

    def on_cancel(self, handle):
        if handle is not None and handle is self.handle:
            held, placed = 0, handle.placed
            if isinstance(placed, tuple):
                lane = self.eng._lanes[placed[0]]
                if lane.gen == placed[1]:
                    held = len(lane.held)
            self.mark("close", in_flight=len(self.eng._inflight),
                      held=held)

    def tokens(self):
        return self.metrics.get("ctpu_lm_tokens_total") or 0

    def mark(self, what, **extra):
        if self.armed and what not in self.marks:
            self.marks[what] = (time.monotonic(), self.tokens(), extra)

    def on_token(self):
        if self.armed:
            self.token_times.append(time.monotonic())

    def on_render(self):
        if self.armed and threading.current_thread() is self.thread:
            self.rendered += 1
            if self.rendered == GRPC_STOP_AFTER:
                self.mark("sent")

    def on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.monotonic()
        elif self.armed and self._gc_t0 is not None:
            self.collections.append(
                (info["generation"], time.monotonic() - self._gc_t0))

    def arm(self):
        self.marks = {}
        self.token_times = []
        self.rendered = 0
        self.collections = []
        self.handle = self.thread = None
        self.armed = True
        self.mark("start")

    def result(self, made):
        self.armed = False
        t = {k: v[0] for k, v in self.marks.items()}
        n = {k: v[1] for k, v in self.marks.items()}
        missing = {"sent", "cancel", "notice", "close"} - set(t)
        check(not missing, f"the stopped stream left no {sorted(missing)} "
              f"mark: {sorted(t)}")
        times = self.token_times
        before = [x for x in times if x <= t["cancel"]]
        gaps = [b - a for a, b in zip(before, before[1:])]
        return {
            "tokens_made": made,
            "tokens_before_cancel": n["cancel"] - n["start"],
            "tokens_before_notice": n["notice"] - n["cancel"],
            "tokens_after_notice": n["close"] - n["notice"],
            "tokens_in_flight": self.marks["close"][2]["in_flight"],
            "tokens_held": self.marks["close"][2]["held"],
            "tokens_after_close": made - (n["close"] - n["start"]),
            "tokens_before_sent": n["sent"] - n["start"],
            "token_gap_s_max": max(gaps, default=0.0),
            "read_s": {
                # the engine's delivery of the last token read -> the
                # server's rendering of it -> the client's cancel
                "delivered_to_sent": (
                    t["sent"] - times[GRPC_STOP_AFTER - 1]
                    if len(times) >= GRPC_STOP_AFTER else None),
                "sent_to_cancel": t["cancel"] - t["sent"],
            },
            "cancel_to_notice_s": t["notice"] - t["cancel"],
            "notice_to_close_s": t["close"] - t["notice"],
            "gc": [[g, round(d, 6)] for g, d in self.collections],
        }


@contextlib.contextmanager
def stop_hooks(split):
    """Install *split*'s notice mark on every ModelStreamInfer call of a
    Server built inside this block (the frontend binds its handlers when
    it is built), registered before the handler's own callbacks."""
    from client_tpu_torch.serve import grpc_server

    orig = grpc_server._Handlers.ModelStreamInfer
    render = grpc_server._dict_to_response

    def stream(handlers, request_iterator, context):
        context.add_callback(lambda: split.mark("notice"))
        return orig(handlers, request_iterator, context)

    def rendered(*args):
        split.on_render()
        return render(*args)

    grpc_server._Handlers.ModelStreamInfer = stream
    grpc_server._dict_to_response = rendered
    try:
        yield split
    finally:
        grpc_server._Handlers.ModelStreamInfer = orig
        grpc_server._dict_to_response = render


def stop_runs(grpcclient, addr, server, eng, prompt, split, runs,
              windows=(None,)):
    """*runs* streams of *eng*'s model, each stopped by the client after
    GRPC_STOP_AFTER tokens, one after another; returns each one's tokens
    read, whether its KV blocks came back, its stream window and its
    StopSplit.  Stop ``i`` runs at ``windows[i % len(windows)]`` as the
    served runner's ``stream_window`` (0: unwindowed; None: as it is)."""
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner

    split.metrics, split.eng = server.engine.metrics, eng
    default_window = BatchedLmRunner.stream_window
    engine_cancel, engine_submit = eng.cancel, eng.submit
    wrapped = vars(eng).get("cancel")  # a wrapper already installed

    def cancel(handle):
        split.on_cancel(handle)
        return engine_cancel(handle)

    def submit(*args, **kw):
        q, handle = engine_submit(*args, **kw)
        split.on_submit(handle)
        return q, handle

    registry = eng.registry
    registry_inc = registry.inc

    def inc(name, *args, **kw):
        if name == "ctpu_lm_tokens_total":
            split.on_token()
        return registry_inc(name, *args, **kw)

    eng.cancel = cancel
    eng.submit = submit
    registry.inc = inc
    gc.callbacks.append(split.on_gc)
    stops = []
    try:
        for i in range(runs):
            window = windows[i % len(windows)]
            BatchedLmRunner.stream_window = (
                default_window if window is None else window)
            used = eng.kv.used_blocks
            split.arm()
            read = grpc_stream(grpcclient, addr, "lm_streaming_batched",
                               prompt[:8], GRPC_STOP_MAX,
                               stop_after=GRPC_STOP_AFTER,
                               on_cancel=lambda: split.mark("cancel"))
            deadline = time.monotonic() + 30
            while (eng.kv.used_blocks != used
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            made = split.tokens() - split.marks["start"][1]
            stops.append({"tokens_read": len(read),
                          "blocks_back": eng.kv.used_blocks == used,
                          "window": BatchedLmRunner.stream_window,
                          **split.result(made)})
    finally:
        BatchedLmRunner.stream_window = default_window
        gc.callbacks.remove(split.on_gc)
        del registry.inc
        del eng.submit
        if wrapped is None:
            del eng.cancel
        else:
            eng.cancel = wrapped
    return stops


def stop_summary(stops):
    """Phase 21's stopped-stream fields: every stop's split, the worst of
    each, and the threads of the process as the stops ran."""
    bound = GRPC_STOP_AFTER + GRPC_STOP_SLACK
    keys = [k for k in stops[0] if k.startswith("tokens_")
            and k != "tokens_read"] + [
        "token_gap_s", "cancel_to_notice_s", "notice_to_close_s"]
    reads = [s["read_s"] for s in stops]
    threads = collections.Counter(
        re.sub(r"^Thread-\d+ |[-_]?\d+$", "", th.name)
        for th in threading.enumerate())
    by_window = {}
    for s in stops:
        w = by_window.setdefault(str(s["window"]), {
            "runs": 0, "within_bound": 0, "tokens_made": []})
        w["runs"] += 1
        w["within_bound"] += s["tokens_made"] <= bound
        w["tokens_made"].append(s["tokens_made"])
    for w in by_window.values():
        made = sorted(w.pop("tokens_made"))
        w["tokens_made_p50"] = made[len(made) // 2]
        w["tokens_made_worst"] = made[-1]
    return {
        "runs": len(stops), "tokens_read": GRPC_STOP_AFTER,
        "tokens_made_max": bound, "max_tokens": GRPC_STOP_MAX,
        "within_bound": sum(s["tokens_made"] <= bound for s in stops),
        "by_window": by_window,
        "worst": {k: max(s.get(k, s.get(k + "_max")) for s in stops)
                  for k in keys},
        "read_s_max": {k: max((r[k] for r in reads if r[k] is not None),
                              default=None) for k in reads[0]},
        "gc_s_max": max((d for s in stops for _, d in s["gc"]), default=0.0),
        "switch_interval_s": sys.getswitchinterval(),
        "threads": dict(threads.most_common()),
        "stops": stops,
    }


def check_stops(stops):
    for i, s in enumerate(stops):
        check(s["tokens_read"] == GRPC_STOP_AFTER and s["blocks_back"],
              f"stopped stream {i} read {s['tokens_read']} tokens and "
              f"{'gave' if s['blocks_back'] else 'did not give'} its KV "
              "blocks back")
        check(s["tokens_made"] <= GRPC_STOP_AFTER + GRPC_STOP_SLACK,
              f"stopped stream {i} ran on: {s['tokens_made']} tokens made, "
              f"{GRPC_STOP_AFTER} read ({s})")


def grpc_phase(card, prompt, stop_count=1, windows=(None,)):
    """Phase 21: the gRPC frontend on the card.  The language set behind
    ``Server(grpc_port=0)``, driven through the port's gRPC client (each
    stream on a client of its own): ready, metadata, every served model's
    config, the tokenizer, a decoupled ModelInfer refused, a lone stream
    of each batched model, four concurrent streams each and *stop_count*
    streams, one after another, that the client stops after two tokens,
    each of which gives its KV blocks back having made at most
    GRPC_STOP_SLACK tokens past the stop (*windows*: stop_runs').  The
    launch counts are reset just before the first gRPC call and read just after the last;
    what the streams are held against (each engine's own stream, the
    serial runner, the near-tie rule's forwards) runs after that window.
    Returns (launches, routes)."""
    try:
        import grpc
    except ImportError as e:
        fail(f"phase 21 needs grpcio on the card: {e}")
    from client_tpu_torch import grpc as grpcclient
    from client_tpu_torch import ops
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.utils import InferenceServerException

    t0 = time.monotonic()
    served_models = language.language_models(device="cuda")
    engines = {m.name: m.closer.__self__ for m in served_models
               if m.closer is not None}
    split = StopSplit()
    with stop_hooks(split), Server(
            models=served_models, http_port=0, grpc_port=0,
            with_default_models=False) as server:
        addr = server.grpc_address
        with grpcclient.InferenceServerClient(addr) as client:
            torch.cuda.synchronize()
            ops.reset_launches()
            check(client.is_server_ready(), "ServerReady answered false")
            name = client.get_server_metadata().name
            check(name == "client_tpu_torch.serve", f"server name {name}")
            configs = {}
            for m in served_models:
                config = client.get_model_config(m.name).config
                meta = client.get_model_metadata(m.name)
                check(config.name == meta.name == m.name,
                      f"{m.name}: config {config.name}, metadata {meta.name}")
                configs[m.name] = config.model_transaction_policy.decoupled
            text = grpcclient.InferInput("TEXT", [1], "BYTES")
            text.set_data_from_numpy(np.array([PROMPT.encode()],
                                              dtype=np.object_))
            out = client.infer("tokenizer", [text], client_timeout=60)
            check(out.as_numpy("TOKENS").reshape(-1).tolist()
                  == prompt.tolist(),
                  "tokenizer over gRPC differs from encode_text")
            try:
                client.infer("lm_streaming_int8",
                             grpc_lm_inputs(grpcclient, prompt, 4),
                             client_timeout=60)
                fail("ModelInfer on a decoupled model was answered")
            except InferenceServerException as e:
                check(e.status() == grpc.StatusCode.INVALID_ARGUMENT.name
                      and "use ModelStreamInfer" in e.message(),
                      f"decoupled ModelInfer answered {e.status()}: "
                      f"{e.message()}")
            lone, concurrent = {}, {}
            prompts = distinct_prompts(prompt, GRPC_STREAMS)
            for model_name in engines:
                lone[model_name] = grpc_stream(grpcclient, addr, model_name,
                                               prompt, GRPC_TOKENS)
                streams = [None] * GRPC_STREAMS
                threads = [threading.Thread(
                    target=lambda i=i, p=p: streams.__setitem__(
                        i, grpc_stream(grpcclient, addr, model_name, p,
                                       GRPC_TOKENS)))
                    for i, p in enumerate(prompts)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=300)
                concurrent[model_name] = streams
            # under one KV block (16 tokens): the prefix cache keeps none
            # of its blocks, so the pool goes back to where it was
            eng = engines["lm_streaming_batched"]
            stops = stop_runs(grpcclient, addr, server, eng, prompt, split,
                              stop_count, windows)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            routes = {name: dict(r) for name, r in ops.ROUTES.items()}
        stopped_stream = stop_summary(stops)
        phase(21, "grpc_stops", **stopped_stream, **card)
        check_stops(stops)
        near = {}
        for model_name, eng in engines.items():
            got = lone[model_name]
            own = collect(eng.submit(prompt, GRPC_TOKENS)[0], LmEngine.CLOSE)
            check(got == own and len(got) == GRPC_TOKENS,
                  f"{model_name}: gRPC stream {got} != its engine's {own}")
            ref = language._LmRunner(
                device="cuda", quantize=model_name == "lm_streaming_int8")
            near[model_name] = [
                agreement(tfm, ref.params, ref.cfg, p, got,
                          list(ref.stream(p, GRPC_TOKENS)))
                for p, got in zip(prompts, concurrent[model_name])]
            del ref
        _, body, _ = http(server.http_address, "/v2/debug/prof?window=0")
        wire = {e["engine"]: e for e in json.loads(body)["engines"]}["wire"]
    check(all(not e._thread.is_alive() for e in engines.values()),
          "Server.stop left an engine's scheduler thread running")
    for name in ("int8_matmul", "paged_attention"):
        check(launches[name] > 0, f"the gRPC path launched {name} no time")
    check(wire["kinds"].get("grpc", 0) >= 2,
          f"ModelInfer left no grpc wire ticks: {wire['kinds']}")
    phase(21, "grpc", grpc_version=grpc.__version__,
          configs_parsed=len(configs),
          decoupled=sorted(k for k, v in configs.items() if v),
          lone_stream_equals_engine={k: len(v) for k, v in lone.items()},
          concurrent_vs_serial=near, near_tie=NEAR_TIE,
          stopped_stream={k: v for k, v in stopped_stream.items()
                          if k != "stops"},
          wire_ticks=wire["kinds"], launches=launches,
          launches_by_route=routes,
          seconds=time.monotonic() - t0, **card)
    return launches, routes


# -- perf_analyzer (phase 22) -------------------------------------------------

PERF_WINDOW_MS = {"hermetic": 1000, "socket": 500}  # measurement windows
PERF_TRIALS = 3        # windows a level at most
PERF_STABILITY = "25"  # percent; a level that does not settle still reports
PERF_LM_MAX_TOKENS = 16   # the prefix-share workload's scalar budget
PERF_SPEC_MAX_TOKENS = 32  # MAX_TOKENS of the speculative leg's prompt
PERF_SHM_LEGS = (("none", False), ("system", False), ("cuda", False),
                 ("cuda", True))  # (--shared-memory, --cuda-shm-sync)
PERF_PROBE_SAMPLES = 32
# the probe's calibration load: bf16 [8192, 8192] matmuls queued on the
# default stream (1.1 TFLOP each: a second or so of the card's time)
PERF_LOAD = (8192, 600)
PERF_GAUGES = ("ctpu_gpu_memory_used_bytes", "ctpu_gpu_memory_total_bytes",
               "ctpu_gpu_memory_peak_bytes", "ctpu_probe_queue_delay_us",
               "ctpu_probe_utilization_pct")

# A client process of phase 22's own: one ResNet-50 request whose input
# and output lie in CUDA regions of this process (the server opens them
# over CUDA IPC) against the same request over the wire, then the
# utilization probe from this process: idle samples, then, once the
# parent has queued its load (a line on stdin), samples under it.
PERF_CHECK_CLIENT = r"""
import json, sys
import numpy as np
import client_tpu_torch.grpc as grpcclient
from client_tpu_torch.perf.metrics_manager import DeviceUtilizationProbe
from client_tpu_torch.utils import cuda_shared_memory as cudashm

addr, samples = sys.argv[1], int(sys.argv[2])
x = np.random.default_rng(22).random((1, 3, 224, 224), dtype=np.float32)
h_in = cudashm.create_shared_memory_region("check_in", x.nbytes)
h_out = cudashm.create_shared_memory_region("check_out", 4000)
with grpcclient.InferenceServerClient(addr) as c:
    try:
        cudashm.set_shared_memory_region(h_in, [x])
        c.register_cuda_shared_memory(
            "check_in", cudashm.get_raw_handle(h_in), 0, x.nbytes)
        c.register_cuda_shared_memory(
            "check_out", cudashm.get_raw_handle(h_out), 0, 4000)
        inp = grpcclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_shared_memory("check_in", x.nbytes)
        out = grpcclient.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory("check_out", 4000)
        c.infer("resnet50", [inp], outputs=[out])
        region = cudashm.get_contents_as_numpy(h_out, "FP32", [1, 1000])
        status = c.get_cuda_shared_memory_status(as_json=True)
        wire_in = grpcclient.InferInput("INPUT0", list(x.shape), "FP32")
        wire_in.set_data_from_numpy(x)
        wire = c.infer("resnet50", [wire_in]).as_numpy("OUTPUT0")
    finally:
        c.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)
probe = DeviceUtilizationProbe()
idle = [probe.sample() for _ in range(samples)]
print(json.dumps({
    "region_equals_wire": bool(np.array_equal(region, wire)),
    "max_abs_diff": float(np.abs(region - wire).max()),
    "regions_registered": sorted(status.get("regions", {})),
    "baseline_us": probe.baseline_s * 1e6,
    "idle_us": [d for d, _ in idle], "idle_flags": [b for _, b in idle]}),
    flush=True)
sys.stdin.readline()
busy = [probe.sample() for _ in range(samples)]
print(json.dumps({"busy_us": [d for d, _ in busy],
                  "busy_flags": [b for _, b in busy]}), flush=True)
"""


def perf_levels(doc):
    return [{"level": r["level_value"],
             "infer_per_s": r["throughput_infer_per_sec"],
             "p50_us": r["percentiles_us"].get("50"),
             "p99_us": r["percentiles_us"].get("99"),
             "requests_in_windows": r["completed_requests"],
             "stable": r["stable"]} for r in doc["results"]]


def perf_run_inprocess(argv, out):
    """One ``client_tpu_torch.perf`` run in this process; its summary text
    is kept off this script's output.  The launch counts are reset just
    before the run and read just after it (building the engine launches
    neither kernel; a graph's launches count at its replays).  Returns
    (the JSON export, launches, routes)."""
    import io

    from client_tpu_torch import ops
    from client_tpu_torch.perf.__main__ import main as perf_main

    text = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    with contextlib.redirect_stdout(text):
        rc = perf_main(argv + ["--json-export", out])
    launches = dict(ops.LAUNCHES)
    routes = {n: dict(r) for n, r in ops.ROUTES.items()}
    check(rc == 0, f"perf {' '.join(argv)} exited {rc}: "
                   f"{text.getvalue()[-2000:]}")
    with open(out) as f:
        return json.load(f), launches, routes


def perf_hermetic_legs(card, tmp):
    """Phase 22a: perf_analyzer's in-process legs over the language set
    on the card.  Returns (launches, routes) summed over both legs'
    windows."""
    from client_tpu_torch.serve.models import language

    windows = []
    common = ["--hermetic", "--hermetic-models", "language",
              "--measurement-interval", str(PERF_WINDOW_MS["hermetic"]),
              "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY]
    spec_data = os.path.join(tmp, "spec_input.json")
    tokens = language.encode_text(PROMPT * 2).tolist()
    with open(spec_data, "w") as f:
        json.dump({"data": [{"TOKENS": {"content": tokens,
                                        "shape": [len(tokens)]},
                             "MAX_TOKENS": [PERF_SPEC_MAX_TOKENS]}]}, f)
    legs = {
        "lm_streaming_batched prefix-share": (
            ["-m", "lm_streaming_batched", "--prefix-share", "0.5",
             "--shape", "TOKENS:1,128", "--concurrency-range", "1:8:7"],
            {"prompt_tokens": 128, "shared_tokens": 64,
             "max_tokens": PERF_LM_MAX_TOKENS, "weights": "bfloat16"}),
        "lm_streaming_int8 speculative": (
            ["-m", "lm_streaming_int8", "--speculative", "4",
             "--input-data", spec_data, "--concurrency-range", "8"],
            {"prompt_tokens": len(tokens),
             "max_tokens": PERF_SPEC_MAX_TOKENS, "weights": "int8",
             "speculative": {"k": 4, "drafter": "ngram"}}),
    }
    for i, (leg, (argv, workload)) in enumerate(legs.items()):
        t0 = time.monotonic()
        doc, *window = perf_run_inprocess(
            argv + common, os.path.join(tmp, f"hermetic{i}.json"))
        windows.append(window)
        for r in doc["results"]:
            check(r["error_count"] == 0 and r["completed_requests"] > 0,
                  f"{leg}: {r['error_count']} failed, "
                  f"{r['completed_requests']} completed")
            if "prefix" in leg:
                p = r["lm_prefix"]
                check(p.get("hits", 0) > 0
                      and p.get("saved_tokens", 0) > 0
                      and p["prefix_hit_pct"] > 0,
                      f"{leg} at {r['level_value']}: prefix columns {p}")
            else:
                s = r["lm_spec"]
                check({"spec_acceptance_pct", "spec_tokens_per_sec"}
                      <= set(s) and s.get("proposed", 0) > 0,
                      f"{leg}: speculative columns {s}")
        phase(22, "perf_hermetic", leg=leg, workload=workload,
              levels=perf_levels(doc),
              seconds=time.monotonic() - t0, export=doc, **card)
    check(len(windows) == 2, f"{len(windows)} launch windows, not 2")
    launches = {n: sum(w[0][n] for w in windows) for n in windows[0][0]}
    routes = {n: {r: sum(w[1][n][r] for w in windows) for r in rs}
              for n, rs in windows[0][1].items()}
    for name in ("int8_matmul", "paged_attention"):
        check(launches[name] > 0,
              f"the hermetic perf legs launched {name} no time")
    return launches, routes


def perf_probe_samples(probe, n):
    return [probe.sample() for _ in range(n)]


def perf_load():
    """Queue PERF_LOAD's matmuls on the default stream (returns at once)."""
    n, count = PERF_LOAD
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(a)
    torch.cuda.synchronize()
    for _ in range(count):
        torch.matmul(a, b, out=out)
    return out


def perf_delays(idle, busy):
    """The probe's samples, (delay us, busy flag) each, with no load and
    under the load."""
    idle_us, delays = [d for d, _ in idle], [d for d, _ in busy]
    return {"idle_p50_us": float(np.percentile(idle_us, 50)),
            "idle_max_us": float(np.max(idle_us)),
            "idle_busy_share": float(np.mean([b for _, b in idle])),
            "busy_p50_us": float(np.percentile(delays, 50)),
            "busy_max_us": float(np.max(delays)),
            "busy_share": float(np.mean([b for _, b in busy]))}


def perf_argv(server, protocol, model, shm, out, levels="1:8:7",
              window_ms=PERF_WINDOW_MS["socket"], extra=()):
    """The argv of one ``python -m client_tpu_torch.perf -i <protocol>``
    run against *model* behind *server*, exporting JSON to *out*."""
    addr = server.grpc_address if protocol == "grpc" else server.http_address
    return [sys.executable, "-m", "client_tpu_torch.perf",
            "-i", protocol, "-m", model, "-u", addr,
            "--shared-memory", shm,
            "--output-shared-memory-size", "4000",
            "--concurrency-range", levels,
            "--measurement-interval", str(window_ms),
            "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY,
            "--collect-metrics", "--metrics-interval", "100",
            "--metrics-url", f"http://{server.http_address}/metrics",
            "--collect-local-gpu-metrics",
            "--probe-device-utilization", "--json-export", out, *extra]


def success_counts(server, model):
    """The server's (success, fail) counts of *model*."""
    stats = server.engine.statistics(model)[0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


def perf_socket_leg(server, tmp, protocol, model, shm, sync=False,
                    extra=(), env=None, levels="1:8:7", tag="", watch=None,
                    n=None):
    """One ``python -m client_tpu_torch.perf -i <protocol>`` subprocess
    against *model* behind this process's *server*, at concurrency
    *levels* (1 and 8), with --collect-metrics --collect-local-gpu-metrics
    --probe-device-utilization: the server's success count must equal the
    client's count of the run, with no failure on either side, the gauges
    in every record and, from CUDA regions, the regions seen over
    CudaSharedMemoryStatus and opened over CUDA IPC.  *watch*, if given,
    runs on a thread of its own as ``watch(pid, stop)`` while the
    subprocess runs; its start is noted under phase *n* (client_start).
    Returns (leg, JSON export, the server's successes, the CUDA regions,
    seconds)."""
    from client_tpu_torch import grpc as grpcclient

    here = os.path.dirname(os.path.abspath(__file__))
    leg = (f"{model} {protocol} {shm}" + (" --cuda-shm-sync" if sync else "")
           + (f" {tag}" if tag else ""))
    out = os.path.join(tmp, f"socket_{protocol}_{model}_{shm}_{int(sync)}"
                            f"{tag}.json")
    argv = perf_argv(server, protocol, model, shm, out, levels=levels,
                     extra=extra)
    if sync:
        argv.append("--cuda-shm-sync")

    def counts():
        return success_counts(server, model)

    seen, opened, stop = set(), {}, threading.Event()

    def poll():
        with grpcclient.InferenceServerClient(server.grpc_address) as c:
            while not stop.is_set():
                status = c.get_cuda_shared_memory_status(as_json=True)
                seen.update(status.get("regions", {}))
                for name, entry in list(server.engine.shm._cuda.items()):
                    opened[name] = entry["opened"]
                stop.wait(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    before = counts()
    t0 = time.monotonic()
    poller.start()
    proc = popen(client_argv(argv), stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE, text=True, env=client_env(env),
                 cwd=here)
    watcher = (None if watch is None else
               threading.Thread(target=watch, args=(proc.pid, stop),
                                daemon=True))
    try:
        if watcher is not None:
            watcher.start()
        _, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stop.set()
        poller.join(timeout=30)
        if watcher is not None:
            watcher.join(timeout=30)
    seconds = time.monotonic() - t0
    stderr = client_start(n, leg, proc.args, stderr)
    check(proc.returncode == 0,
          f"{leg} exited {proc.returncode}: {stderr[-3000:]}")
    after = counts()
    with open(out) as f:
        doc = json.load(f)
    served = after[0] - before[0]
    check(doc["requests"] == {"completed": served, "failed": 0}
          and after[1] == before[1],
          f"{leg}: the client counted {doc['requests']}, the server "
          f"{served} successes and {after[1] - before[1]} failures")
    for r in doc["results"]:
        missing = [g for g in PERF_GAUGES if g not in r["tpu_metrics"]]
        check(not missing and r["error_count"] == 0
              and r["completed_requests"] > 0,
              f"{leg} at {r['level_value']}: gauges {missing} "
              f"missing, {r['error_count']} failed, "
              f"{r['completed_requests']} completed")
    regions = sorted(n for n in seen if n.startswith("perf_cudashm"))
    if shm == "cuda":
        check(regions and all(opened.get(n) for n in regions),
              f"{leg}: regions {regions} seen over "
              f"CudaSharedMemoryStatus, opened over IPC: {opened}")
    return leg, doc, served, regions, seconds


def perf_socket_legs(card, tmp):
    """Phase 22b: ``python -m client_tpu_torch.perf -i grpc`` subprocesses
    against ResNet-50 behind this process's Server, wire, system and CUDA
    regions; a CUDA-region answer against the wire's; the probe calibrated
    in this process and from another."""
    from client_tpu_torch import ops
    from client_tpu_torch.perf.metrics_manager import DeviceUtilizationProbe
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import vision

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here}
    model = vision.resnet50_model(warmup=True)
    ops.reset_launches()
    with Server(models=[model], http_port=0, grpc_port=0,
                with_default_models=False) as server:
        addr = server.grpc_address
        for shm, sync in PERF_SHM_LEGS:
            leg, doc, served, regions, seconds = perf_socket_leg(
                server, tmp, "grpc", "resnet50", shm, sync, env=env, n=22)
            if shm == "none":
                PYTHON_GRPC_AT_8.update(
                    next(lv for lv in perf_levels(doc) if lv["level"] == 8),
                    leg="phase 22b, python -m client_tpu_torch.perf -i grpc "
                        "from the wire on phase 22's server (ResNet-50 "
                        "alone), the metrics scrape and the probe on")
            phase(22, "perf_grpc", leg=leg, levels=perf_levels(doc),
                  requests=doc["requests"], server_successes=served,
                  cuda_regions_opened_over_ipc=regions,
                  seconds=seconds, export=doc, **card)

        # one answer from CUDA regions against the wire's, and the probe
        # across processes (the client samples while this process loads)
        probe = DeviceUtilizationProbe()
        idle_here = perf_probe_samples(probe, PERF_PROBE_SAMPLES)
        proc = popen(
            client_argv([sys.executable, "-c", PERF_CHECK_CLIENT, addr,
                         str(PERF_PROBE_SAMPLES)], torch=True),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=client_env(env),
            cwd=here)
        try:
            first = proc.stdout.readline()
            if not first:
                fail(f"the check client died: {proc.stderr.read()[-3000:]}")
            answer = json.loads(first)
            perf_load()
            proc.stdin.write("go\n")
            proc.stdin.flush()
            across = json.loads(proc.stdout.readline())
            torch.cuda.synchronize()
            perf_load()
            busy_here = perf_probe_samples(probe, PERF_PROBE_SAMPLES)
            torch.cuda.synchronize()
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        client_start(22, "the check client (CUDA regions, the probe)",
                     proc.args, proc.stderr.read())
        check(answer["region_equals_wire"],
              f"a CUDA-region answer differs from the wire's by "
              f"{answer['max_abs_diff']}")
        launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"the ResNet-50 perf legs launched {launches}")
    n, count = PERF_LOAD
    phase(22, "perf_cuda_region_vs_wire", model="resnet50",
          region_equals_wire=True, regions=answer["regions_registered"])
    across_processes = {
        "baseline_us": answer["baseline_us"],
        **perf_delays(list(zip(answer["idle_us"], answer["idle_flags"])),
                      list(zip(across["busy_us"], across["busy_flags"])))}
    # across processes the probe waits out the loaded context's time
    # slice: the one reading that separates load from no load
    check(across_processes["busy_share"]
          > across_processes["idle_busy_share"],
          f"the probe from another process read no more busy samples "
          f"under the load than without it: {across_processes}")
    phase(22, "perf_probe_calibration",
          load=f"{count} bf16 [{n}, {n}] matmuls queued on the default "
               "stream of the phase's process",
          in_process={"baseline_us": probe.baseline_s * 1e6,
                      **perf_delays(idle_here, busy_here)},
          across_processes=across_processes,
          samples=PERF_PROBE_SAMPLES, **card)


def perf_phase(card):
    """Phase 22: perf_analyzer on the card.  Returns the launch counts of
    the in-process legs (launches_perf in phase 20)."""
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_perf_")
    try:
        launches, routes = perf_hermetic_legs(card, tmp)
        perf_socket_legs(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE_SECONDS[22] = time.monotonic() - t0
    phase(22, "perf_done", launches=launches, launches_by_route=routes,
          seconds=PHASE_SECONDS[22], **card)
    return launches, routes


# -- the direct path and perf_analyzer over HTTP (phase 23) -------------------

DIRECT_FRESH = 8  # direct requests, each on a new connection: a new thread
DIRECT_WARM = 8   # then on one kept connection: one thread, warm
DIRECT_ROWS = 3   # the rows of one multi-row direct request
HTTP_SHM_LEGS = ("none", "system", "cuda")
HTTP_LM = "lm_streaming_int8"  # the LM leg's model: int8 and paged kernels


def direct_requests(server, model, images):
    """Phase 23a's requests to *model* (ResNet-50) behind *server*, through
    the port's HTTP client: host requests whose output lies in a system
    region (not batched: the direct path), each of DIRECT_FRESH on a
    new connection (a server thread's first request), DIRECT_WARM on one
    kept connection, one of DIRECT_ROWS rows, one wire request with a
    request parameter and one whose input lies in a CUDA region on the
    card and that carries a parameter (both the direct path, the second
    through the program's device route); then the same images as wire
    requests without parameters, which the batcher takes.  Returns
    (direct answers, batched answers, (fresh ms, warm ms), the CUDA-input
    request's direct_runs): the answers keyed alike; the server's compute
    ms of each single-image direct request on a new thread and on the
    kept one."""
    from client_tpu_torch import http as httpclient
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils import shared_memory as sysshm

    tag = f"direct_{os.getpid()}"
    out_bytes = DIRECT_ROWS * 4000
    region = sysshm.create_shared_memory_region(tag, f"/{tag}", out_bytes)

    def compute_ns():
        stats = server.engine.statistics(model)[0]["inference_stats"]
        return stats["compute_infer"]["ns"]

    def shm_infer(c, x):
        inp = httpclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_data_from_numpy(x)
        out = httpclient.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(tag, x.shape[0] * 4000)
        before = compute_ns()
        c.infer(model, [inp], outputs=[out])
        ms = (compute_ns() - before) / 1e6
        return sysshm.get_contents_as_numpy(
            region, "FP32", [x.shape[0], 1000]).copy(), ms

    def wire_infer(c, x, **kw):
        inp = httpclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_data_from_numpy(x)
        return c.infer(model, [inp], **kw).as_numpy("OUTPUT0")

    k = DIRECT_FRESH + DIRECT_WARM
    inputs = {i: images[i:i + 1] for i in range(k)}
    inputs["rows"] = images[k:k + DIRECT_ROWS]
    inputs["param"] = images[:1]
    inputs["cuda_param"] = images[1:2]
    batcher = server.engine._batchers[model]
    direct, fresh, warm = {}, [], []
    addr = server.http_address
    try:
        with httpclient.InferenceServerClient(addr) as c:
            c.register_system_shared_memory(tag, f"/{tag}", out_bytes)
        for i in range(DIRECT_FRESH):
            with httpclient.InferenceServerClient(addr) as c:
                direct[i], ms = shm_infer(c, inputs[i])
                fresh.append(ms)
        with httpclient.InferenceServerClient(addr) as c:
            for i in range(DIRECT_FRESH, k):
                direct[i], ms = shm_infer(c, inputs[i])
                warm.append(ms)
            direct["rows"], _ = shm_infer(c, inputs["rows"])
            direct["param"] = wire_infer(c, inputs["param"],
                                         parameters={"direct": "param"})
            x = inputs["cuda_param"]
            h = cudashm.create_shared_memory_region(f"{tag}_in", x.nbytes)
            try:
                cudashm.set_shared_memory_region(h, [x])
                c.register_cuda_shared_memory(
                    f"{tag}_in", cudashm.get_raw_handle(h), 0, x.nbytes)
                inp = httpclient.InferInput("INPUT0", list(x.shape), "FP32")
                inp.set_shared_memory(f"{tag}_in", x.nbytes)
                runs = batcher.graph_stats()["direct_runs"]
                direct["cuda_param"] = c.infer(
                    model, [inp], parameters={"direct": "cuda"}
                ).as_numpy("OUTPUT0")
                cuda_runs = batcher.graph_stats()["direct_runs"] - runs
            finally:
                c.unregister_cuda_shared_memory(f"{tag}_in")
                cudashm.destroy_shared_memory_region(h)
            c.unregister_system_shared_memory(tag)
            batched = {key: wire_infer(c, x) for key, x in inputs.items()}
    finally:
        sysshm.destroy_shared_memory_region(region)
    return direct, batched, (fresh, warm), cuda_runs


def direct_path_leg(card, server, model):
    """Phase 23a: ResNet-50's direct path on the card runs through the
    batcher's captured bucket graphs: no eager forward (``model.fn`` is
    counted from after the graphs were captured; a replay calls no
    Python), a ``direct_runs`` a direct request, every answer bit-equal to
    the same images' answer through the batcher (the same graph on the
    same values: tolerance 0)."""
    from client_tpu_torch import ops

    name = model.name
    batcher = server.engine._batchers[name]
    programs = batcher.programs()
    check(programs and all(p.graph is not None for p in programs.values()),
          f"{name}: buckets {sorted(programs)} without a captured graph")
    eager = []
    fn = model.fn

    def counted(inputs, params, ctx):
        eager.append(threading.get_ident())
        return fn(inputs, params, ctx)

    images = vision_images(DIRECT_FRESH + DIRECT_WARM + DIRECT_ROWS,
                           seed=23).numpy()
    torch.cuda.synchronize()
    ops.reset_launches()
    runs = batcher.graph_stats()["direct_runs"]
    model.fn = counted
    try:
        direct, batched, (fresh, warm), cuda_runs = direct_requests(
            server, name, images)
    finally:
        model.fn = fn
    direct_runs = batcher.graph_stats()["direct_runs"] - runs
    launches = dict(ops.LAUNCHES)
    check(not eager, f"{len(eager)} direct requests ran the eager forward "
                     f"(threads {sorted(set(eager))})")
    check(direct_runs == len(direct),
          f"{direct_runs} bucket-graph replays on the direct path for "
          f"{len(direct)} direct requests")
    check(cuda_runs == 1,
          f"the CUDA-region request with a parameter made {cuda_runs} "
          f"bucket-graph replays on the direct path")
    check(not any(launches.values()),
          f"the direct path launched {launches}")
    diffs = {str(k): float(np.abs(direct[k] - batched[k]).max())
             for k in direct}
    check(all(d == 0.0 for d in diffs.values()),
          f"direct answers differ from the batcher's: {diffs}")
    phase(23, "direct_path", model=name, direct_requests=len(direct),
          direct_graph_replays=direct_runs, eager_forwards=len(eager),
          cuda_region_input_with_parameter_replays=cuda_runs,
          tolerance="bit-equal to the batcher's answer for the same images",
          max_abs_diff=max(diffs.values()),
          server_compute_ms_first_on_new_thread=fresh,
          server_compute_ms_first_on_new_thread_median=float(
              np.median(fresh)),
          server_compute_ms_warm_thread=warm,
          server_compute_ms_warm_thread_median=float(np.median(warm)),
          **card)


MIXED_LEVEL = 8
# the system leg's windows: it outlasts the wire leg, whose process
# took 12-16 s for two levels on a slow host (three windows: 30 s)
MIXED_WINDOW_MS = 10000


def mixed_socket_leg(card, server, tmp, solo):
    """Phase 23b, both at once: a system-region perf client (the direct
    path, on the server's request threads) and a wire one (the batcher
    thread), each at MIXED_LEVEL over gRPC against ResNet-50.  The wire
    client starts once the system client's requests reach the server; the
    system client, with longer windows, must still be running when the
    wire client ends, so the wire leg's windows all lie under the mixed
    load.  The server's successes equal the two clients' counts, with no
    failure.  Prints the wire leg's p50/p99 and infer/s beside *solo*
    (its phase 23b levels)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here}
    outs = {shm: os.path.join(tmp, f"mixed_{shm}.json")
            for shm in ("system", "none")}
    before = success_counts(server, "resnet50")
    t0 = time.monotonic()
    bg = popen(
        client_argv(perf_argv(server, "grpc", "resnet50", "system",
                              outs["system"], levels=str(MIXED_LEVEL),
                              window_ms=MIXED_WINDOW_MS)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=client_env(env), cwd=here)
    try:
        while (success_counts(server, "resnet50")[0] == before[0]
               and bg.poll() is None and time.monotonic() - t0 < 120):
            time.sleep(0.05)
        wire = subprocess.run(
            client_argv(perf_argv(server, "grpc", "resnet50", "none",
                                  outs["none"], levels=str(MIXED_LEVEL))),
            capture_output=True, text=True, timeout=300,
            env=client_env(env), cwd=here)
        overlapped = bg.poll() is None
        _, bg_err = bg.communicate(timeout=300)
    finally:
        if bg.poll() is None:
            bg.kill()
            bg.wait()
    wire.stderr = client_start(23, "resnet50 grpc none (mixed)", wire.args,
                               wire.stderr)
    bg_err = client_start(23, "resnet50 grpc system (mixed)", bg.args,
                          bg_err)
    check(wire.returncode == 0 and bg.returncode == 0,
          f"the mixed legs exited {wire.returncode} (wire) and "
          f"{bg.returncode} (system): {wire.stderr[-2000:]} {bg_err[-2000:]}")
    check(overlapped, "the system-region client ended before the wire "
                      "client: the wire leg's windows were not all mixed")
    docs = {}
    for shm, out in outs.items():
        with open(out) as f:
            docs[shm] = json.load(f)
    after = success_counts(server, "resnet50")
    completed = sum(d["requests"]["completed"] for d in docs.values())
    check(after[0] - before[0] == completed and after[1] == before[1]
          and all(d["requests"]["failed"] == 0 for d in docs.values()),
          f"mixed legs: the clients counted "
          f"{[d['requests'] for d in docs.values()]}, the server "
          f"{after[0] - before[0]} successes, {after[1] - before[1]} "
          f"failures")
    mixed = {shm: perf_levels(d)[0] for shm, d in docs.items()}
    alone = next(w for w in solo if w["level"] == MIXED_LEVEL)
    phase(23, "perf_grpc_mixed", model="resnet50", level=MIXED_LEVEL,
          wire_alone={k: alone[k] for k in ("infer_per_s", "p50_us",
                                            "p99_us")},
          wire_mixed={k: mixed["none"][k] for k in ("infer_per_s", "p50_us",
                                                    "p99_us", "stable")},
          system_mixed={k: mixed["system"][k] for k in (
              "infer_per_s", "p50_us", "p99_us", "stable")},
          seconds=time.monotonic() - t0, **card)


def write_lm_input(path):
    """perf's --input-data for an LM leg: PROMPT's tokens, MAX_TOKENS 1
    (a decoupled model answers over HTTP with one response).  Returns the
    tokens."""
    from client_tpu_torch.serve.models import language

    tokens = language.encode_text(PROMPT).tolist()
    with open(path, "w") as f:
        json.dump({"data": [{"TOKENS": {"content": tokens,
                                        "shape": [len(tokens)]},
                             "MAX_TOKENS": [1]}]}, f)
    return tokens


def http_lm_leg(card, server, tmp):
    """Phase 23c's LM leg: ``perf -i http`` on HTTP_LM with MAX_TOKENS 1
    (a decoupled model answers over HTTP with one response, as in the
    reference), after one request of the same prompt (the engine captures
    its graphs at its first request, which would otherwise fill the first
    level's windows); the launch counts reset just before the client
    process starts and read just after it exits.  Returns (launches,
    routes)."""
    from client_tpu_torch import http as httpclient
    from client_tpu_torch import ops

    data = os.path.join(tmp, "lm_http_input.json")
    tokens = write_lm_input(data)
    with httpclient.InferenceServerClient(server.http_address) as c:
        inputs = [httpclient.InferInput("TOKENS", [len(tokens)], "INT32"),
                  httpclient.InferInput("MAX_TOKENS", [1], "INT32")]
        inputs[0].set_data_from_numpy(np.asarray(tokens, np.int32))
        inputs[1].set_data_from_numpy(np.ones(1, np.int32))
        c.infer(HTTP_LM, inputs)
    torch.cuda.synchronize()
    ops.reset_launches()
    leg, doc, served, _, seconds = perf_socket_leg(
        server, tmp, "http", HTTP_LM, "none", extra=["--input-data", data],
        n=23)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    routes = {n: dict(r) for n, r in ops.ROUTES.items()}
    for kernel in ("int8_matmul", "paged_attention"):
        check(launches[kernel] > 0,
              f"{leg} launched {kernel} no time: {launches}")
    phase(23, "perf_http", leg=leg, levels=perf_levels(doc),
          requests=doc["requests"], server_successes=served,
          workload={"prompt_tokens": len(tokens), "max_tokens": 1},
          launches=launches, launches_by_route=routes, seconds=seconds,
          export=doc, **card)
    return launches, routes


def http_phase(card):
    """Phase 23: ResNet-50 (warmup: every bucket's graph) and the
    language set behind one Server with HTTP and gRPC.  (a) The direct
    path on the captured graphs (direct_path_leg); (b) phase 22's
    ResNet-50 wire and system-region legs over gRPC again, side by side;
    (c) ``python -m client_tpu_torch.perf -i http`` against ResNet-50 with
    --shared-memory none, system and cuda, and against HTTP_LM; then
    phase 24 on the same server (aio_phase), then phase 25 with it as
    replica A (balance_phase), then phase 26 on it (native_phase), then
    phase 27 (chaos_phase).  Returns the LM leg's (launches, routes)
    (launches_http in phase 20), phase 24's (launches_aio), phase 25's
    (launches_balance), phase 26's (launches_native and launches_tls)
    and phase 27's (launches_chaos)."""
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language, vision

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    resnet = vision.resnet50_model(warmup=True)
    models = [resnet] + language.language_models(device="cuda")
    engines = {m.name: m.closer.__self__ for m in models
               if m.closer is not None and m.name.startswith("lm_")}
    try:
        with Server(models=models, http_port=0, grpc_port=0,
                    with_default_models=False) as server:
            direct_path_leg(card, server, resnet)
            side = {}
            for shm in ("none", "system"):
                leg, doc, served, _, seconds = perf_socket_leg(
                    server, tmp, "grpc", "resnet50", shm, n=23)
                side[shm] = perf_levels(doc)
                phase(23, "perf_grpc_again", leg=leg, levels=side[shm],
                      requests=doc["requests"], seconds=seconds, **card)
            phase(23, "perf_grpc_side_by_side", model="resnet50",
                  levels=[{"level": w["level"],
                           "wire_infer_per_s": w["infer_per_s"],
                           "system_infer_per_s": s["infer_per_s"],
                           "wire_p50_us": w["p50_us"],
                           "system_p50_us": s["p50_us"]}
                          for w, s in zip(side["none"], side["system"])],
                  **card)
            mixed_socket_leg(card, server, tmp, side["none"])
            for shm in HTTP_SHM_LEGS:
                leg, doc, served, regions, seconds = perf_socket_leg(
                    server, tmp, "http", "resnet50", shm, n=23)
                phase(23, "perf_http", leg=leg, levels=perf_levels(doc),
                      requests=doc["requests"], server_successes=served,
                      cuda_regions_opened_over_ipc=regions,
                      seconds=seconds, export=doc, **card)
            launches, routes = http_lm_leg(card, server, tmp)
            PHASE_SECONDS[23] = time.monotonic() - t0
            phase(23, "http_done", seconds=PHASE_SECONDS[23], **card)
            aio = aio_phase(card, server, engines, tmp)
            balanced = balance_phase(card, server, resnet, engines, tmp)
            native, tls = native_phase(card, server, tmp)
            chaos = chaos_phase(card, server, engines, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, routes, aio, balanced, native, tls, chaos


# -- the asyncio clients, --async, two ranks, the service kinds (phase 24) ----

AIO_STREAMS = 8       # concurrent grpc.aio streams a batched LM, one loop
AIO_HTTP_CALLS = 16   # concurrent http.aio MAX_TOKENS-1 calls, one loop
AIO_LEVELS = "8:64:56"  # --async against the thread engine at 8 and 64
AIO_TOP = 64
# ResNet-50 runs of 24c, in this order: the thread engine and --async from
# the wire in turns, then --async from CUDA regions
AIO_RUNS = (("threads", "none"), ("async", "none"), ("threads", "none"),
            ("async", "cuda"))
AIO_RANK_LEVEL = "8"
# 24e's hermetic service kinds: (kind, model, --shape)
AIO_SERVICE_KINDS = (("torchserve", "resnet", "data:1,8"),
                     ("tfserve", "half_plus_two", "input:1,8"),
                     ("tfserve_rest", "half_plus_two", "instances:1,4"))


def aio_streams(addr, model, prompts, max_tokens, stop_after=None):
    """Phase 24a: one ``stream_infer`` a prompt over the port's grpc.aio
    client, all on one event loop and one channel.  Returns each stream's
    tokens; with *stop_after* (one prompt) the client closes the stream
    once it has read that many, which cancels the call."""
    from client_tpu_torch.grpc import aio as aiogrpc

    async def one(client, p):
        async def requests():
            yield {"model_name": model,
                   "inputs": grpc_lm_inputs(aiogrpc, p, max_tokens)}

        toks = []
        stream = client.stream_infer(requests(), stream_timeout=300)
        async for result, error in stream:
            check(error is None, f"{model} streamed an error over grpc.aio: "
                                 f"{error}")
            toks.append(int(result.as_numpy("TOKEN")[0]))
            if stop_after is not None and len(toks) == stop_after:
                break
        await stream.aclose()
        return toks

    async def run():
        async with aiogrpc.InferenceServerClient(addr) as client:
            return await asyncio.gather(*(one(client, p) for p in prompts))

    return asyncio.run(run())


def aio_http_lm(addr, model, prompts):
    """Phase 24b: one ``infer`` a prompt with MAX_TOKENS 1 over the port's
    http.aio client, all at once on one event loop.  Returns the tokens."""
    from client_tpu_torch.http import aio as aiohttpclient

    async def run():
        async with aiohttpclient.InferenceServerClient(addr) as c:
            results = await asyncio.gather(*(
                c.infer(model, grpc_lm_inputs(aiohttpclient, p, 1))
                for p in prompts))
        return [int(r.as_numpy("TOKEN")[0]) for r in results]

    return asyncio.run(run())


def aio_http_resnet(addr, x):
    """Phase 24b: ResNet-50 over the port's http.aio client: a binary wire
    request, then the CUDA shared-memory verbs (a region on the card of
    this process, which the server resolves through its broker): register,
    status, a request whose input lies in the region, unregister, status.
    Returns (wire answer, region answer, status while registered, status
    after)."""
    from client_tpu_torch.http import aio as aiohttpclient
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    name = f"aio_in_{os.getpid()}"
    h = cudashm.create_shared_memory_region(name, x.nbytes)
    cudashm.set_shared_memory_region(h, [x])

    async def run():
        async with aiohttpclient.InferenceServerClient(addr) as c:
            inp = aiohttpclient.InferInput("INPUT0", list(x.shape), "FP32")
            inp.set_data_from_numpy(x)
            out = aiohttpclient.InferRequestedOutput("OUTPUT0",
                                                     binary_data=True)
            wire = (await c.infer("resnet50", [inp], outputs=[out])
                    ).as_numpy("OUTPUT0")
            await c.register_cuda_shared_memory(
                name, cudashm.get_raw_handle(h), 0, x.nbytes)
            try:
                status = await c.get_cuda_shared_memory_status()
                inp = aiohttpclient.InferInput("INPUT0", list(x.shape),
                                               "FP32")
                inp.set_shared_memory(name, x.nbytes)
                region = (await c.infer("resnet50", [inp], outputs=[out])
                          ).as_numpy("OUTPUT0")
            finally:
                await c.unregister_cuda_shared_memory(name)
            return wire, region, status, (
                await c.get_cuda_shared_memory_status())

    try:
        return asyncio.run(run())
    finally:
        cudashm.destroy_shared_memory_region(h)


def os_thread_watch(samples):
    """A perf_socket_leg watcher: the OS thread count of the perf process
    (/proc/<pid>/status, Threads:) every 20 ms until it ends."""
    def watch(pid, stop):
        while not stop.is_set():
            try:
                with open(f"/proc/{pid}/status") as f:
                    for line in f:
                        if line.startswith("Threads:"):
                            samples.append(int(line.split()[1]))
            except OSError:
                pass
            stop.wait(0.02)

    return watch


def free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def service_kind_runs(tmp):
    """Phase 24e, started: ``python -m client_tpu_torch.perf
    --service-kind <kind> --hermetic`` for each of AIO_SERVICE_KINDS, a
    process each, at once (each starts only its host fake)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for kind, model, shape in AIO_SERVICE_KINDS:
        out = os.path.join(tmp, f"service_{kind}.json")
        procs[kind] = (out, popen(
            client_argv([
                sys.executable, "-m", "client_tpu_torch.perf", "-m", model,
                "--service-kind", kind, "--hermetic", "--shape", shape,
                "--concurrency-range", "1:2:1",
                "--measurement-interval", str(PERF_WINDOW_MS["socket"]),
                "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY,
                "--json-export", out]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=client_env(), cwd=here))
    return procs


def service_kind_results(card, procs, t0):
    """Phase 24e, ended: every service-kind run exits 0 with no failed
    request."""
    runs = {}
    try:
        for kind, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            stderr = client_start(24, f"--service-kind {kind} --hermetic",
                                  proc.args, stderr)
            check(proc.returncode == 0,
                  f"--service-kind {kind} --hermetic exited "
                  f"{proc.returncode}: {stderr[-3000:]}")
            with open(out) as f:
                doc = json.load(f)
            check(doc["requests"]["failed"] == 0
                  and doc["requests"]["completed"] > 0
                  and "Best: concurrency=" in stdout,
                  f"--service-kind {kind}: requests {doc['requests']}")
            runs[kind] = {"levels": perf_levels(doc),
                          "requests": doc["requests"]}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    phase(24, "aio_service_kinds", runs=runs,
          note="host only: each run against its in-process fake endpoint",
          seconds=time.monotonic() - t0, **card)


def aio_phase(card, server, engines, tmp):
    """Phase 24 on phase 23's server (ResNet-50 and the language set on
    the card).  (a) grpc.aio streams of both batched LMs against the sync
    client's, and one cancelled; (b) http.aio on lm_streaming_int8 with
    MAX_TOKENS 1, a binary ResNet-50 request and the CUDA verbs; the
    launch counts are reset just before each leg's aio calls and read
    just after them, and summed (launches_aio in phase 20); (c) perf
    --async against the thread engine on ResNet-50 with their OS threads;
    (d) two perf ranks through the rendezvous; (e) the three hermetic
    service kinds (run beside the others).  Returns (launches, routes)."""
    from client_tpu_torch import grpc as grpcclient
    from client_tpu_torch import http as httpclient
    from client_tpu_torch import ops
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner

    t0 = time.monotonic()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here}
    services = service_kind_runs(tmp)
    grpc_addr, http_addr = server.grpc_address, server.http_address
    prompt = language.encode_text(PROMPT)
    windows = []

    def window(fn, *args, **kw):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        windows.append((dict(ops.LAUNCHES),
                        {n: dict(r) for n, r in ops.ROUTES.items()}))
        return out

    # -- 24a grpc.aio streams ------------------------------------------------
    prompts = distinct_prompts(prompt, AIO_STREAMS)
    streams, near = {}, {}
    for model in ("lm_streaming_int8", "lm_streaming_batched"):
        streams[model] = window(aio_streams, grpc_addr, model, prompts,
                                GRPC_TOKENS)
    eng = engines["lm_streaming_batched"]
    used = eng.kv.used_blocks
    made = server.engine.metrics.get("ctpu_lm_tokens_total") or 0
    (stopped,) = window(aio_streams, grpc_addr, "lm_streaming_batched",
                        [prompt[:8]], GRPC_STOP_MAX,
                        stop_after=GRPC_STOP_AFTER)
    deadline = time.monotonic() + 30
    while eng.kv.used_blocks != used and time.monotonic() < deadline:
        time.sleep(0.01)
    made = server.engine.metrics.get("ctpu_lm_tokens_total") - made
    check(len(stopped) == GRPC_STOP_AFTER and eng.kv.used_blocks == used,
          f"a cancelled grpc.aio stream left {eng.kv.used_blocks} blocks "
          f"used, {used} before it")
    check(made <= GRPC_STOP_AFTER + GRPC_STOP_SLACK,
          f"the cancelled grpc.aio stream ran on: {made} tokens made, "
          f"{GRPC_STOP_AFTER} read")
    for model, got in streams.items():
        own = engines[model]
        sync = [grpc_stream(grpcclient, grpc_addr, model, p, GRPC_TOKENS)
                for p in prompts]
        near[model] = [agreement(tfm, own.params, own.cfg, p, g, w)
                       for p, g, w in zip(prompts, got, sync)]
    phase(24, "aio_grpc_streams", streams=AIO_STREAMS, tokens=GRPC_TOKENS,
          aio_vs_sync_client=near, near_tie=NEAR_TIE,
          cancelled_stream={"tokens_read": GRPC_STOP_AFTER,
                            "tokens_made": made,
                            "stream_window": BatchedLmRunner.stream_window,
                            "tokens_made_max": GRPC_STOP_AFTER
                            + GRPC_STOP_SLACK,
                            "max_tokens": GRPC_STOP_MAX,
                            "blocks_back_to": used},
          **card)

    # -- 24b http.aio ----------------------------------------------------------
    prompts = distinct_prompts(prompt, AIO_HTTP_CALLS)
    got = window(aio_http_lm, http_addr, "lm_streaming_int8", prompts)
    with httpclient.InferenceServerClient(http_addr) as c:
        want = [int(c.infer("lm_streaming_int8",
                            grpc_lm_inputs(httpclient, p, 1))
                    .as_numpy("TOKEN")[0]) for p in prompts]
    int8 = engines["lm_streaming_int8"]
    lm_near = [agreement(tfm, int8.params, int8.cfg, p, [g], [w])
               for p, g, w in zip(prompts, got, want)]
    x = vision_images(1, seed=24).numpy()
    wire, region, status, after = aio_http_resnet(http_addr, x)
    with httpclient.InferenceServerClient(http_addr) as c:
        inp = httpclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_data_from_numpy(x)
        sync = c.infer("resnet50", [inp]).as_numpy("OUTPUT0")
    check(np.array_equal(wire, sync),
          f"ResNet-50 over http.aio differs from the sync client's by "
          f"{np.abs(wire - sync).max()}")
    check(np.array_equal(region, wire),
          f"ResNet-50 from a CUDA region over http.aio differs from the "
          f"wire's by {np.abs(region - wire).max()}")
    name = f"aio_in_{os.getpid()}"
    check(name in [r["name"] for r in status]
          and name not in [r["name"] for r in after],
          f"CUDA regions over http.aio: {status}, then {after}")
    phase(24, "aio_http", lm_calls=AIO_HTTP_CALLS, model="lm_streaming_int8",
          max_tokens=1, aio_vs_sync_client=lm_near, near_tie=NEAR_TIE,
          resnet50_wire_equals_sync=True,
          resnet50_cuda_region_equals_wire=True, cuda_region=name, **card)
    launches = {n: sum(w[0][n] for w in windows) for n in windows[0][0]}
    routes = {n: {r: sum(w[1][n][r] for w in windows) for r in rs}
              for n, rs in windows[0][1].items()}

    # -- 24c --async against the thread engine ---------------------------------
    runs, threads = [], {}
    for i, (engine_kind, shm) in enumerate(AIO_RUNS):
        samples = []
        extra = ["--max-threads", str(AIO_TOP)] + (
            ["--async"] if engine_kind == "async" else [])
        leg, doc, served, regions, seconds = perf_socket_leg(
            server, tmp, "grpc", "resnet50", shm, extra=extra, env=env,
            levels=AIO_LEVELS, tag=f"{engine_kind}{i}",
            watch=os_thread_watch(samples), n=24)
        check(samples, f"{leg}: no OS thread count read")
        threads.setdefault(engine_kind, []).append(max(samples))
        runs.append({"engine": engine_kind, "shared_memory": shm,
                     "levels": perf_levels(doc), "requests": doc["requests"],
                     "server_successes": served, "os_threads_max":
                     max(samples), "cuda_regions_opened_over_ipc": regions,
                     "seconds": seconds})
        phase(24, "aio_perf", leg=leg, engine=engine_kind,
              levels=perf_levels(doc), requests=doc["requests"],
              server_successes=served, os_threads_max=max(samples),
              seconds=seconds, export=doc, **card)
    check(max(threads["async"]) < min(threads["threads"]),
          f"the --async runs had {threads['async']} OS threads at most, "
          f"the thread engine's {threads['threads']}")
    phase(24, "aio_perf_vs_threads", model="resnet50",
          os_threads_max=threads,
          os_threads_note="the most the perf process had over its run "
                          f"(levels {AIO_LEVELS}); the thread engine's is "
                          f"its level-{AIO_TOP} window",
          levels={f"{r['engine']} {r['shared_memory']} {i}": [
              {k: lv[k] for k in ("level", "infer_per_s", "p50_us",
                                  "p99_us")} for lv in r["levels"]]
              for i, r in enumerate(runs)}, **card)

    # -- 24d two ranks through the rendezvous ----------------------------------
    addr = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    before = success_counts(server, "resnet50")
    procs = [popen(
        client_argv(perf_argv(server, "grpc", "resnet50", "none", outs[r],
                              levels=AIO_RANK_LEVEL,
                              extra=["--world-size", "2", "--rank", str(r),
                                     "--rendezvous-addr", addr])),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=client_env(env), cwd=here) for r in range(2)]
    try:
        ends = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ends = [(out, client_start(24, f"resnet50 grpc none rank {r}", p.args,
                               err))
            for r, (p, (out, err)) in enumerate(zip(procs, ends))]
    after = success_counts(server, "resnet50")
    for r, (p, (_, err)) in enumerate(zip(procs, ends)):
        check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
    check("Aggregate across ranks:" in ends[0][0]
          and "Aggregate" not in ends[1][0],
          "the aggregate is not rank 0's alone")
    docs = []
    for out in outs:
        with open(out) as f:
            docs.append(json.load(f))
    completed = sum(d["requests"]["completed"] for d in docs)
    check(completed == after[0] - before[0] and after[1] == before[1]
          and all(d["requests"]["failed"] == 0 for d in docs),
          f"the ranks counted {[d['requests'] for d in docs]}, the server "
          f"{after[0] - before[0]} successes and {after[1] - before[1]} "
          "failures")
    aggregate = ends[0][0][ends[0][0].index("Aggregate across ranks:"):]
    phase(24, "aio_two_ranks", model="resnet50", level=int(AIO_RANK_LEVEL),
          requests=[d["requests"] for d in docs],
          server_successes=after[0] - before[0],
          levels=[perf_levels(d) for d in docs],
          aggregate=aggregate.strip().splitlines(), **card)

    # -- 24e the service kinds ---------------------------------------------------
    service_kind_results(card, services, t0)
    for name in ("int8_matmul", "paged_attention"):
        check(launches[name] > 0,
              f"the aio calls launched {name} no time: {launches}")
    PHASE_SECONDS[24] = time.monotonic() - t0
    phase(24, "aio_done", launches=launches, launches_by_route=routes,
          seconds=PHASE_SECONDS[24], **card)
    return launches, routes



# -- the replica set across two servers on the card (phase 25) -------------

BALANCE_HTTP_CALLS = 8   # 25a: MAX_TOKENS-1 int8 calls over HTTP
BALANCE_STREAMS = 4      # 25a: decoupled int8 token streams over gRPC
BALANCE_THREADS = 8      # 25b: ResNet-50 client threads
BALANCE_BEFORE_S = 2.0   # 25b: load before the kill, then after it
BALANCE_AFTER_S = 2.0
BALANCE_LEVEL = "8"      # 25c: perf_analyzer's concurrency across A,B
BALANCE_WINDOW_MS = 500
BALANCE_CHURN_S = "0.5"  # 25c: --churn-soak's tick
BALANCE_MODEL = "lm_streaming_int8"


def replica_argv():
    """The command of one replica process: the port's server on the card
    with ResNet-50 and the language set from the seeds phase 23's server
    used, HTTP and gRPC on free ports."""
    return [sys.executable, "-m", "client_tpu_torch.serve",
            "--models", "resnet,language", "--http-port", "0",
            "--grpc-port", "0"]


def start_replica(tmp, tag):
    """Start a replica process.  Returns (process, its stderr file)."""
    here = os.path.dirname(os.path.abspath(__file__))
    err = open(os.path.join(tmp, f"replica_{tag}.err"), "w+")
    proc = popen(replica_argv(), stdout=subprocess.PIPE,
                            stderr=err, text=True, cwd=here,
                            env={**os.environ, "PYTHONPATH": here})
    return proc, err


def replica_addresses(proc, err, timeout=300):
    """Read a replica's HTTP and gRPC lines off a thread that goes on
    draining its output.  Returns (http address, grpc address)."""
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    found, deadline = {}, time.monotonic() + timeout
    while len(found) < 2:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None or time.monotonic() > deadline:
                err.seek(0)
                fail(f"replica exited {proc.poll()} before serving: "
                     f"{err.read()[-3000:]}")
            continue
        for kind in ("HTTP", "gRPC"):
            prefix = f"client_tpu_torch.serve: {kind} on "
            if line.startswith(prefix):
                found[kind] = line[len(prefix):].strip()
    return found["HTTP"], found["gRPC"]


def stop_replica(proc, err):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)
    err.close()


def model_successes(http_addr, model):
    """(success, fail) counts of *model* from a server's statistics."""
    _, body, _ = http(http_addr, f"/v2/models/{model}/stats")
    stats = json.loads(body)["model_stats"][0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


def resnet_answers(model, x):
    """Every row ResNet-50 gives for image *x* in each group the
    BALANCE_THREADS one-row clients can form: n copies of it padded with
    zero rows to the batcher's bucket for n, as the batcher pads them.  A
    served answer is bit-equal to one of these rows (a bucket graph
    replays its eager forward bit for bit, phase 13)."""
    from client_tpu_torch.serve.dynamic_batcher import _bucket

    rows = set()
    with torch.no_grad():
        for n in range(1, BALANCE_THREADS + 1):
            batch = np.zeros((_bucket(n, model.max_batch_size),)
                             + x.shape[1:], np.float32)
            batch[:n] = x
            out = model.fn({"INPUT0": batch}, {}, None)
            out = out["OUTPUT0"].float().cpu().numpy()
            rows.update(out[i].tobytes() for i in range(n))
    return rows


def lm_alone(a, grpcclient, httpclient, prompt):
    """25a's prompts and the sync client's answers from A alone: tokens
    of MAX_TOKENS-1 HTTP calls and of gRPC token streams.  Returns
    (calls, their tokens, stream prompts, their tokens)."""
    calls = distinct_prompts(prompt, BALANCE_HTTP_CALLS)
    streams = distinct_prompts(prompt[::-1], BALANCE_STREAMS)
    with httpclient.InferenceServerClient(a["http"]) as c:
        want_http = [int(c.infer(BALANCE_MODEL,
                                 grpc_lm_inputs(httpclient, p, 1))
                         .as_numpy("TOKEN")[0]) for p in calls]
    want_streams = [grpc_stream(grpcclient, a["grpc"], BALANCE_MODEL, p,
                                GRPC_TOKENS) for p in streams]
    return calls, want_http, streams, want_streams


def balanced_lm(card, a, b, engines, grpcclient, httpclient, balance,
                metrics, tfm, alone):
    """25a: MAX_TOKENS-1 int8 calls over HTTP and decoupled token streams
    over gRPC, round-robin across A and B through the port's
    ReplicatedClient, against the sync client's answers from A alone
    (*alone*, from lm_alone)."""
    int8 = engines[BALANCE_MODEL]
    calls, want_http, streams, want_streams = alone
    registry = metrics.Registry()
    http_pool = balance.EndpointPool(
        [a["http"], b["http"]], policy="round-robin",
        observer=metrics.BalancerMetricsObserver(registry))
    grpc_pool = balance.EndpointPool(
        [a["grpc"], b["grpc"]], policy="round-robin",
        observer=metrics.BalancerMetricsObserver(registry))
    with balance.ReplicatedClient(http_pool, transport="http",
                                  probe_interval_s=None) as client:
        got_http = [int(client.infer(BALANCE_MODEL,
                                     grpc_lm_inputs(httpclient, p, 1))
                        .as_numpy("TOKEN")[0]) for p in calls]
    got_streams = [None] * BALANCE_STREAMS
    errors = []

    def one_stream(i):
        toks, done = [], threading.Event()

        def on_response(result, error):
            if error is not None:
                errors.append(repr(error))
                done.set()
                return
            toks.append(int(result.as_numpy("TOKEN")[0]))
            if len(toks) == GRPC_TOKENS:
                done.set()

        with balance.ReplicatedClient(grpc_pool, transport="grpc",
                                      probe_interval_s=None) as client:
            client.start_stream(on_response, stream_timeout=300)
            client.async_stream_infer(BALANCE_MODEL, grpc_lm_inputs(
                grpcclient, streams[i], GRPC_TOKENS))
            done.wait(timeout=300)
            client.stop_stream()
        got_streams[i] = toks

    # each ReplicatedClient's stream leases its replica in turn from the
    # shared pool: A, B, A, B
    threads = []
    for i in range(BALANCE_STREAMS):
        threads.append(threading.Thread(target=one_stream, args=(i,)))
        threads[-1].start()
        time.sleep(0.05)
    for th in threads:
        th.join(timeout=300)
    check(not errors and all(g is not None for g in got_streams),
          f"balanced gRPC streams: {errors}")
    near = {
        "http_max_tokens_1": [
            agreement(tfm, int8.params, int8.cfg, p, [g], [w])
            for p, g, w in zip(calls, got_http, want_http)],
        "grpc_streams": [
            agreement(tfm, int8.params, int8.cfg, p, g, w)
            for p, g, w in zip(streams, got_streams, want_streams)]}
    routed = {}
    for transport, pool in (("http", http_pool), ("grpc", grpc_pool)):
        counts = {url: int(registry.get("ctpu_client_routed_total",
                                        {"endpoint": url}) or 0)
                  for url in pool.urls()}
        check(max(counts.values()) - min(counts.values()) <= 1
              and min(counts.values()) > 0,
              f"{transport} routed {counts}: not within one of even")
        routed[transport] = counts
    phase(25, "balance_lm", model=BALANCE_MODEL,
          http_calls=BALANCE_HTTP_CALLS, streams=BALANCE_STREAMS,
          stream_tokens=GRPC_TOKENS, routed=routed,
          vs_a_alone=near, near_tie=NEAR_TIE, **card)


def kill_under_load(card, a, b_proc, b, resnet, balance, metrics, resilience,
                    httpclient):
    """25b: ResNet-50 from BALANCE_THREADS threads through a
    least-inflight ReplicatedClient with probes on; B SIGKILLed mid-load.
    Zero client errors, every answer bit-equal to one of A's, B
    UNREACHABLE and routed no more once it is."""
    x = vision_images(1, seed=25).numpy()
    want = resnet_answers(resnet, x)
    registry = metrics.Registry()
    pool = balance.EndpointPool(
        [a["http"], b["http"]], policy="least-inflight",
        observer=metrics.BalancerMetricsObserver(registry),
        failure_threshold=2, reset_timeout_s=60.0)
    client = balance.ReplicatedClient(
        pool, transport="http", probe_interval_s=0.05,
        retry_policy=resilience.RetryPolicy(
            max_attempts=8, initial_backoff_s=0.02, max_backoff_s=0.2,
            deadline_s=20.0))

    def routed(url):
        return int(registry.get("ctpu_client_routed_total",
                                {"endpoint": url}) or 0)

    stop = threading.Event()
    lock = threading.Lock()
    records, errors, unknown = [], [], []
    seen = {}

    def worker():
        inp = httpclient.InferInput("INPUT0", list(x.shape), "FP32")
        inp.set_data_from_numpy(x, binary_data=True)
        while not stop.is_set():
            t = time.monotonic()
            try:
                out = client.infer("resnet50", [inp]).as_numpy("OUTPUT0")
            except Exception as e:  # noqa: BLE001 - counted, checked below
                with lock:
                    errors.append(repr(e))
                continue
            row = np.ascontiguousarray(out[0], np.float32).tobytes()
            with lock:
                records.append((t, time.monotonic() - t))
                if row not in want:
                    unknown.append(row)
                seen[row] = seen.get(row, 0) + 1

    def monitor():
        while not stop.is_set():
            if pool.states()[b["http"]] == "UNREACHABLE":
                mark["at"] = time.monotonic()
                # a lease taken just before the transition has called
                # on_route within this
                time.sleep(0.1)
                mark["routed"] = routed(b["http"])
                return
            time.sleep(0.002)

    mark = {}
    threads = [threading.Thread(target=worker)
               for _ in range(BALANCE_THREADS)]
    watcher = threading.Thread(target=monitor)
    try:
        for th in threads:
            th.start()
        time.sleep(BALANCE_BEFORE_S)
        routed_before = {u: routed(u) for u in pool.urls()}
        t_kill = time.monotonic()
        watcher.start()
        os.kill(b_proc.pid, signal.SIGKILL)
        time.sleep(BALANCE_AFTER_S)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
        watcher.join(timeout=30)
        states = pool.states()
        routed_end = {u: routed(u) for u in pool.urls()}
        client.close()
    b_proc.wait(timeout=60)
    check(not errors, f"{len(errors)} client-visible errors across the "
                      f"kill: {errors[:3]}")
    check(not unknown, f"{len(unknown)} ResNet-50 answers equal none of A's")
    check(states[b["http"]] == "UNREACHABLE" and "at" in mark,
          f"the pool's view after the kill: {states}")
    check(routed_end[b["http"]] == mark["routed"],
          f"B routed {routed_end[b['http']] - mark['routed']} more "
          "requests after it was UNREACHABLE")
    check(routed_before[b["http"]] > 0 and routed_before[a["http"]] > 0,
          f"before the kill: routed {routed_before}")

    def pct(lat, q):
        return float(np.percentile(np.asarray(lat) * 1e3, q)) if lat else None

    before = [d for t, d in records if t + d < t_kill]
    after = [d for t, d in records if t >= mark["at"]]
    spanning = [d for t, d in records if t < mark["at"] and t + d >= t_kill]
    phase(25, "balance_kill", model="resnet50", threads=BALANCE_THREADS,
          policy="least-inflight", probe_interval_s=0.05,
          requests=len(records), errors=len(errors),
          answers_distinct=len(seen), answers_bit_equal_to_a=True,
          a_rows_over_groups=len(want), group_rows=[1, BALANCE_THREADS],
          failovers=int(registry.get("ctpu_client_failovers_total",
                                     {"endpoint": b["http"]}) or 0),
          unreachable_after_s=mark["at"] - t_kill,
          routed_before_kill=routed_before, routed_end=routed_end,
          b_routed_at_unreachable=mark["routed"],
          p99_ms_before=pct(before, 99), p50_ms_before=pct(before, 50),
          requests_before=len(before),
          p99_ms_after=pct(after, 99), p50_ms_after=pct(after, 50),
          requests_after=len(after), p99_ms_spanning=pct(spanning, 99),
          requests_spanning=len(spanning), states=states, **card)


def perf_across(a_http, b_http, urls, protocol, tmp, extra=(), tag=""):
    """One ``python -m client_tpu_torch.perf -u A,B`` run on ResNet-50.
    Returns (JSON export, stdout, each server's success delta)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, f"balance_{protocol}{tag}.json")
    argv = [sys.executable, "-m", "client_tpu_torch.perf", "-i", protocol,
            "-m", "resnet50", "-u", ",".join(urls),
            "--concurrency-range", BALANCE_LEVEL,
            "--measurement-interval", str(BALANCE_WINDOW_MS),
            "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY,
            "--json-export", out, *extra]
    before = {u: model_successes(h, "resnet50")
              for u, h in zip(urls, (a_http, b_http))}
    proc = subprocess.run(client_argv(argv), capture_output=True, text=True,
                          cwd=here, env=client_env(), timeout=300)
    proc.stderr = client_start(
        25, f"resnet50 {protocol} -u A,B {' '.join(extra)}".strip(),
        proc.args, proc.stderr)
    check(proc.returncode == 0, f"perf -i {protocol} -u {urls} {extra} "
                                f"exited {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    after = {u: model_successes(h, "resnet50")
             for u, h in zip(urls, (a_http, b_http))}
    with open(out) as f:
        doc = json.load(f)
    delta = {u: after[u][0] - before[u][0] for u in urls}
    check(all(after[u][1] == before[u][1] for u in urls)
          and doc["requests"]["failed"] == 0
          and all(r["error_count"] == 0 for r in doc["results"]),
          f"perf -u {urls} {extra}: {doc['requests']}, failures "
          f"{before} -> {after}")
    return doc, proc.stdout, delta


def balance_phase(card, server, resnet, engines, tmp):
    """Phase 25 on phase 23's server (A): a second server process (B) on
    the card serving the same models from the same seeds, and B's
    replacement started with it.  (a) balanced LM answers against A
    alone; (b) B SIGKILLed under ResNet-50 load; (c) perf_analyzer -u A,B
    over gRPC and HTTP, then --churn-soak.  The launch counts in A's
    process are reset before (a)'s balanced calls and read after (c)
    (launches_balance in phase 20).  Returns (launches, routes)."""
    from client_tpu_torch import balance, ops, resilience
    from client_tpu_torch import grpc as grpcclient
    from client_tpu_torch import http as httpclient
    from client_tpu_torch.serve import metrics
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm

    t0 = time.monotonic()
    replicas = [start_replica(tmp, tag) for tag in ("b", "b2")]
    try:
        a = {"http": server.http_address, "grpc": server.grpc_address}
        b_http, b_grpc = replica_addresses(*replicas[0])
        b2_http, b2_grpc = replica_addresses(*replicas[1])
        b = {"http": b_http, "grpc": b_grpc}
        prompt = language.encode_text(PROMPT)
        x = vision_images(1, seed=26).numpy()
        for addr in (b_http, b2_http):
            # each replica captures its engine's graphs at its first
            # request, and its ResNet-50 buckets at their first use
            with httpclient.InferenceServerClient(addr) as c:
                c.infer(BALANCE_MODEL, grpc_lm_inputs(httpclient, prompt, 1))

            def hit(addr=addr):
                with httpclient.InferenceServerClient(addr) as c:
                    inp = httpclient.InferInput("INPUT0", list(x.shape),
                                                "FP32")
                    inp.set_data_from_numpy(x)
                    for _ in range(4):
                        c.infer("resnet50", [inp])

            warm = [threading.Thread(target=hit)
                    for _ in range(BALANCE_THREADS)]
            for th in warm:
                th.start()
            for th in warm:
                th.join(timeout=300)
        phase(25, "balance_replicas", a=a, b=b,
              b_replacement={"http": b2_http, "grpc": b2_grpc},
              replica_argv=replica_argv()[1:],
              seconds=time.monotonic() - t0, **card)

        alone = lm_alone(a, grpcclient, httpclient, prompt)
        torch.cuda.synchronize()
        ops.reset_launches()
        balanced_lm(card, a, b, engines, grpcclient, httpclient, balance,
                    metrics, tfm, alone)
        kill_under_load(card, a, replicas[0][0], b, resnet, balance,
                        metrics, resilience, httpclient)

        # -- 25c perf_analyzer across A and B's replacement -----------------
        runs = {}
        for protocol in ("grpc", "http"):
            urls = ([a["grpc"], b2_grpc] if protocol == "grpc"
                    else [a["http"], b2_http])
            doc, stdout, delta = perf_across(a["http"], b2_http, urls,
                                             protocol, tmp)
            per = doc["requests"]["per_endpoint"]
            check(all(f"    endpoint {u}: " in stdout for u in urls),
                  f"perf -i {protocol} -u A,B printed no per-endpoint "
                  f"split: {stdout[-2000:]}")
            check({u: per[u]["completed"] for u in urls} == delta
                  and all(per[u]["failed"] == 0 for u in urls)
                  and all(v > 0 for v in delta.values()),
                  f"perf -i {protocol} per endpoint {per}, servers "
                  f"{delta}")
            runs[protocol] = {"levels": perf_levels(doc),
                              "per_endpoint": per, "server_successes": delta,
                              "split": [line.strip() for line in
                                        stdout.splitlines()
                                        if line.startswith("    endpoint ")]}
            phase(25, "balance_perf", protocol=protocol, urls=urls,
                  **runs[protocol], **card)
        urls = [a["http"], b2_http]
        doc, stdout, delta = perf_across(
            a["http"], b2_http, urls, "http", tmp,
            extra=["--churn-soak", BALANCE_CHURN_S], tag="_churn")
        check(doc["requests"]["failed"] == 0
              and sum(delta.values()) == doc["requests"]["completed"],
              f"--churn-soak: {doc['requests']}, servers {delta}")
        phase(25, "balance_churn", churn_soak_s=float(BALANCE_CHURN_S),
              levels=perf_levels(doc), requests=doc["requests"],
              per_endpoint=doc["requests"].get("per_endpoint"),
              server_successes=delta, **card)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        routes = {n: dict(r) for n, r in ops.ROUTES.items()}
    finally:
        for proc, err in replicas:
            stop_replica(proc, err)
    for name in ("int8_matmul", "paged_attention"):
        check(launches[name] > 0,
              f"the balanced calls launched {name} no time in A: "
              f"{launches}")
    PHASE_SECONDS[25] = time.monotonic() - t0
    phase(25, "balance_done", launches=launches, launches_by_route=routes,
          seconds=PHASE_SECONDS[25], **card)
    return launches, routes


# -- the native worker, procpool and SSL on phase 23's server (phase 26) -----

NATIVE_LEVELS = "1:8:7"   # 26a: --native-loadgen's concurrency levels
NATIVE_WINDOW_MS = 500
NATIVE_LEGS = (("none", False), ("cuda", False), ("cuda", True))
NATIVE_LM_STREAMS = 8     # 26a: the worker's decoupled int8 streams ...
NATIVE_LM_PROMPT = 64     # ... of a 64-token prompt (TOKENS:INT32:64=7)
NATIVE_LM_TOKENS = 16     # ... and MAX_TOKENS 16
NATIVE_LM_S = 2.0         # the worker's measured seconds on the LM
POOL_PROCESSES = 2        # 26b: spawned load processes, 4 requests each
POOL_CONCURRENCY = 8
POOL_WINDOW_S = 1.0
TLS_LEVEL = "8"           # 26c: the concurrency of every TLS leg
TLS_WINDOW_MS = 250
NATIVE_LAUNCHES_IN = ("launches_native: phase 26a's native-worker streams; "
                      "launches_tls: phase 26c's HTTPS LM leg")
# phase 22's Python gRPC wire leg at concurrency 8 (ResNet-50), set there
# with the leg's description ("leg") and printed beside the native
# worker's in phase 26a
PYTHON_GRPC_AT_8 = {}
_NATIVE_LINE = re.compile(
    r"^(Concurrency|Request rate|Sequences): (\S+), throughput: (\S+) "
    r"infer/sec \(native\), p50 (\d+) usec, p99 (\d+) usec, errors (\d+)"
    r".*, (stable|UNSTABLE) over (\d+) windows$")


def make_tls_certs(tmp):
    """Self-signed certificates made by ``openssl``: the server's, for
    localhost and 127.0.0.1 (the relay's), and a client's.  Returns
    {"server": (cert, key), "client": (cert, key)}."""
    paths = {}
    for who, subject, ext in (
            ("server", "/CN=localhost",
             ["-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"]),
            ("client", "/CN=perf-client", [])):
        cert = os.path.join(tmp, f"tls_{who}.pem")
        key = os.path.join(tmp, f"tls_{who}.key")
        proc = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "2", "-subj", subject,
             *ext], capture_output=True, text=True)
        check(proc.returncode == 0,
              f"openssl made no {who} certificate: {proc.stderr[-1000:]}")
        paths[who] = (cert, key)
    return paths


def start_relay(backend, cert, key, alpn="", client_ca=""):
    """A TlsRelay in a process of its own (off the server's interpreter
    lock), torch blocked: tools/tls_relay.py through tools/torch_free.py.
    Its address is the first line it prints (relay_address)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return popen(client_argv([sys.executable, TLS_RELAY, backend, cert, key,
                              alpn, client_ca]),
                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE, text=True, cwd=here,
                 env=client_env())


def relay_address(proc):
    line = proc.stdout.readline().strip()
    if not line:
        fail(f"TLS relay exited {proc.wait(timeout=30)}: "
             f"{proc.stderr.read()[-2000:]}")
    return line


def stop_relay(proc, label=None):
    """End a relay process; with *label*, note its start (client_start)."""
    try:
        proc.stdin.close()
        proc.wait(timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        proc.kill()
        proc.wait()
    if label is not None:
        client_start(26, label, proc.args, proc.stderr.read(), waits=True)


def perf_cli(server, model, tmp, tag, args, export=True):
    """One ``python -m client_tpu_torch.perf -m <model> <args>`` process
    against *model* behind this process's *server*, torch blocked unless
    *args* need it (client_argv).  Returns (the process, whose stderr no
    longer holds the start line, its JSON export or None, the server's
    (success, fail) deltas)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, f"p26_{tag}.json")
    argv = [sys.executable, "-m", "client_tpu_torch.perf", "-m", model,
            *args, *(["--json-export", out] if export else [])]
    before = success_counts(server, model)
    proc = subprocess.run(client_argv(argv), capture_output=True, text=True,
                          cwd=here, env=client_env(), timeout=300)
    after = success_counts(server, model)
    proc.stderr = client_start(26, f"{model} {tag}", proc.args, proc.stderr)
    doc = None
    if export and proc.returncode == 0:
        with open(out) as f:
            doc = json.load(f)
    return proc, doc, (after[0] - before[0], after[1] - before[1])


def native_levels(stdout):
    """The levels of a --native-loadgen sweep's output."""
    levels = []
    for line in stdout.splitlines():
        m = _NATIVE_LINE.match(line.strip())
        if m:
            levels.append({"level": float(m.group(2)),
                           "infer_per_s": float(m.group(3)),
                           "p50_us": int(m.group(4)),
                           "p99_us": int(m.group(5)),
                           "errors": int(m.group(6)),
                           "stable": m.group(7) == "stable",
                           "windows": int(m.group(8))})
    return levels


def native_leg(card, server, tmp):
    """Phase 26a: perf_worker built from this checkout by g++ alone (a
    build that fails fails the phase), ldd's list of its libraries, then
    --native-loadgen on ResNet-50 from the wire and from CUDA regions
    (with and without --cuda-shm-sync), the wire leg at 8 beside phase
    22's Python gRPC leg, then the worker's decoupled streams on
    lm_streaming_int8 with the launch counts reset just before and read
    just after.  Returns (launches, routes)."""
    from client_tpu_torch import ops
    from client_tpu_torch.perf import native_worker
    from client_tpu_torch.perf.native_worker import (
        build_native_worker,
        run_native_worker,
    )
    from client_tpu_torch.utils import InferenceServerException

    t0 = time.monotonic()
    try:
        binary = build_native_worker()
    except InferenceServerException as e:
        fail(f"phase 26a: the native worker did not build: {e}")
    build_s = time.monotonic() - t0
    ldd = subprocess.run(["ldd", binary], capture_output=True, text=True)
    libraries = [ln.strip() for ln in ldd.stdout.splitlines() if ln.strip()]
    check(ldd.returncode == 0 and libraries
          and not any("libprotobuf" in ln for ln in libraries),
          f"ldd of the native worker exited {ldd.returncode}: "
          f"{ldd.stdout[-2000:]} {ldd.stderr[-1000:]}")
    built = native_worker.last_build
    check(built is None or not any("protoc" in arg or "protobuf" in arg
                                   for cmd in built["commands"]
                                   for arg in cmd),
          f"the native worker's build named protoc or protobuf: {built}")
    phase(26, "native_build", build_s=build_s,
          compiled=built is not None,
          compile_s=built and built["seconds"],
          commands=built and [" ".join(os.path.relpath(a, HERE)
                                       if a.startswith(HERE) else a
                                       for a in cmd)
                              for cmd in built["commands"]],
          libraries=libraries,
          binary=os.path.relpath(binary, HERE), **card)
    native_at_8 = None
    for shm, sync in NATIVE_LEGS:
        args = ["-u", server.grpc_address, "--native-loadgen",
                "--concurrency-range", NATIVE_LEVELS,
                "--measurement-interval", str(NATIVE_WINDOW_MS),
                "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY]
        if shm != "none":
            args += ["--shared-memory", shm,
                     "--output-shared-memory-size", "4000"]
        if sync:
            args.append("--cuda-shm-sync")
        leg = f"resnet50 native {shm}" + (" --cuda-shm-sync" if sync else "")
        proc, _, delta = perf_cli(server, "resnet50", tmp,
                                  f"native_{shm}_{int(sync)}", args,
                                  export=False)
        levels = native_levels(proc.stdout)
        check(proc.returncode == 0 and len(levels) == 2 and delta[1] == 0
              and delta[0] > 0 and all(lv["errors"] == 0 for lv in levels),
              f"{leg} exited {proc.returncode}, server {delta}, levels "
              f"{levels}: {proc.stderr[-2000:]}")
        phase(26, "native_resnet", leg=leg, levels=levels,
              server_successes=delta[0], **card)
        if shm == "none":
            native_at_8 = next(lv for lv in levels if lv["level"] == 8)
    keys = ("infer_per_s", "p50_us", "p99_us", "stable")
    python_at_8 = PYTHON_GRPC_AT_8 or None
    phase(26, "native_vs_python_at_8", model="resnet50",
          native={k: native_at_8[k] for k in keys},
          python=python_at_8 and {k: python_at_8[k] for k in keys},
          native_over_python=(python_at_8 and native_at_8["infer_per_s"]
                              / python_at_8["infer_per_s"]),
          native_leg="phase 26a, --native-loadgen from the wire on phase "
                     "23's server (ResNet-50 and the language set)",
          python_leg=python_at_8 and python_at_8["leg"], **card)
    before = success_counts(server, HTTP_LM)
    torch.cuda.synchronize()
    ops.reset_launches()
    report = run_native_worker(
        server.grpc_address, HTTP_LM, binary=binary,
        concurrency=NATIVE_LM_STREAMS, duration_s=NATIVE_LM_S,
        warmup_s=0.5, decoupled=True,
        wire_inputs=[("TOKENS", "INT32", [NATIVE_LM_PROMPT], 7),
                     ("MAX_TOKENS", "INT32", [1], NATIVE_LM_TOKENS)])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    routes = {n: dict(r) for n, r in ops.ROUTES.items()}
    after = success_counts(server, HTTP_LM)
    served = after[0] - before[0]
    # the worker counts the streams that ended inside its measured
    # window; the server also counts the warm-up's and the drain's
    check(report["mode"] == "decoupled" and report["errors"] == 0
          and 0 < report["ok"] <= served and after[1] == before[1]
          and report["responses"] >= max(report["ok"] - NATIVE_LM_STREAMS,
                                         1) * NATIVE_LM_TOKENS,
          f"the worker's decoupled {HTTP_LM}: {report}, server {served} "
          f"successes, {after[1] - before[1]} failures")
    for kernel in ("int8_matmul", "paged_attention"):
        check(launches[kernel] > 0,
              f"the worker's {HTTP_LM} streams launched {kernel} no time: "
              f"{launches}")
    phase(26, "native_lm", model=HTTP_LM, streams=NATIVE_LM_STREAMS,
          workload={"prompt_tokens": NATIVE_LM_PROMPT,
                    "max_tokens": NATIVE_LM_TOKENS},
          report={k: v for k, v in report.items() if k != "windows"},
          server_successes=served, launches=launches,
          launches_by_route=routes,
          sequence_leg="not run: phase 23's server serves no "
                       "simple_sequence", seconds_26a=time.monotonic() - t0,
          **card)
    return launches, routes


def procpool_leg(card, server, tmp):
    """Phase 26b: run_completion_multiproc, 2 spawned processes x 4,
    against ResNet-50 from CUDA regions this process made and registered,
    which the workers reference by name (export_region_specs);
    nvidia-smi's compute apps sampled while they run."""
    import multiprocessing

    from client_tpu_torch.perf import (
        BackendKind,
        ClientBackendFactory,
        DataLoader,
        ModelParser,
        create_infer_data_manager,
    )
    from client_tpu_torch.perf.procpool import (
        export_region_specs,
        run_completion_multiproc,
    )

    t0 = time.monotonic()
    backend = ClientBackendFactory.create(BackendKind.TRITON_GRPC,
                                          url=server.grpc_address)
    parser = ModelParser.create(backend, "resnet50", "", batch_size=1)
    loader = DataLoader(parser.inputs, batch_size=1)
    loader.generate_data()
    manager = create_infer_data_manager(
        backend, loader, parser.inputs, parser.outputs,
        shared_memory="cuda", output_shm_byte_size=4000, device="cuda")
    manager.init()
    samples, workers, stop, marks = [], [], threading.Event(), {}

    def compute_apps():
        q = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                            "--format=csv,noheader"],
                           capture_output=True, text=True)
        return sorted(int(x) for x in q.stdout.split()
                      if x.strip().isdigit())

    def sample():
        while not stop.is_set():
            samples.append(compute_apps())
            stop.wait(0.25)

    sampler = threading.Thread(target=sample, daemon=True)

    def on_go():
        marks["go"] = time.monotonic()
        workers.extend(p.pid for p in multiprocessing.active_children())
        sampler.start()

    try:
        regions = manager.region_names()
        input_specs, output_specs = export_region_specs(
            manager, parser.inputs, loader)
        spec = {"mode": "shm_ref", "num_streams": loader.num_streams,
                "steps_per_stream": [loader.num_steps(s)
                                     for s in range(loader.num_streams)],
                "input_specs": input_specs, "output_specs": output_specs}
        baseline = compute_apps()
        before = success_counts(server, "resnet50")
        t_start = time.monotonic()
        res = run_completion_multiproc(
            server.grpc_address, "resnet50", processes=POOL_PROCESSES,
            concurrency=POOL_CONCURRENCY, window_s=POOL_WINDOW_S,
            warmup_s=0.5, spec=spec, on_go=on_go)
        t_end = time.monotonic()
        after = success_counts(server, "resnet50")
    finally:
        stop.set()
        if sampler.is_alive():
            sampler.join(timeout=30)
        manager.cleanup()
        backend.close()
    served = after[0] - before[0]
    seen = sorted({pid for s in samples for pid in s})
    check(res.error_count == 0 and res.completed_requests > 0
          and res.requests == (served, 0) and after[1] == before[1],
          f"procpool: {res.requests} requests, {res.completed_requests} "
          f"in the window, {res.error_count} errors; the server "
          f"{served} successes, {after[1] - before[1]} failures")
    # a worker with a CUDA context would show as a compute app of its own,
    # whatever pid nvidia-smi reads for it in this PID namespace
    check(len(workers) == POOL_PROCESSES and samples
          and not set(workers) & set(seen)
          and all(len(s) <= len(baseline) for s in samples),
          f"procpool workers {workers}, nvidia-smi compute apps {seen} "
          f"({len(samples)} samples; before the workers: {baseline})")
    phase(26, "procpool", model="resnet50", shared_memory="cuda",
          processes=res.processes, concurrency=res.concurrency,
          infer_per_s=res.throughput, p50_us=res.percentiles_us.get(50),
          p99_us=res.percentiles_us.get(99), window_s=res.window_s,
          completed_in_window=res.completed_requests,
          requests=list(res.requests), server_successes=served,
          worker_pids=workers, smi_compute_pids=seen,
          smi_compute_pids_before=baseline, smi_samples=len(samples),
          regions=regions, workers_ready_s=marks["go"] - t_start,
          run_s=t_end - marks["go"], seconds=time.monotonic() - t0,
          **card)


def tls_leg(card, server, tmp):
    """Phase 26c: python -m client_tpu_torch.perf through TLS relays in
    front of this process's server: ResNet-50 at 8 over gRPC (ALPN h2,
    the root certificate) and HTTP (the CA), each followed by the plain
    wire; lm_streaming_int8 over HTTPS (MAX_TOKENS 1) with the launch
    counts reset just before and read just after; --ssl-https-verify-peer
    0 with no CA; a relay that requires a client certificate, with it
    (passes) and without it (exits non-zero, nothing served).  Every
    count equals its server's.  Returns (launches, routes)."""
    from client_tpu_torch import ops

    t0 = time.monotonic()
    certs = make_tls_certs(tmp)
    cert, key = certs["server"]
    client_cert, client_key = certs["client"]
    procs = {"grpc": start_relay(server.grpc_address, cert, key, "h2"),
             "http": start_relay(server.http_address, cert, key),
             "mtls": start_relay(server.http_address, cert, key,
                                 client_ca=client_cert)}
    try:
        relays = {name: relay_address(p) for name, p in procs.items()}
        level = ["--concurrency-range", TLS_LEVEL,
                 "--measurement-interval", str(TLS_WINDOW_MS),
                 "--max-trials", str(PERF_TRIALS), "-s", PERF_STABILITY]
        legs = (
            ("grpc tls", "grpc",
             ["-i", "grpc", "--ssl-grpc-use-ssl",
              "--ssl-grpc-root-certifications-file", cert]),
            ("grpc plain", None, ["-i", "grpc"]),
            ("http tls", "http",
             ["-i", "http", "--ssl-https-ca-certificates-file", cert]),
            ("http plain", None, ["-i", "http"]),
            ("http verify-peer 0", "http",
             ["-i", "http", "--ssl-https-verify-peer", "0"]),
            ("http mtls", "mtls",
             ["-i", "http", "--ssl-https-ca-certificates-file", cert,
              "--ssl-https-client-certificate-file", client_cert,
              "--ssl-https-private-key-file", client_key]))
        for leg, relay, args in legs:
            url = (relays[relay] if relay else
                   server.grpc_address if args[1] == "grpc" else
                   server.http_address)
            proc, doc, delta = perf_cli(server, "resnet50", tmp,
                                        leg.replace(" ", "_"),
                                        args + ["-u", url] + level)
            check(proc.returncode == 0 and delta[1] == 0 and delta[0] > 0
                  and doc["requests"] == {"completed": delta[0],
                                          "failed": 0},
                  f"{leg} exited {proc.returncode}: the client counted "
                  f"{doc and doc['requests']}, the server {delta}: "
                  f"{proc.stderr[-2000:]}")
            phase(26, "tls_resnet", leg=leg, url=url,
                  levels=perf_levels(doc), requests=doc["requests"],
                  server_successes=delta[0], **card)
        proc, _, delta = perf_cli(
            server, "resnet50", tmp, "mtls_refused",
            ["-i", "http", "-u", relays["mtls"],
             "--ssl-https-ca-certificates-file", cert] + level)
        check(proc.returncode != 0 and delta == (0, 0),
              f"a run without the client certificate exited "
              f"{proc.returncode}, server {delta}")
        phase(26, "tls_mtls_refused", rc=proc.returncode,
              message=proc.stderr.strip()[-300:], **card)

        data = os.path.join(tmp, "lm_tls_input.json")
        tokens = write_lm_input(data)
        torch.cuda.synchronize()
        ops.reset_launches()
        proc, doc, delta = perf_cli(
            server, HTTP_LM, tmp, "tls_lm",
            ["-i", "http", "-u", relays["http"],
             "--ssl-https-ca-certificates-file", cert,
             "--input-data", data] + level)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        routes = {n: dict(r) for n, r in ops.ROUTES.items()}
        check(proc.returncode == 0 and delta[1] == 0 and delta[0] > 0
              and doc["requests"] == {"completed": delta[0], "failed": 0},
              f"{HTTP_LM} over HTTPS exited {proc.returncode}: the client "
              f"counted {doc and doc['requests']}, the server {delta}: "
              f"{proc.stderr[-2000:]}")
        for kernel in ("int8_matmul", "paged_attention"):
            check(launches[kernel] > 0,
                  f"{HTTP_LM} over HTTPS launched {kernel} no time: "
                  f"{launches}")
        phase(26, "tls_lm", model=HTTP_LM, levels=perf_levels(doc),
              requests=doc["requests"], server_successes=delta[0],
              workload={"prompt_tokens": len(tokens), "max_tokens": 1},
              launches=launches, launches_by_route=routes, **card)
    finally:
        for name, p in procs.items():
            stop_relay(p, f"TLS relay ({name})")
    phase(26, "tls_done", seconds=time.monotonic() - t0, **card)
    return launches, routes


def native_phase(card, server, tmp):
    """Phase 26 on phase 23's server: (a) the native worker
    (native_leg), (b) procpool (procpool_leg), (c) SSL (tls_leg).
    Returns 26a's (launches, routes) and 26c's (launches_native and
    launches_tls in phase 20)."""
    t0 = time.monotonic()
    native = native_leg(card, server, tmp)
    procpool_leg(card, server, tmp)
    tls = tls_leg(card, server, tmp)
    PHASE_SECONDS[26] = time.monotonic() - t0
    phase(26, "native_phase_done", seconds=PHASE_SECONDS[26], **card)
    client_starts_summary(card)
    return native, tls


# -- the failure-domain checks on phase 23's server (phase 27) ---------------

# tests/test_chaos.py's _SpecChaosFixture (:1194) and its scenario seed
# (:1294): stream A (free tier, a periodic prompt the n-gram drafter
# continues) and B, cancelled with drafts in flight, fill the pool; the
# gold admission cannot fit beside A and must preempt it.  The engine's
# pool holds at least one max_seq sequence (64 blocks of 8 at
# DEFAULT_LM_CONFIG's 512), so the fixture's budgets (A 9 of 12 blocks,
# B 3, gold 7) are scaled to it: A reserves 48 blocks, B 16, gold 37
CHAOS_SEED = 5
CHAOS_PROMPTS = {"a": [5, 6] * 6, "b": [7, 8] * 6, "gold": [9, 7] * 6}
CHAOS_BUDGETS = {"a": 372, "b": 116, "gold": 284}
CHAOS_ENGINE = dict(max_slots=2, lane_counts=(2,), block_size=8,
                    prefill_chunk=16, min_bucket=4, pool_tokens=512,
                    speculative={"k": 4}, tenant_priority={"gold": 10.0})
CHAOS_DEVICE = "cuda"
# 27b: gRPC streams of lm_streaming_int8 behind the port's FaultProxy
CHAOS_MODEL = "lm_streaming_int8"
CHAOS_STREAMS = 8            # 7 survivors and the stream whose link dies
CHAOS_VICTIM_TOKENS = 400    # MAX_TOKENS of that stream: still running
CHAOS_KILL_AFTER = 8         # tokens it reads before its link is killed
CHAOS_RESTORE_S = 0.5        # refuse until then (from the drivers' start)
CHAOS_SUM_TOL_MS = 1.0       # queue + compute + wire against the total
CHAOS_PROFVIEW = ["--live"]  # python -m client_tpu_torch.profview ...
CHAOS_IN = ("launches_chaos: phase 27's witnessed spec-cancel-preempt "
            "rounds (float32, int8) and its gRPC streams behind the "
            "FaultProxy")


class SpecChaosFixture:
    """The port's counterpart of tests/test_chaos.py's _SpecChaosFixture
    at DEFAULT_LM_CONFIG's width and depth on the card, every tick a
    CUDA-graph replay: A streams, B streams two tokens and is cancelled
    with drafts in flight, then the gold admission preempts A.  The
    engine notes its preemptions into *flight*, which ChaosMatrix dumps
    (under ``$TPU_FLIGHT_DIR``) when a check fails."""

    def __init__(self, LmEngine, Registry, params, cfg, flight):
        self.engine = LmEngine(params, cfg, device=CHAOS_DEVICE,
                               registry=Registry(), **CHAOS_ENGINE)
        self.engine.flight = self.flight = flight
        self.outputs = {}
        self.started_a = threading.Event()

    def flight_recorders(self):
        return [self.flight]

    def apply_fault(self, fault):
        from client_tpu_torch.testing.chaos import dispatch_fault

        dispatch_fault(fault)

    def drivers(self):
        close = self.engine.CLOSE

        def stream_a():
            q, _ = self.engine.submit(CHAOS_PROMPTS["a"], CHAOS_BUDGETS["a"],
                                      tenant="free")
            first = q.get(timeout=300)
            check(first is not close, "stream A closed before a token")
            self.started_a.set()
            self.outputs["a"] = [first] + collect(q, close)

        def cancel_then_gold():
            self.started_a.wait(timeout=300)
            q, handle = self.engine.submit(
                CHAOS_PROMPTS["b"], CHAOS_BUDGETS["b"], tenant="free")
            for _ in range(2):
                if q.get(timeout=300) is close:
                    break
            self.engine.cancel(handle)
            collect(q, close)
            q, _ = self.engine.submit(
                CHAOS_PROMPTS["gold"], CHAOS_BUDGETS["gold"], tenant="gold")
            self.outputs["gold"] = collect(q, close)

        return [stream_a, cancel_then_gold]

    def check(self, result):
        result.assert_clean()
        self.preempt = self.engine.preempt_stats()
        self.spec = self.engine.spec_stats()
        check(self.preempt["preemptions"] >= 1,
              f"the gold admission never preempted stream A: {self.preempt}")
        check(self.spec["accepted"] > 0,
              f"speculation never engaged: {self.spec}")
        for name in ("a", "gold"):
            check(len(self.outputs.get(name) or ()) == CHAOS_BUDGETS[name],
                  f"stream {name} delivered {self.outputs.get(name)}")

    def close(self):
        from client_tpu_torch.testing.chaos import assert_kv_clean

        self.engine.close()
        assert_kv_clean(self.engine)


def spec_chaos_round(LmEngine, Registry, params, cfg, flight,
                     witnesses=()):
    """One spec-cancel-preempt round under ChaosMatrix, inside
    *witnesses*, installed before the engine is built.  Returns the
    fixture and the round's launch counts (reset just before, read just
    after)."""
    from client_tpu_torch import ops
    from client_tpu_torch.testing.chaos import ChaosMatrix, ChaosScenario

    fixtures = []

    def make(scenario):
        fixtures.append(SpecChaosFixture(LmEngine, Registry, params, cfg,
                                         flight))
        return fixtures[-1]

    with contextlib.ExitStack() as stack:
        for w in witnesses:
            stack.enter_context(w.installed())
        torch.cuda.synchronize()
        ops.reset_launches()
        ChaosMatrix([ChaosScenario("spec-cancel-preempt", seed=CHAOS_SEED)]
                    ).run(make, join_timeout_s=300)
        torch.cuda.synchronize()
        counts = (dict(ops.LAUNCHES),
                  {n: dict(r) for n, r in ops.ROUTES.items()})
    return fixtures[0], counts


def witnessed_round(card, LmEngine, Registry, params, cfg, label, held_to,
                    **extra):
    """27a: the round inside the port's LockWitness, RaceWitness and
    ResourceWitness; then the lock graphs acyclic, no unguarded shared
    write, and every KV reservation witnessed and given back.  *held_to*
    checks the survivors; *extra* rides on the phase line."""
    from client_tpu_torch.analysis.witness import (
        LockWitness,
        RaceWitness,
        ResourceWitness,
    )
    from client_tpu_torch.serve.flight import FlightRecorder

    flight = FlightRecorder(name=f"chaos-{label}")
    lock = LockWitness()
    race = RaceWitness(flight=flight)
    resources = ResourceWitness(flight=flight)
    t0 = time.monotonic()
    fx, counts = spec_chaos_round(LmEngine, Registry, params, cfg, flight,
                                  witnesses=(lock, race, resources))
    seconds = time.monotonic() - t0
    edges = lock.assert_acyclic()
    race_edges = race.assert_acyclic()
    accesses = race.assert_race_free()
    handles = resources.assert_clean()
    check(handles > 0, "the resource witness saw no KV reservation")
    check(lock.acquisitions > 0 and accesses > 0,
          f"the witnesses saw no traffic: {lock.acquisitions} lock "
          f"acquisitions, {accesses} witnessed field accesses")
    survivors = {name: held_to(name, fx.outputs[name])
                 for name in ("a", "gold")}
    phase(27, "chaos_spec_round", weights=label, config="DEFAULT_LM_CONFIG",
          engine={k: v for k, v in CHAOS_ENGINE.items()
                  if k != "tenant_priority"},
          scenario={"name": "spec-cancel-preempt", "seed": CHAOS_SEED},
          budgets=CHAOS_BUDGETS, survivors=survivors,
          preemptions=fx.preempt["preemptions"],
          spec={k: fx.spec[k] for k in ("proposed", "accepted")},
          lock_edges=edges, race_witness_lock_edges=race_edges,
          lock_acquisitions=lock.acquisitions,
          witnessed_field_accesses=accesses,
          kv_acquisitions_witnessed=handles, kv_clean_after_close=True,
          launches=counts[0], launches_by_route=counts[1],
          seconds=seconds, **extra, **card)
    return counts


def chaos_stream(grpcclient, address, model, tokens, max_tokens, tracer,
                 deadline, read=None, refused=None):
    """One decoupled stream through the port's gRPC client at *address*,
    under one client span whose traceparent rides the stream's metadata.
    A connection-level failure before any token (a refused connection) is
    retried on a new client until *deadline*.  Returns (tokens, error):
    the error that ended the stream, or None."""
    from client_tpu_torch.tracing import attempt_span, client_span

    with client_span(tracer, model) as trace:
        while True:
            toks, errors, done = [], [], threading.Event()

            def on_response(result, error):
                if error is not None:
                    errors.append(error)
                    done.set()
                    return
                toks.append(int(result.as_numpy("TOKEN")[0]))
                if read is not None:
                    read(len(toks))
                if len(toks) == max_tokens:
                    done.set()

            with attempt_span(trace, endpoint=address):
                client = grpcclient.InferenceServerClient(address)
                try:
                    client.start_stream(on_response, stream_timeout=300,
                                        headers={"traceparent":
                                                 trace.traceparent()})
                    try:
                        client.async_stream_infer(
                            model, grpc_lm_inputs(grpcclient, tokens,
                                                  max_tokens))
                    except grpcclient.InferenceServerException as e:
                        # the stream died before the request went out (a
                        # refused link): its callback carries the cause
                        if not done.wait(timeout=10):
                            errors.append(e)
                    done.wait(timeout=300)
                    client.stop_stream()
                finally:
                    client.close()
            if not errors:
                return toks, None
            if toks or time.monotonic() > deadline:
                trace.error = str(errors[0])
                return toks, errors[0]
            if refused is not None:
                refused.append(str(errors[0]))
            time.sleep(0.05)


def connection_level(error):
    """A gRPC failure of the link (UNAVAILABLE, a reset or closed
    socket), not an answer of the server."""
    text = str(error)
    return "UNAVAILABLE" in text or any(
        word in text.lower() for word in ("socket closed", "reset",
                                          "connection"))


def chaos_grpc_leg(card, server, engines, tmp):
    """27b: 8 lm_streaming_int8 streams through the port's gRPC client,
    7 behind one FaultProxy, one behind another.  dispatch_fault refuses
    the first proxy's connections before the streams start and restores
    them after CHAOS_RESTORE_S, and kills the second's link once its
    stream has read CHAOS_KILL_AFTER tokens.  The killed stream ends with
    a connection-level error; the other 7 equal the undisturbed answers
    (the near-tie rule of int8 streams); the client's and the server's
    trace files, joined by the port's traceview, give one timeline a
    stream.  Returns the launch counts of the faulted streams and the
    server's prof report after them."""
    from client_tpu_torch import grpc as grpcclient
    from client_tpu_torch import ops, traceview
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.testing.chaos import (
        ChaosScenario,
        FaultSpec,
        dispatch_fault,
        run_scenario,
    )
    from client_tpu_torch.testing.faults import FaultProxy
    from client_tpu_torch.tracing import ClientTracer

    t0 = time.monotonic()
    eng = engines[CHAOS_MODEL]
    prompts = distinct_prompts(language.encode_text(PROMPT), CHAOS_STREAMS)
    survivors, victim = prompts[:-1], prompts[-1]
    want = {}

    def undisturbed(i):
        want[i] = grpc_stream(grpcclient, server.grpc_address, CHAOS_MODEL,
                              survivors[i], GRPC_TOKENS)

    threads = [threading.Thread(target=undisturbed, args=(i,))
               for i in range(len(survivors))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(len(want) == len(survivors), "an undisturbed stream did not end")

    server_file = os.path.join(tmp, "chaos-server.jsonl")
    client_file = os.path.join(tmp, "chaos-client.jsonl")
    server.engine.update_trace_settings({
        "trace_level": ["TIMESTAMPS"], "trace_rate": "1",
        "trace_count": "-1", "trace_file": server_file})
    tracer = ClientTracer(trace_file=client_file, trace_rate=1)
    proxies = [FaultProxy(server.grpc_address),
               FaultProxy(server.grpc_address)]
    got, refused, victim_out = {}, [], {}
    streaming = threading.Event()
    deadline = time.monotonic() + 120

    def survivor(i):
        got[i] = chaos_stream(grpcclient, proxies[0].address, CHAOS_MODEL,
                              survivors[i], GRPC_TOKENS, tracer, deadline,
                              refused=refused)

    def doomed():
        def read(n):
            if n == CHAOS_KILL_AFTER:
                streaming.set()

        victim_out["toks"], victim_out["error"] = chaos_stream(
            grpcclient, proxies[1].address, CHAOS_MODEL, victim,
            CHAOS_VICTIM_TOKENS, tracer, deadline, read=read)

    def kill_mid_stream():
        check(streaming.wait(timeout=120),
              "the stream to be killed never streamed")
        dispatch_fault(FaultSpec("kill_connections", target=1),
                       proxies=proxies)

    scenario = ChaosScenario("grpc-refuse-restore-kill", [
        FaultSpec("restore", at_s=CHAOS_RESTORE_S, target=0),
        FaultSpec("custom", at_s=CHAOS_RESTORE_S, fn=kill_mid_stream),
    ], seed=CHAOS_SEED)
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        dispatch_fault(FaultSpec("refuse", target=0), proxies=proxies)
        result = run_scenario(
            scenario, lambda f: dispatch_fault(f, proxies=proxies),
            [functools.partial(survivor, i) for i in range(len(survivors))]
            + [doomed], join_timeout_s=300)
        torch.cuda.synchronize()
        counts = (dict(ops.LAUNCHES),
                  {n: dict(r) for n, r in ops.ROUTES.items()})
    finally:
        for proxy in proxies:
            proxy.close()
        server.engine.update_trace_settings({"trace_level": ["OFF"],
                                             "trace_file": ""})
    result.assert_clean()
    check(refused, "no stream met the refused connections")
    toks, error = victim_out["toks"], victim_out["error"]
    check(error is not None and connection_level(error)
          and CHAOS_KILL_AFTER <= len(toks) < CHAOS_VICTIM_TOKENS,
          f"the killed stream read {len(toks)} tokens and ended with "
          f"{error!r}, not a connection-level error mid-stream")
    near = [agreement(tfm, eng.params, eng.cfg, p, got[i][0], want[i])
            for i, p in enumerate(survivors)]
    check(all(got[i][1] is None for i in got),
          f"a surviving stream failed: {[got[i][1] for i in got]}")
    timelines = chaos_timelines(traceview, server_file, client_file)
    prof = json.loads(http(server.http_address,
                           "/v2/debug/prof?window=0")[1])
    phase(27, "chaos_grpc_faults", model=CHAOS_MODEL,
          streams=CHAOS_STREAMS, tokens=GRPC_TOKENS,
          faults=[{"at_s": round(at, 4), "kind": f.kind,
                   "target": f.target} for at, f in result.fired],
          refused_attempts=len(refused),
          killed={"tokens_read": len(toks), "max_tokens":
                  CHAOS_VICTIM_TOKENS, "error": str(error)[:200]},
          survivors_vs_undisturbed=near, near_tie=NEAR_TIE,
          timelines=timelines, launches=counts[0],
          launches_by_route=counts[1], seconds=time.monotonic() - t0,
          **card)
    return counts, prof


def chaos_timelines(traceview, server_file, client_file):
    """The port's traceview over the two trace files: one timeline a
    stream (its client span and its server span under one trace id), and
    for each stream that ended cleanly, queue + compute + wire equal to
    the client's duration within CHAOS_SUM_TOL_MS."""
    traces = traceview.join_traces(
        traceview.load_records([client_file, server_file]))
    streams = {tid: spans for tid, spans in traces.items()
               if any(r.get("source") == "client" for r in spans)}
    check(len(streams) == CHAOS_STREAMS,
          f"{len(streams)} client traces, {CHAOS_STREAMS} streams")
    worst, errors, head, tail = 0.0, 0, 0.0, 0.0
    for tid, spans in streams.items():
        requests = [r for r in spans
                    if not str(r.get("model_name")).startswith("__")]
        ends = sorted(r.get("source") for r in requests)
        check(ends == ["client", "server"],
              f"trace {tid} is not one client and one server request "
              f"span: {ends}")
        if any(r.get("error") for r in spans):
            errors += 1
            continue
        cp = traceview.critical_path(spans)
        gap = abs(cp["queue_ms"] + cp["compute_ms"] + cp["wire_ms"]
                  - cp["total_ms"])
        worst = max(worst, gap)
        # the server span's time outside queue and compute: its head
        # (REQUEST_START to QUEUE_START) and its tail (after COMPUTE_END)
        served = {}
        for r in requests:
            if r.get("source") == "server":
                for e in r.get("timestamps") or ():
                    served.setdefault(e["name"], []).append(e["ns"])
        if {"REQUEST_START", "QUEUE_START", "COMPUTE_END"} <= set(served):
            last = max(ns for stamps in served.values() for ns in stamps)
            head = max(head, (served["QUEUE_START"][0]
                              - served["REQUEST_START"][0]) / 1e6)
            tail = max(tail, (last - served["COMPUTE_END"][-1]) / 1e6)
    check(errors == 1, f"{errors} traces carry an error, the killed one "
                       "alone should")
    check(worst <= CHAOS_SUM_TOL_MS,
          f"queue + compute + wire misses the client's duration by "
          f"{worst} ms (server spans' worst head {head} ms, tail {tail})")
    return {"traces": len(streams), "with_error": errors,
            "worst_sum_gap_ms": worst, "tolerance_ms": CHAOS_SUM_TOL_MS,
            "worst_head_ms": head, "worst_tail_ms": tail}


def start_profview_live():
    """27c, started with the phase (a process of its own on the card,
    beside 27a-b): ``python -m client_tpu_torch.profview --live``."""
    here = os.path.dirname(os.path.abspath(__file__))
    return time.monotonic(), popen(
        [sys.executable, "-m", "client_tpu_torch.profview", *CHAOS_PROFVIEW],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here,
        env={**os.environ, "PYTHONPATH": here})


def chaos_profview(card, live, prof, tmp):
    """27c: the ``profview --live`` run's cnn table (exit 0, cnn ticks
    with a device share), then the port's profview over the server's
    /v2/debug/prof report (the LM engine's ticks)."""
    from client_tpu_torch import profview

    t0, proc = live
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    live_s = time.monotonic() - t0
    check(proc.returncode == 0,
          f"profview --live exited {proc.returncode}: {err[-2000:]}")
    share = re.search(r"model cnn_classifier .*share=([0-9.]+)%", out)
    check("engine serve" in out and "batch=" in out
          and share is not None and float(share.group(1)) > 0,
          f"profview --live rendered no cnn ticks with a device share: "
          f"{out[-2000:]}")
    path = os.path.join(tmp, "prof.json")
    with open(path, "w") as f:
        json.dump(prof, f)
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        rc = profview.main([path])
    table = table.getvalue()
    lm = [e for e in prof["engines"]
          if e.get("ticks") and e.get("kinds", {}).get("decode")]
    check(rc == 0 and lm and all(f"engine {e['engine']}" in table
                                 for e in lm),
          f"profview over /v2/debug/prof shows no LM engine's ticks: "
          f"{table[-2000:]}")
    phase(27, "chaos_profview", live_seconds=live_s,
          live_table=out.strip().splitlines(),
          lm_engines={e["engine"]: {"ticks": e["ticks"],
                                    "kinds": e["kinds"]} for e in lm},
          served_table=table.strip().splitlines()[:12], **card)


def chaos_phase(card, server, engines, tmp):
    """Phase 27 on phase 23's server, after phase 26.  (a) The port's
    counterpart of tests/test_chaos.py's spec-cancel-preempt round under
    ChaosMatrix, inside the port's three witnesses: float32 (survivors
    byte-exact to the serial generate), then with lm_streaming_int8's
    int8 weights (survivors equal to the same round run first without
    witnesses, the near-tie rule of int8 streams).  (b) gRPC streams
    behind the port's FaultProxy (chaos_grpc_leg).  (c) profview.
    Returns (launches, routes) summed over (a)'s witnessed rounds and
    (b)'s streams (launches_chaos in phase 20).  (c)'s ``--live`` process
    starts with the phase and runs beside (a) and (b)."""
    from client_tpu_torch.serve.flight import FlightRecorder
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.metrics import Registry
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.testing.chaos import (
        assert_byte_exact,
        assert_kv_clean,
    )

    t0 = time.monotonic()
    live = start_profview_live()
    cfg32 = dataclasses.replace(language.DEFAULT_LM_CONFIG, dtype="float32")
    p32 = tfm.init_params(torch.Generator().manual_seed(0), cfg32,
                          torch.device(CHAOS_DEVICE))

    def serial(name):
        want = list(tfm.generate(p32, cfg32, CHAOS_PROMPTS[name],
                                 CHAOS_BUDGETS[name], readback_depth=0))

        def held(got):
            assert_byte_exact(got, want, label=f"float32 stream {name}")
            return {"equal": True, "tokens": len(got)}
        return held

    f32 = {name: serial(name) for name in ("a", "gold")}
    windows = [witnessed_round(card, LmEngine, Registry, p32, cfg32,
                               "float32", lambda name, got: f32[name](got))]
    int8 = engines[CHAOS_MODEL]
    t_ref = time.monotonic()
    ref, _ = spec_chaos_round(LmEngine, Registry, int8.params, int8.cfg,
                              FlightRecorder(name="chaos-int8-unwitnessed"))
    t_ref = time.monotonic() - t_ref
    windows.append(witnessed_round(
        card, LmEngine, Registry, int8.params, int8.cfg, "int8",
        lambda name, got: agreement(tfm, int8.params, int8.cfg,
                                    CHAOS_PROMPTS[name], got,
                                    ref.outputs[name]),
        unwitnessed_seconds=t_ref))
    grpc_counts, prof = chaos_grpc_leg(card, server, engines, tmp)
    windows.append(grpc_counts)
    # the killed stream's blocks came back: the served engine drains and
    # closes clean
    check(server.engine.drain(timeout_s=60),
          "the server did not drain after the faulted streams")
    int8.close()
    assert_kv_clean(int8)
    chaos_profview(card, live, prof, tmp)
    launches = {n: sum(w[0][n] for w in windows) for n in windows[0][0]}
    routes = {n: {r: sum(w[1][n][r] for w in windows) for r in rs}
              for n, rs in windows[0][1].items()}
    check(launches["int8_matmul"] > 0 and launches["paged_attention"] > 0,
          f"phase 27 launched int8 {launches['int8_matmul']} and paged "
          f"{launches['paged_attention']} times")
    phase(27, "chaos_done", launches=launches, launches_by_route=routes,
          seconds=time.monotonic() - t0, **card)
    return launches, routes


# -- the examples corpus (phase 29) ------------------------------------------

EXAMPLE_JOBS = 8        # example processes at a time
EXAMPLE_TIMEOUT = 180   # seconds an example process may take
EXAMPLE_DEVICE = "cuda"
# host copies the server may make in the CUDA-region window beside
# ResNet-50's logits (1000 float32), which image_client's classification
# reads on the host (phase 14's bound a request)
EXAMPLE_COPY_LIMIT = SHM_COPY_LIMIT
EXAMPLE_LOGITS_BYTES = 1000 * 4


def example_results(outcomes):
    """Per run: rc, seconds and PASS line (the ends of the output of a
    run that failed)."""
    rows = []
    for key in sorted(outcomes):
        out = outcomes[key]
        row = {"example": key, "rc": out.rc,
               "seconds": round(out.seconds, 3), "pass": out.pass_line}
        if not out.passed:
            row["stdout"] = out.stdout[-1500:]
            row["stderr"] = out.stderr[-3000:]
        rows.append(row)
    return rows


def check_examples(leg, outcomes):
    failed = [o.describe() for o in outcomes.values() if not o.passed]
    check(not failed, f"phase 29 {leg}: {len(failed)} example(s) failed: "
          + "\n".join(failed))


def cuda_region_leg(card, server, ex):
    """Phase 29b: both cudashm examples and image_client.py
    --shared-memory cuda -m resnet50 (regions of their own processes,
    opened here over CUDA IPC) together, beside llm_streaming_client.py
    --hermetic, inside one torch.profiler window of this process."""
    from torch.profiler import ProfilerActivity, profile, record_function

    engine = server.engine
    registered = []
    register = engine.shm.register_cuda

    def recording(name, raw_handle, device_id, byte_size):
        register(name, raw_handle, device_id, byte_size)
        with engine.shm._lock:
            entry = engine.shm._cuda.get(name)
        registered.append({"region": name, "byte_size": byte_size,
                           "opened_over_ipc": bool(entry
                                                   and entry["opened"])})

    g, h = server.grpc_address, server.http_address
    runs = [ex.url_run(ex.PORT_DIR, n, g, h)
            for n in ("simple_grpc_cudashm_client.py",
                      "simple_http_cudashm_client.py")]
    runs.append(ex.url_run(
        ex.PORT_DIR, "image_client.py", g, h,
        key="image_client.py --shared-memory cuda -m resnet50",
        extra=("--shared-memory", "cuda", "-m", "resnet50")))
    runs.append(ex.Run(
        "llm_streaming_client.py --hermetic",
        os.path.join(ex.PORT_DIR, "llm_streaming_client.py"),
        ("--hermetic", "--device", EXAMPLE_DEVICE)))
    engine.shm.register_cuda = recording
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("cuda_region_examples"):
                outcomes = ex.run_all(runs, jobs=len(runs),
                                      timeout=EXAMPLE_TIMEOUT)
            torch.cuda.synchronize()
    finally:
        del engine.shm.register_cuda  # the class's method again
    copies = memcpy_bytes(prof, "cuda_region_examples")
    left = engine.shm.cuda_status()
    phase(29, "examples_cuda_regions", runs=example_results(outcomes),
          server_copies=copies, regions=registered, registry_after=left,
          **card)
    check_examples("(b)", outcomes)
    check(len(registered) == 5 and all(r["opened_over_ipc"]
                                       for r in registered),
          f"the server did not open every region over CUDA IPC: "
          f"{registered}")
    check(left == {}, f"regions left registered: {left}")
    # the inputs are read on the device from their regions and the
    # outputs written there device to device; the one host copy is
    # ResNet-50's logits for image_client's classification
    check(isinstance(copies, dict)
          and copies["HtoD_bytes"] < EXAMPLE_COPY_LIMIT
          and copies["DtoH_bytes"] < EXAMPLE_LOGITS_BYTES
          + EXAMPLE_COPY_LIMIT,
          f"the CUDA-region requests crossed the host: {copies}")
    return outcomes


def examples_phase(card):
    """Phase 29: the port's examples corpus on the card (see the module
    docstring).  Returns the launch counts of its window (reset before
    (a), read after (c)) and its seconds."""
    from client_tpu_torch import ops
    from client_tpu_torch.perf import native_worker
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language, vision
    from client_tpu_torch.utils import InferenceServerException
    from client_tpu_torch.utils.cuda_shared_memory import _build as shm_build

    ex = _tool("examples_suite")
    t0 = time.monotonic()
    shm_build.extension()  # built in phase 2; loaded before clients start
    models = [vision.resnet50_model(device=EXAMPLE_DEVICE)]
    models += language.language_models(device=EXAMPLE_DEVICE)
    # (c)'s g++ build runs beside (a) and (b): it needs no device
    with concurrent.futures.ThreadPoolExecutor(1) as cpp_pool, Server(
            models=models, http_port=0, grpc_port=0,
            device=EXAMPLE_DEVICE) as server:
        before = native_worker.last_build
        build = cpp_pool.submit(ex.build_cpp_http_examples)
        g, h = server.grpc_address, server.http_address
        setup_s = time.monotonic() - t0
        ops.reset_launches()
        # (a) every example with -u, the replica examples (the longest:
        # servers of their own) first
        runs = [ex.url_run(ex.PORT_DIR, n, g, h, device=EXAMPLE_DEVICE,
                           extra=("-m", "resnet50")
                           if n == "image_client.py" else ())
                for n in ex.EXAMPLES if n not in ex.CUDA_REGIONS]
        runs.sort(key=lambda r: os.path.basename(r.script)
                  not in ex.REPLICAS)
        t_a = time.monotonic()
        url = ex.run_all(runs, jobs=EXAMPLE_JOBS, timeout=EXAMPLE_TIMEOUT)
        url_s = time.monotonic() - t_a
        phase(29, "examples_url", runs=example_results(url),
              passed=sum(o.passed for o in url.values()), of=len(url),
              seconds=url_s, **card)
        check_examples("(a)", url)
        # (b) the examples that stage tensors in CUDA regions
        t_b = time.monotonic()
        cuda_region_leg(card, server, ex)
        regions_s = time.monotonic() - t_b
        # (c) the C++ HTTP clients, built with g++ alone
        t_c = time.monotonic()
        try:
            binaries = build.result()
        except InferenceServerException as e:
            fail(f"phase 29 (c): the C++ HTTP clients did not build: {e}")
        built = native_worker.last_build
        built = None if built is before else built  # up to date: none
        cpp = ex.run_all([ex.cpp_run(path, h) for path in binaries.values()],
                         jobs=EXAMPLE_JOBS, timeout=EXAMPLE_TIMEOUT,
                         python="")
        launches = dict(ops.LAUNCHES)
        phase(29, "examples_cpp", runs=example_results(cpp),
              compiled=built is not None,
              build_s=built and built["seconds"],
              commands=built and len(built["commands"]),
              seconds=time.monotonic() - t_c, **card)
        check_examples("(c)", cpp)
    seconds = time.monotonic() - t0
    phase(29, "examples_done", setup_s=setup_s, url_s=url_s,
          cuda_regions_s=regions_s, cpp_s=time.monotonic() - t_c,
          launches=launches, reference_examples="not run on the card: "
          "they are clients of the JAX package (tests/test_torch_examples_"
          "reference.py runs them against the port's server on the CPU)",
          seconds=seconds, **card)
    return launches, seconds


def main():
    # -- 1 device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from client_tpu_torch import ops
    from client_tpu_torch.ops import _build, quant
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.parallel.ring_attention import plain_attention
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.serve.models.programs import serial_pool
    from client_tpu_torch.train import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = {"gpu": kind, "nvidia_smi": smi}
    phase(1, "device", torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count(), **card)

    # -- 28 the static analyser (first: a failure costs seconds) -----------
    analysis_phase(card)

    # -- 2 build ---------------------------------------------------------
    # the shared-memory extension (cudashm.cpp) builds beside the kernels,
    # in a process of its own; phase 14 loads it
    here = os.path.dirname(os.path.abspath(__file__))
    shm_build = popen(
        [sys.executable, "-c",
         "from client_tpu_torch.utils.cuda_shared_memory import _build\n"
         "_build.extension()\nprint(_build.build_seconds)"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": here})
    try:
        library = _build.kernels().__file__
        shm_out, shm_err = shm_build.communicate(timeout=900)
    finally:
        if shm_build.poll() is None:
            shm_build.kill()
            shm_build.wait()
    check(shm_build.returncode == 0,
          f"the shared-memory extension did not build: {shm_err[-3000:]}")
    phase(2, "build", kernels=["int8_matmul (gemv, tiled, mma routes)",
                               *FLASH_KERNELS,
                               "paged_attention (split, mma routes, combine)"],
          seconds=round(_build.build_seconds, 3), flags=_build.CUDA_FLAGS,
          resources=kernel_resources(library),
          shm_extension={
              "source": "client_tpu_torch/utils/cuda_shared_memory/"
                        "cudashm.cpp",
              "seconds": round(float(shm_out.split()[-1]), 3)})

    # -- 3 kernel against its plain version -------------------------------
    gen = torch.Generator().manual_seed(1234)
    ext = _build.kernels()
    worst, worst_route, cases = {}, {}, 0
    for dt in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dt]
        key = dtype_name(dt)
        for m in M_LIST:
            for k, n in SERVED_KN + MOE_KN:
                x = torch.randn(m, k, generator=gen).to(dt).cuda()
                w = torch.randn(k, n, generator=gen) * k ** -0.5
                qw = tree_to(quant.quantize_int8(w), "cuda")
                want = quant.int8_matmul_reference(x, qw["q"], qw["s"]).float()
                route = int8_route(m, n, dt)
                before = ops.ROUTES["int8_matmul"][route]
                runs = [(route, quant._launch(x, qw["q"], qw["s"]))]
                check(ops.ROUTES["int8_matmul"][route] == before + 1,
                      f"int8_matmul {key} M={m} N={n} did not report the "
                      f"{route} route: {ops.ROUTES['int8_matmul']}")
                # bf16 on the tensor cores: the CUDA-core tiled kernel too,
                # and the GEMV where the tensor cores took it over (M 5-8)
                others = (("tiled",) if route == "mma" else ()) + (
                    ("gemv",) if route == "mma" and m <= GEMV_MAX_M else ())
                for other in others:
                    runs.append((other, ext.int8_matmul_route(
                        x, qw["q"], qw["s"], INT8_ROUTE_IDS[other])))
                for name, got in runs:
                    err = (got.float() - want).abs()
                    check(bool((err <= atol + rtol * want.abs()).all()),
                          f"int8_matmul {name} {key} M={m} K={k} N={n}: max "
                          f"abs err {err.max().item()} beyond atol {atol} "
                          f"rtol {rtol}")
                    worst[key] = max(worst.get(key, 0.0), err.max().item())
                    by = worst_route.setdefault(name, {})
                    by[key] = max(by.get(key, 0.0), err.max().item())
                    cases += 1
    torch.cuda.synchronize()
    phase(3, "kernel_vs_plain", kernel="int8_matmul", cases=cases,
          m=list(M_LIST), kn=[list(kn) for kn in SERVED_KN + MOE_KN],
          max_abs_err=worst, max_abs_err_by_route=worst_route,
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16]})

    # -- 4 model: cuda (kernel) against cpu (plain) -----------------------
    cfg = language.DEFAULT_LM_CONFIG
    cfg32_lm = dataclasses.replace(cfg, dtype="float32")
    params_cpu = tfm.quantize_params(
        tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    params_gpu = tree_to(params_cpu, "cuda")
    prompt = language.encode_text(PROMPT)
    toks = torch.as_tensor(prompt)[None]
    logits_gpu = tfm.forward(params_gpu, toks.cuda(), cfg).cpu()
    logits_cpu = tfm.forward(params_cpu, toks, cfg)
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits on cuda")
    logit_err = (logits_gpu - logits_cpu).abs().max().item()
    fwd_agree = (logits_gpu.argmax(-1) == logits_cpu.argmax(-1)).float().mean().item()
    check(logit_err <= LOGIT_ATOL,
          f"forward logits differ by {logit_err} > {LOGIT_ATOL}")
    check(fwd_agree >= MIN_AGREE, f"forward argmax agreement {fwd_agree}")

    cache = tfm.init_cache(cfg, 1, "cuda")
    logits, cache = tfm.prefill(params_gpu, toks.cuda(), cfg, cache)
    ops.reset_launches()
    tfm.decode_step(params_gpu, logits.argmax(-1).to(torch.int32), cfg, cache)
    torch.cuda.synchronize()
    per_step = ops.LAUNCHES["int8_matmul"]
    check(per_step == 6 * cfg.n_layers,
          f"{per_step} int8_matmul launches per decode step, expected "
          f"{6 * cfg.n_layers}")

    n_new = 32
    ops.reset_launches()
    gen_gpu = list(tfm.generate(params_gpu, cfg, prompt, n_new))
    gen_launches = ops.LAUNCHES["int8_matmul"]
    gen_cpu = list(tfm.generate(params_cpu, cfg, prompt, n_new))
    check(gen_launches == 6 * cfg.n_layers * n_new,
          f"generate launched the kernel {gen_launches} times, expected "
          f"{6 * cfg.n_layers * n_new} (prefill + {n_new - 1} decode steps)")
    agree = float(np.mean(np.array(gen_gpu) == np.array(gen_cpu)))
    check(len(gen_gpu) == n_new and agree >= MIN_AGREE,
          f"greedy tokens agree on {agree:.3f} of positions: cuda {gen_gpu} "
          f"cpu {gen_cpu}")
    phase(4, "model", config="DEFAULT_LM_CONFIG int8", prompt_tokens=len(prompt),
          logits_max_abs_err=logit_err, logits_atol=LOGIT_ATOL,
          forward_argmax_agree=fwd_agree, launches_per_decode_step=per_step,
          generate_launches=gen_launches, greedy_agree=agree,
          tokens_cuda=gen_gpu)

    # -- 5 server: the main path, counted ---------------------------------
    # lm_streaming_int8 and lm_streaming_batched run on the continuous-
    # batching engine (paged attention; int8 at decode on the GEMV route)
    ops.reset_launches()
    served_models = language.language_models(device="cuda")
    engines = {m.name: m.closer.__self__ for m in served_models
               if m.closer is not None}
    check(set(engines) == {"lm_streaming_int8", "lm_streaming_batched"},
          f"batched models {sorted(engines)}")
    with Server(models=served_models, http_port=0,
                with_default_models=False) as server:
        addr = server.http_address
        status, _, _ = http(addr, "/v2/health/ready")
        check(status == 200, f"ready answered {status}")
        _, body, _ = http(addr, "/v2/models/lm_streaming_int8")
        meta = json.loads(body)
        check(meta["name"] == "lm_streaming_int8", f"metadata {meta}")
        tok_req = json.dumps({"inputs": [{
            "name": "TEXT", "shape": [1], "datatype": "BYTES",
            "data": [PROMPT]}]}).encode()
        _, body, _ = http(addr, "/v2/models/tokenizer/infer", tok_req)
        tok_out = {o["name"]: o for o in json.loads(body)["outputs"]}
        check(tok_out["TOKENS"]["data"] == prompt.tolist(),
              "tokenizer output differs from encode_text")
        served = {}
        for model_name in (("lm_streaming_int8",) * 3 + ("lm_streaming",)
                           + ("lm_streaming_batched",) * 2):
            _, body, headers = http(
                addr, f"/v2/models/{model_name}/infer",
                lm_request(prompt, 1), {"Accept-Encoding": "gzip"},
            )
            check(headers.get("Content-Encoding") == "gzip", "no gzip body")
            out = json.loads(gzip.decompress(body))
            served.setdefault(model_name, []).append(
                out["outputs"][0]["data"][0])
        for model_name, firsts in served.items():
            check(len(set(firsts)) == 1,
                  f"{model_name} answered {firsts} to one request")
        try:
            http(addr, "/v2/models/lm_streaming_int8/infer",
                 lm_request(prompt, 4))
            fail("MAX_TOKENS=4 over HTTP did not answer 400")
        except urllib.error.HTTPError as e:
            err_body = e.read().decode()
            check(e.code == 400 and "gRPC streaming" in err_body,
                  f"decoupled rule answered {e.code}: {err_body}")
        streamed, own = {}, {}
        for model_name, eng in engines.items():
            stream = server.engine.execute(
                model_name, "", json.loads(lm_request(prompt, 32)), b"")
            streamed[model_name] = [r[0]["outputs"][0]["data"][0]
                                    for r in stream]
            # the same request straight to the model's engine
            own[model_name] = collect(eng.submit(prompt, 32)[0],
                                      LmEngine.CLOSE)
            check(streamed[model_name] == own[model_name],
                  f"{model_name}: engine.execute stream "
                  f"{streamed[model_name]} != its engine's {own[model_name]}")
            check(served[model_name][0] == own[model_name][0],
                  f"{model_name}: HTTP answered {served[model_name][0]}, "
                  f"its engine {own[model_name][0]}")
    torch.cuda.synchronize()
    main_launches = dict(ops.LAUNCHES)
    main_routes = {name: dict(r) for name, r in ops.ROUTES.items()}
    check(all(not eng._thread.is_alive() for eng in engines.values()),
          "Server.stop left an engine's scheduler thread running")
    for name in ("int8_matmul", "paged_attention"):
        check(main_launches[name] > 0,
              f"the served path launched {name} no time")
    # bf16 and int8 decode, prefill chunks: each route of the served path
    for name, route in (("int8_matmul", "gemv"), ("int8_matmul", "mma"),
                        ("paged_attention", "split"),
                        ("paged_attention", "mma")):
        check(main_routes[name][route] > 0,
              f"the served path launched {name}'s {route} route no time: "
              f"{main_routes}")
    # the int8 engine against the serial runner on the same weights
    ref_runner = language._LmRunner(device="cuda", quantize=True)
    expected = list(ref_runner.stream(prompt, 32))
    serial_sets = serial_pool(ref_runner.params, ref_runner.cfg).idle_sets()
    check(len(serial_sets) == 1 and "decode" in serial_sets[0].captures,
          f"the serial runner streamed without its CUDA graphs: "
          f"{[p.captures for p in serial_sets]}")
    int8_vs_serial = agreement(tfm, ref_runner.params, cfg, prompt,
                               streamed["lm_streaming_int8"], expected)
    phase(5, "server", requests=9, streamed_tokens={
              k: len(v) for k, v in streamed.items()},
          execute_matches_engine=True, int8_vs_serial=int8_vs_serial,
          near_tie=NEAR_TIE, first_tokens=served, launches=main_launches,
          launches_by_route=main_routes)

    # -- 6 timings ---------------------------------------------------------
    rows = []
    for m in TIMED_M:
        for k, n in SERVED_KN:
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
            qw = tree_to(quant.quantize_int8(
                torch.randn(k, n, generator=gen) * k ** -0.5), "cuda")
            q, s = qw["q"], qw["s"]
            w_deq = (q.float() * s).to(torch.bfloat16)
            kernel = lambda: quant._launch(x, q, s)  # noqa: E731
            plain = lambda: quant.int8_matmul_reference(x, q, s)  # noqa: E731
            library = lambda: torch.matmul(x, w_deq)  # noqa: E731
            route = int8_route(m, n)
            row = {
                "M": m, "K": k, "N": n, "route": route,
                "ms": graph_ms(kernel),
                "plain_ms": graph_ms(plain),
                "library_ms": graph_ms(library),
                "bound_ms": bound_ms(m, k, n),
                "eager_ms": eager_ms(kernel),
                "eager_plain_ms": eager_ms(plain),
                "eager_library_ms": eager_ms(library),
            }
            # the other route beside it: the CUDA-core tiled kernel beside
            # the tensor cores (the GEMV at M <= 8), the tensor cores beside
            # the GEMV
            other = {"mma": "gemv" if m <= GEMV_MAX_M else "tiled",
                     "gemv": "mma"}[route]
            if other:
                row[f"{other}_ms"] = graph_ms(
                    lambda: ext.int8_matmul_route(x, q, s,
                                                  INT8_ROUTE_IDS[other]))
            rows.append(row)
    for row in rows:
        phase(6, "kernel_time", kernel="int8_matmul", dtype="bfloat16",
              **row, **card)

    bf16_params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    f32_params = tfm.init_params(torch.Generator().manual_seed(0), cfg32_lm,
                                 "cuda")
    serial_launches = serial_legs(tfm, prompt, card, (
        ("lm_streaming_int8", params_gpu, cfg),
        ("lm_streaming", bf16_params, cfg),
        ("lm_streaming_f32", f32_params, cfg32_lm)))
    del f32_params
    serial_beside_batched(tfm, language, LmEngine, bf16_params, cfg, prompt,
                          card)

    # -- 7 flash kernels against their plain versions ----------------------
    tcfg = tfm.TransformerConfig(**FLAGSHIP)
    main_shape = [TRAIN_BATCH * tcfg.n_heads, TRAIN_SEQ, tcfg.head_dim]
    # a shard of 19b's ring: [B * H, T / sp, D]
    ring_shard = [RING_SHAPE[0] * RING_SHAPE[2], RING_SHAPE[1] // 2,
                  RING_SHAPE[3]]
    flash_worst, flash_cases, main_err, ring_err = flash_vs_plain(
        fa, gen, main_shape, ring_shard)
    wrapper_err = wrapper_vs_plain(fa, plain_attention, gen)
    phase(7, "flash_vs_plain", kernels=list(FLASH_KERNELS),
          cases=flash_cases, max_abs_err=flash_worst,
          main_path_case={"shape": main_shape, "dtype": "bfloat16",
                          "causal": True, "max_abs_err": main_err},
          ring_shard_cases={"shape": ring_shard, "dtype": "bfloat16",
                            "max_abs_err": ring_err},
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16],
                     "lse": TOL[torch.float32]},
          wrapper_t100_max_abs_err=wrapper_err, wrapper_tolerance=WRAPPER_TOL)

    # -- 8 training: the main path of the flash kernels, counted -------------
    tokens = torch.from_numpy(np.random.default_rng(TRAIN_SEED).integers(
        0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    ops.reset_launches()
    _, _, flash_losses, flash_step = train_run(tfm, tcfg, "flash", tokens,
                                               TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = dict(ops.LAUNCHES)
    per_step = {n: c / TRAIN_STEPS for n, c in train_launches.items()}
    check(per_step == {"int8_matmul": 0, "paged_attention": 0,
                       **{n: tcfg.n_layers for n in FLASH_KERNELS}},
          f"flash training launched {train_launches} in {TRAIN_STEPS} "
          f"steps, expected {tcfg.n_layers} of each flash kernel a step")
    check(all(np.isfinite(flash_losses)) and flash_losses[-1] < flash_losses[0],
          f"flash training losses {flash_losses}")
    # the step is one CUDA graph from its second call: every flash kernel
    # once a layer in each replay, counted there
    train_graph = train_graph_pair(tfm, tcfg, tokens, "bf16 flash training",
                                   graph=(flash_losses, flash_step))
    per_replay = train_graph["launches_per_replay"]
    _, _, plain_losses, _ = train_run(tfm, tcfg, "plain", tokens, TRAIN_STEPS)
    diffs = [abs(a - b) for a, b in zip(flash_losses, plain_losses)]
    d0, dstep, dlast = diffs[0], max(diffs), diffs[-1]
    check(d0 <= TRAIN_LOSS0_ATOL and dstep <= TRAIN_LOSS_STEP_ATOL
          and dlast <= TRAIN_LOSS_LAST_ATOL,
          f"flash losses {flash_losses} against plain {plain_losses}")
    cfg32 = dataclasses.replace(tcfg, n_layers=2, dtype="float32")
    _, _, f32_flash, _ = train_run(tfm, cfg32, "flash", tokens, 3)
    _, _, f32_plain, _ = train_run(tfm, cfg32, "plain", tokens, 3)
    d32 = max(abs(a - b) for a, b in zip(f32_flash, f32_plain))
    check(d32 <= F32_LOSS_ATOL,
          f"float32 flash losses {f32_flash} against plain {f32_plain}")
    f32_graph = f32_graph_pair(tfm, cfg32, tokens)
    with torch.no_grad():
        logit_err = {}
        for c, atol in ((tcfg, LOGIT_ATOL), (cfg32, F32_LOGIT_ATOL)):
            p0 = tfm.init_params(torch.Generator().manual_seed(0), c, "cuda")
            lf = tfm.forward(p0, tokens[:, :-1], c, attn_impl="flash")
            lp = tfm.forward(p0, tokens[:, :-1], c, attn_impl="plain")
            err = (lf - lp).abs().max().item()
            agree = (lf.argmax(-1) == lp.argmax(-1)).float().mean().item()
            check(bool(torch.isfinite(lf).all()) and err <= atol
                  and agree >= MIN_AGREE,
                  f"{c.dtype} forward flash against plain: max abs err "
                  f"{err} (atol {atol}), argmax agreement {agree}")
            logit_err[c.dtype] = {"max_abs_err": err, "atol": atol,
                                  "argmax_agree": agree}
            del p0, lf, lp
    resumed_loss = checkpoint_round_trip(tfm, CheckpointManager, tcfg, tokens)
    phase(8, "training", config=FLAGSHIP, dtype=tcfg.dtype,
          tokens=[TRAIN_BATCH, TRAIN_SEQ + 1], steps=TRAIN_STEPS,
          lr=TRAIN_LR, launches=train_launches, launches_per_step=per_step,
          flash_losses=flash_losses, plain_losses=plain_losses,
          loss0_diff=d0, loss0_atol=TRAIN_LOSS0_ATOL, max_loss_diff=dstep,
          max_loss_atol=TRAIN_LOSS_STEP_ATOL, last_loss_diff=dlast,
          last_loss_atol=TRAIN_LOSS_LAST_ATOL,
          float32_2layer={"flash": f32_flash, "plain": f32_plain,
                          "max_diff": d32, "atol": F32_LOSS_ATOL},
          graph_vs_eager=train_graph,
          float32_2layer_graph_vs_eager=f32_graph,
          forward_flash_vs_plain=logit_err,
          checkpoint_resume_bit_exact=True, resumed_step_loss=resumed_loss)

    # -- 9 timings: flash kernels, train step, profile -----------------------
    ext = _build.kernels()
    bh, t, d = main_shape
    q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(torch.bfloat16)
                  .cuda() for _ in range(4))
    scale = d ** -0.5
    out, lse = ext.flash_fwd(q, k, v, scale, True)
    delta, g_lse = fa._delta(g, out), torch.zeros_like(lse)
    # SDPA takes [B, H, T, D]: the same memory as the folded [B*H, T, D]
    q4, k4, v4, g4 = (x.view(TRAIN_BATCH, tcfg.n_heads, t, d)
                      for x in (q, k, v, g))
    q4r, k4r, v4r = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, is_causal=True)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(  # noqa: E731
        F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True),
        (q4r, k4r, v4r), g4)
    bwd_plain = lambda: fa._fa_backward_reference(  # noqa: E731
        q, k, v, out, lse, g, g_lse, scale, True)
    graph = lambda fn: graph_ms(fn, iters=20)  # noqa: E731
    sdpa_ms = graph(sdpa)
    sdpa_bwd_ms = graph(sdpa_fwd_bwd) - sdpa_ms
    bwd_plain_ms = graph(bwd_plain)
    bounds = flash_bounds(bh, t, d, causal=True)
    flash_rows = {
        "flash_fwd": {
            "ms": graph(lambda: ext.flash_fwd(q, k, v, scale, True)),
            "plain_ms": graph(
                lambda: fa._fa_forward_reference(q, k, v, scale, True)),
            "library_ms": sdpa_ms,
            "library": "F.scaled_dot_product_attention(is_causal=True)"},
        "flash_bwd_dq": {
            "ms": graph(lambda: ext.flash_bwd_dq(q, k, v, g, lse, delta,
                                                 g_lse, scale, True))},
        "flash_bwd_dkv": {
            "ms": graph(lambda: ext.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                  g_lse, scale, True))},
    }
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        flash_rows[name].update({
            "plain_ms": bwd_plain_ms,
            "plain": "_fa_backward_reference: dq, dk and dv in one call",
            "library_ms": sdpa_bwd_ms,
            "library": "SDPA backward (dq, dk and dv together): graph-timed "
                       "SDPA forward + torch.autograd.grad minus the "
                       "graph-timed SDPA forward"})
    for name, row in flash_rows.items():
        row["bound_ms"], row["bound_by"] = bounds[name]
        phase(9, "flash_kernel_time", kernel=name, shape=[bh, t, d],
              dtype="bfloat16", causal=True,
              timing="device time from CUDA-graph replay", **row, **card)
    del q, k, v, g, out, lse, delta, g_lse, q4, k4, v4, g4, q4r, k4r, v4r
    phase(9, "flash_kernel_time_d128", **flash_d128(ext, fa, gen, graph),
          **card)
    train_step_turns(tfm, tcfg, tokens, card)

    # -- 10 paged attention against its plain version ----------------------
    paged_worst, paged_worst_route, paged_cases = paged_vs_plain(pa, ops)
    no_key_worst, no_key_cases = paged_no_key(pa)
    phase(10, "paged_vs_plain", kernel="paged_attention", cases=paged_cases,
          shapes=[[kind, b, t_] for kind, b, t_, _ in paged_grid()],
          head_dims=[16, 32, 64, 128], heads=list(PAGED_HEADS),
          block_size=PAGED_BS, table_width=PAGED_WIDTH,
          masked_rows="NaN for the kernel, clean for the plain version",
          max_abs_err=paged_worst, max_abs_err_by_route=paged_worst_route,
          no_attended_key={"cases": no_key_cases, "pos": -1,
                           "pools": "clean", "max_abs_err": no_key_worst},
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16]})

    # -- 11 the engine on the card ------------------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tfm.init_params(torch.Generator().manual_seed(0), cfg32, "cuda")
    pbf = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    p8 = tfm.quantize_params(pbf)
    prompts, lengths = engine_prompts()
    engine_report = {}
    for name, params, c, int8 in (("float32", p32, cfg32, False),
                                  ("bfloat16", pbf, cfg, False),
                                  ("int8", p8, cfg, True)):
        got, launches, ticks, stats = engine_run(
            LmEngine, ops, params, c, prompts, lengths)
        serial = [list(tfm.generate(params, c, p, n, readback_depth=0))
                  for p, n in zip(prompts, lengths)]
        if name == "float32":
            for p, g, s in zip(prompts, got, serial):
                check(g == s, f"float32 engine stream of a {len(p)}-token "
                              f"prompt {g} != serial generate {s}")
            agree = [{"equal": True, "tokens": len(g)} for g in got]
        else:
            agree = [agreement(tfm, params, c, p, g, s)
                     for p, g, s in zip(prompts, got, serial)]
        check(stats["prefix"]["hits"] >= 3,
              f"the shared 48-token prefix was not adopted: {stats}")
        engine_report[name] = {
            "streams": len(prompts), "equal_streams":
                sum(a["equal"] for a in agree),
            "divergent": [dict(a, prompt_tokens=len(p))
                          for a, p in zip(agree, prompts) if not a["equal"]],
            **check_launches(launches, ticks, c, params), **stats}
    # one preempted stream: 'lo' holds 26 of the 32 blocks when 'hi' comes
    eng = LmEngine(p32, cfg32, device="cuda", pool_tokens=512,
                   tenant_priority={"hi": 10.0}, **ENGINE_KW)
    try:
        pa_, pb_ = [256, 1, 2], [256, 7]
        qa, _ = eng.submit(pa_, 400, tenant="lo")
        first = qa.get(timeout=300)
        qb, _ = eng.submit(pb_, 100, tenant="hi")
        got_b = collect(qb, LmEngine.CLOSE)
        got_a = [first] + collect(qa, LmEngine.CLOSE)
        preempt = eng.preempt_stats()
    finally:
        eng.close()
    check(preempt["preemptions"] >= 1
          and preempt["resumes"] == preempt["preemptions"],
          f"no preemption and resume: {preempt}")
    for p, n, g in ((pa_, 400, got_a), (pb_, 100, got_b)):
        check(g == list(tfm.generate(p32, cfg32, p, n, readback_depth=0)),
              f"preempted run: the {len(g)}-token stream differs from "
              f"greedy")
    check(eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {},
          "KV audit after the preemption run")
    # one speculative run: k=4, n-gram drafter, repetitive prompts
    spec_prompts = [language.encode_text("abcabcabcabcabcabc").tolist(),
                    language.encode_text(PROMPT * 2).tolist(),
                    [256] + [7, 9, 11] * 8,
                    np.random.default_rng(6).integers(0, 256, 30).tolist()]
    got, launches, ticks, stats = engine_run(
        LmEngine, ops, p32, cfg32, spec_prompts, [64] * 4,
        speculative={"k": 4, "drafter": "ngram"})
    for p, g in zip(spec_prompts, got):
        check(g == list(tfm.generate(p32, cfg32, p, 64, readback_depth=0)),
              "speculative stream differs from greedy")
    check(stats["spec"]["accepted"] > 0 and ticks.get("verify", 0) > 0,
          f"speculation never engaged: {stats['spec']} {ticks}")
    engine_report["speculative"] = {
        "streams": len(spec_prompts), "tokens_each": 64,
        "equal_to_greedy": True, **check_launches(launches, ticks, cfg32,
                                                  p32), **stats}
    graph_report = {name: engine_graphs(LmEngine, ops, params, c,
                                        cfg.vocab_size)
                    for name, params, c in (("float32", p32, cfg32),
                                            ("bfloat16", pbf, cfg),
                                            ("int8", p8, cfg))}
    phase(11, "engine_graphs", config="DEFAULT_LM_CONFIG", engine=ENGINE_KW,
          speculative_k=4, **graph_report)
    phase(11, "engine", config="DEFAULT_LM_CONFIG", engine=ENGINE_KW,
          prompt_tokens=[len(p) for p in prompts], tokens=lengths,
          shared_prefix_tokens=48, near_tie=NEAR_TIE,
          preempted={"preempt": preempt, "equal_to_greedy": True,
                     "tokens": [len(got_a), len(got_b)]},
          kv_audit_after_close="clean", **engine_report)

    # -- 12 timings: paged attention, the engine ---------------------------
    paged_rows = paged_timings(pa, ext, graph)
    for row in paged_rows:
        phase(12, "paged_kernel_time", kernel="paged_attention", **row,
              **card)
    for name, params in (("bfloat16", pbf), ("int8", p8)):
        for n in (1, 4, 8):
            phase(12, "engine_rate", weights=name, **engine_rate(
                LmEngine, params, cfg, prompt, n), **card)
    profile = engine_profile(LmEngine, pbf, cfg, prompt)
    replay_ms = decode_replay_ms(LmEngine, pbf, cfg)
    phase(12, "engine_profile", weights="bfloat16", **profile,
          decode_replay_ms=replay_ms, replay_context=128,
          busy_share_from_replay_ms=(replay_ms * profile["decode_ticks"]
                                     / (profile["window_s"] * 1e3)),
          **card)

    # -- 13 vision: ResNet-50 and the CNN through the dynamic batcher ------
    # -- 14 the same, from CUDA shared memory of another process ----------
    vision_phase(card)

    # -- 15 the operational surface around the served engines -------------
    ops_launches, ops_routes = ops_phase(card, p32, cfg32, pbf, cfg, prompt)

    # -- 16 the mixture-of-experts LM, every LM path ---------------------------
    moe_counts = moe_phase(card, prompt)

    # -- 17 the builtin model set -------------------------------------------
    builtin_phase(card)

    # -- 18 the fleet tier: two replicas sharing one cache ------------------
    fleet_launches, fleet_routes = fleet_phase(card, p32, cfg32, pbf, cfg, p8)

    # -- 19 several devices: a one-rank mesh, a two-rank ring -----------------
    ring_launches, ring_rank_launches, phase_19_s = parallel_phase(card,
                                                                   tokens)

    # -- 21 the gRPC frontend ----------------------------------------------
    grpc_launches, grpc_routes = grpc_phase(card, prompt)

    # -- 22 perf_analyzer: in process, and over gRPC from other processes --
    perf_launches, perf_routes = perf_phase(card)

    # -- 23 the direct path on the captured graphs; perf_analyzer over HTTP -
    # -- 24 the asyncio clients, --async, two ranks, the service kinds -----
    # -- 25 the replica set across this server and a second process --------
    # -- 26 the native worker, procpool and SSL ------------------------------
    # -- 27 the witnesses, the chaos harness and the postmortem tools --------
    (http_launches, http_routes, (aio_launches, aio_routes),
     (balance_launches, balance_routes), native,
     (tls_launches, tls_routes),
     (chaos_launches, chaos_routes)) = http_phase(card)
    native_launches, native_routes = native

    # -- 29 the examples corpus against one server in this process ---------
    examples_launches, phase_29_s = examples_phase(card)

    # -- 20 kernels ----------------------------------------------------------
    by_shape = {(r["M"], r["K"], r["N"]): r for r in rows}

    def layer_total(m):
        layer = [by_shape[(m, k, n)] for k, n in LAYER_KN]
        return {key: sum(r[key] for r in layer)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "eager_ms")}

    total, prefill = layer_total(1), layer_total(64)
    phase(20, "kernels", held_against_plain_in="phases 3, 7, 10 and 19")
    moe_int8 = moe_counts["int8"]
    moe_paged = {route: sum(moe_counts[w]["routes"]["paged_attention"][route]
                            for w in ("bfloat16", "int8"))
                 for route in ("split", "mma")}
    kernels = [{
        "name": "int8_matmul",
        "kernel_route": "all",
        "device_kernels": ["int8_gemv_kernel", "int8_mma_kernel",
                           "int8_mm_kernel"],
        "route": "cuda",
        "source": "client_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "client_tpu/ops/quant.py:51",
        "launches": main_launches["int8_matmul"],
        "launches_serial": serial_launches["launches"]["int8_matmul"],
        "launches_phase_15": ops_launches["int8_matmul"],
        "launches_moe": moe_int8["launches"]["int8_matmul"],
        "launches_fleet": fleet_launches["int8_matmul"],
        "launches_grpc": grpc_launches["int8_matmul"],
        "launches_perf": perf_launches["int8_matmul"],
        "launches_http": http_launches["int8_matmul"],
        "launches_aio": aio_launches["int8_matmul"],
        "launches_balance": balance_launches["int8_matmul"],
        "launches_native": native_launches["int8_matmul"],
        "launches_tls": tls_launches["int8_matmul"],
        "launches_chaos": chaos_launches["int8_matmul"],
        "max_abs_err": max(worst.values()),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "library_ms": total["library_ms"],
        "eager_ms": total["eager_ms"],
        "timing": "ms, plain_ms, library_ms: device time from CUDA-graph "
                  "replay; eager_ms: back-to-back Python calls",
        "work": "one decode layer's six int8 projections at M=1, bf16 "
                "(wq, wk, wv, wo, w_gate, w_up)",
        "launches_in": "phase 5 (serving, counted at each CUDA-graph "
                       "replay); all routes, the GEMV's "
                       f"{main_routes['int8_matmul']['gemv']}; "
                       "launches_serial: phase 6's serial generate legs "
                       "through their CUDA graphs; launches_moe: "
                       "phase 16's int8 MoE engine streams; launches_fleet: "
                       "phase 18's int8 replicas; launches_grpc: phase "
                       "21's gRPC calls; launches_perf: phase 22's "
                       "in-process perf_analyzer legs; launches_http: "
                       "phase 23's perf_analyzer -i http LM leg; "
                       "launches_aio: phase 24's grpc.aio streams and "
                       "http.aio calls; launches_balance: phase 25's "
                       "balanced calls in replica A; " + NATIVE_LAUNCHES_IN
                       + "; " + CHAOS_IN,
        "checked_in": "phase 3",
    }, {
        "name": "int8_matmul",
        "kernel_route": "mma",
        "device_kernels": ["int8_mma_kernel"],
        "route": "cuda",
        "source": "client_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "client_tpu/ops/quant.py:51",
        "launches": main_routes["int8_matmul"]["mma"],
        "launches_serial": serial_launches["routes"]["int8_matmul"]["mma"],
        "launches_phase_15": ops_routes["int8_matmul"]["mma"],
        "launches_moe": moe_int8["routes"]["int8_matmul"]["mma"],
        "launches_fleet": fleet_routes["int8_matmul"]["mma"],
        "launches_grpc": grpc_routes["int8_matmul"]["mma"],
        "launches_perf": perf_routes["int8_matmul"]["mma"],
        "launches_http": http_routes["int8_matmul"]["mma"],
        "launches_aio": aio_routes["int8_matmul"]["mma"],
        "launches_balance": balance_routes["int8_matmul"]["mma"],
        "launches_native": native_routes["int8_matmul"]["mma"],
        "launches_tls": tls_routes["int8_matmul"]["mma"],
        "launches_chaos": chaos_routes["int8_matmul"]["mma"],
        "max_abs_err": worst_route["mma"]["bfloat16"],
        "ms": prefill["ms"],
        "plain_ms": prefill["plain_ms"],
        "bound_ms": prefill["bound_ms"],
        "bound_by": "bytes",
        "library_ms": prefill["library_ms"],
        "eager_ms": prefill["eager_ms"],
        "timing": "ms, plain_ms, library_ms: device time from CUDA-graph "
                  "replay; eager_ms: back-to-back Python calls",
        "work": "one prefill chunk's six int8 projections at M=64, bf16 "
                "(wq, wk, wv, wo, w_gate, w_up)",
        "launches_in": "phase 5 (serving: prefill chunks, counted at "
                       "each CUDA-graph replay); launches_serial: phase "
                       "6's serial prefill replays; launches_moe: phase 16's "
                       "int8 MoE engine streams; launches_fleet: phase 18's "
                       "int8 replicas; launches_grpc: phase 21's gRPC "
                       "calls; launches_perf: phase 22's in-process "
                       "perf_analyzer legs; launches_http: phase 23's "
                       "perf_analyzer -i http LM leg; launches_aio: "
                       "phase 24's grpc.aio streams and http.aio calls; "
                       "launches_balance: phase 25's balanced calls in "
                       "replica A; " + NATIVE_LAUNCHES_IN + "; " + CHAOS_IN,
        "checked_in": "phase 3",
    }]
    sources = {"flash_fwd": "client_tpu_torch/ops/csrc/flash_fwd_bf16.cu",
               "flash_bwd_dq": "client_tpu_torch/ops/csrc/flash_bwd_bf16.cu",
               "flash_bwd_dkv": "client_tpu_torch/ops/csrc/flash_bwd_bf16.cu"}
    replaces = {"flash_fwd": "client_tpu/ops/flash_attention.py:91",
                "flash_bwd_dq": "client_tpu/ops/flash_attention.py:185",
                "flash_bwd_dkv": "client_tpu/ops/flash_attention.py:215"}
    for name in FLASH_KERNELS:
        row = flash_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": train_launches[name],
            "launches_per_replay": per_replay[name],
            "launches_moe": moe_counts["train"]["launches"][name],
            "launches_ring_flash": ring_launches[name],
            "launches_ring_2rank": [r[name] for r in ring_rank_launches],
            "max_abs_err": max(flash_worst[name].values()),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "timing": "device time from CUDA-graph replay",
            "work": f"one layer's attention at the training shape: "
                    f"[{bh}, {t}, {d}] bf16, causal",
            "launches_in": f"phase 8 ({TRAIN_STEPS} flash train steps: "
                           f"the first eager, then one CUDA graph "
                           f"captured and replayed, launches_per_replay "
                           f"a replay); launches_moe: phase 16's "
                           f"{TRAIN_STEPS} eager MoE flash steps; "
                           f"launches_ring_flash: phase "
                           f"19a's {RING_STEPS} ring_flash steps on a "
                           f"one-rank mesh; launches_ring_2rank: each "
                           f"phase 19b rank's forward and backward",
            "checked_in": "phase 7",
        })
    for route, device_kernels, shape, ctx, work in (
            ("split", ["paged_split_kernel", "paged_combine_kernel"],
             "decode", 511,
             "one decode tick's attention of one layer: B=8 lanes at "
             "context 511, 8 heads over 4 KV heads, hd 32, bf16"),
            ("mma", ["paged_mma_kernel", "paged_combine_kernel"],
             "prefill", 256,
             "one prefill chunk's attention of one layer: T=64 ending at "
             "key 256, 8 heads over 4 KV heads, hd 32, bf16")):
        row = next(r for r in paged_rows
                   if r["shape"] == shape and r["context"] == ctx)
        kernels.append({
            "name": "paged_attention",
            "kernel_route": route,
            "device_kernels": device_kernels,
            "route": "cuda",
            "source": "client_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "client_tpu/serve/models/transformer.py:357 (jnp in "
                        "the reference, not Pallas)",
            "launches": main_routes["paged_attention"][route],
            "launches_phase_15": ops_routes["paged_attention"][route],
            "launches_moe": moe_paged[route],
            "launches_fleet": fleet_routes["paged_attention"][route],
            "launches_grpc": grpc_routes["paged_attention"][route],
            "launches_perf": perf_routes["paged_attention"][route],
            "launches_http": http_routes["paged_attention"][route],
            "launches_aio": aio_routes["paged_attention"][route],
            "launches_balance": balance_routes["paged_attention"][route],
            "launches_native": native_routes["paged_attention"][route],
            "launches_tls": tls_routes["paged_attention"][route],
            "launches_chaos": chaos_routes["paged_attention"][route],
            "max_abs_err": max(paged_worst_route[route].values()),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "timing": "device time from CUDA-graph replay",
            "work": work,
            "launches_in": "phase 5 (serving, counted at each CUDA-graph "
                           "replay; one count a call: a split kernel and "
                           "the combine); launches_moe: phase 16's bf16 "
                           "and int8 MoE engine streams; launches_fleet: "
                           "phase 18's replicas, float32, bf16 and int8; "
                           "launches_grpc: phase 21's gRPC calls; "
                           "launches_perf: phase 22's in-process "
                           "perf_analyzer legs; launches_http: phase "
                           "23's perf_analyzer -i http LM leg; "
                           "launches_aio: phase 24's grpc.aio streams "
                           "and http.aio calls; launches_balance: phase "
                           "25's balanced calls in replica A; "
                           + NATIVE_LAUNCHES_IN + "; " + CHAOS_IN,
            "checked_in": "phase 10",
        })
    for kernel in kernels:
        kernel["launches_examples"] = examples_launches[kernel["name"]]
        kernel["launches_examples_in"] = (
            "phase 29's examples against this process's server, counted "
            "from just before its first run to just after its last")
    phase(0, "script_seconds", seconds=process_seconds(),
          phase_19=phase_19_s, phase_29=phase_29_s,
          phases_22_26={str(k): v for k, v in sorted(PHASE_SECONDS.items())},
          phases_22_26_total=sum(PHASE_SECONDS.values()), **card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
