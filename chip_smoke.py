#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU and the CUDA toolkit; exits non-zero without them.
Phases (each one fails the run if its check fails):

1. card: the GPU's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (matmul, wkv, ssm, attention), one nvcc per source, all started together;
3. GEMM against plain: every compiled matmul config, in bf16->bf16,
   bf16->f32 and f32->f32, at ragged shapes, at the split-k boundaries (k <
   block_k, k not a multiple of block_k x splits, m = 1, n = 16), at a
   16-byte-misaligned base (the cp.async path) and at every GEMM shape that
   full-width granite-8b, rwkv6-7b and hymba-1.5b serving, and phase 24's five
   models (with the VLM's cross K / V over 1024 image rows), give the kernel,
   and in f32 alone (1024, 4096, 1024) and seamless's head gradient (1024,
   256256, 1024), which the f32 kernel splits along k, against
   ``matmul_plain`` (TF32 off), each config called twice in a row on the same
   inputs: both within the limit and bitwise equal (the split-k counters are
   left at 0 and the partials summed in split order); then 8 more passes over
   the bf16 pairs with fresh inputs, for races; compute-bound shapes
   (``PERSISTENT_SHAPES``: 3 and 5 tile rows, n off the tile edge) take the
   persistent kernel, which must launch; then the transposed operands at every
   bf16 config (lhs as ``.t()`` of its transpose, then rhs), twice each,
   within the same limits and bitwise equal, read in place on the TMA path
   (never copied there).  Error = max|kernel - plain| / max|plain|; limits
   1e-2 (bf16 out), 1e-3 (f32 out from bf16), 1e-5 (f32 in; x sqrt(K /
   16384) above K = 16384, ``matmul.f32_limit``); split f32 launches must
   occur;
3b. WKV against plain: every compiled chunk config, r/k/v in bf16 and f32,
   head dims 16 and 64, S in {1, 7, 16, 50, 128, 300} (and the served
   (1, S, 64, 64) at S in {32, 64, 128}), with and without an initial state,
   nonzero u, decays drawn as the reference test draws them, at the clamp
   (-5) and a -5 / -1e-3 mix, and one long case (1, 2048, 64, 64) in bf16
   with a state, against ``wkv_plain`` (TF32 off), each config called twice
   on the same inputs.  Limit 1e-4 relative to max|plain| for the output and
   the final state; every output finite; both calls bitwise equal;
4. full-width granite-8b serving: unreduced (d_model 4096, 32 heads, 8 KV
   heads, d_ff 14336, vocab 49152, 36 layers), bf16, random weights from a
   CUDA generator, ServingEngine(max_batch=4, cache_len=256), which serves
   through CUDA graphs (one per prefill bucket and decode width), 4 requests
   of 8-100 tokens, 16 new tokens each, twice on one engine: a cold drain
   (every program warmed up and captured) and a warm drain (replays only),
   with equal streams; tokens/s, prefill times and the decode step for both.
   The wrappers count launches in Python, so they count each program's
   warm-up and capture: the GEMM launches must be 2 x (7 * n_layers + 1) per
   program, every one on the TMA path, none in the warm drain; the selection
   consulted once per call of each program's warm-up (in the scanned
   granite-8b and rwkv6-7b once per layer body: layer 0's calls and the
   head's) and pinned for its capture; the engine's replays must equal the
   forwards (phases 8, 12 and 19 likewise);
5. selection reaches the kernel: one request under a FixedPolicy with a
   non-default matmul config launches that config and not the default;
5b. profile (torch.profiler, which sees the kernels inside a replay): two warm
   decode replays and one warm prefill replay at bucket 32, each with 7 *
   n_layers + 1 GEMM kernels a forward, one window each and an exact count;
   device time by kernel, idle share (1 - busy / the window's host wall), and
   from the device timeline the idle time inside each replay's span and
   between the replays;
5c. the eager engine (``cuda_graphs=False``) on the same weights and
   requests (its programs warmed up once, then one warm drain): a captured
   decode replay bitwise equal to its body run eagerly; token streams equal
   to the graphed engine's; warm decode step, idle share
   (profiled, and an estimate from the unprofiled median), tokens/s, seconds
   building programs and memory reserved side by side
   (phases 9c and 13c likewise);
6. CPU against card: the serving CLI on reduced granite-8b in f32, once with
   ``--device cuda`` and once with ``--device cpu``, same seed: equal greedy
   token streams;
7. GEMM timing: each served granite GEMM shape with CUDA events (median of 20
   after warm-up, each call queued behind a device sleep so that the events
   hold device time, weights rotated through more than the 50 MB L2), beside
   its bound max(FLOPs / 989e12, bytes / 3.35e12), one call from an idle
   device (host launch work included), the plain version and torch.matmul (a
   yardstick only: the port never calls it); and the tall harvest GEMM
   (16384, 4096, 14336) under every config with its TFLOP/s;
8. full-width rwkv6-7b serving, after granite's weights are released:
   unreduced (32 layers, d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab
   65536), bf16, the same engine and requests.  A forward launches the
   GEMM 10 * n_layers + 1 times, a prefill the WKV kernel n_layers times and
   a decode step 0 times (counted at warm-ups and captures);
9. selection reaches the WKV kernel: one request under
   FixedPolicy(wkv_config=WkvConfig(64)) launches wkv_c64 and not wkv_c16;
9b. profile: as 5b; the prefill replay runs n_layers of each WKV kernel;
9c. eager against graphed, as 5c;
10. CPU against card: the serving CLI on reduced rwkv6-7b in f32, cuda and
   cpu: equal greedy token streams;
11. timing: the WKV kernels at (1, S, 64, 64), S in {32, 64, 128, 2048},
   every chunk config, beside its bound max(bytes / 3.35e12, 5 hd^2 f32
   operations per token and head / 67e12) and the plain version, and the
   kernels one call launches (the state pass and the output kernel); the
   GEMM at rwkv6-7b's decode shapes as in phase 7;
3c. (run with phase 3) SSM against plain: both entries (``ssm_cuda`` from dtx
   and dta, ``ssm_cuda_fused`` from x, dt and a) at every compiled (block_d,
   chunk) config, state sizes 8 and 16, with and without an initial state, S
   in {1, 7, 50, 128, 300} at a ragged d = 100 and at d = 50 (not a multiple
   of 4: the 4-byte copies), the served (1, S, 1600, 16) at S in {32, 64,
   128}, and (1, 2048, 1600, 16) with a state, dta drawn as the reference test
   draws it (-exp(0.3 normal)) and dt * a alike, against ``ssm_plain`` /
   ``ssm_fused_plain``, each config called twice on the same inputs, each call
   launching the segments ``ssm.launch_segments`` names, the 300- and
   2048-step cases also cut into 2, 3, 5 and 7 segments (as far as the chunks
   reach).  Limit 1e-4 relative to max|plain| for y and the final state; every
   output finite; both calls bitwise equal;
12. full-width hymba-1.5b serving, after rwkv6-7b's weights are released:
   unreduced (32 layers, d_model 1600, 25 heads, 5 KV heads of 64, d_ff 5504,
   vocab 32001, ssm_state 16, window 2048), bf16, the same engine and
   requests.  A forward launches the GEMM 13 * n_layers + 1 times, a
   prefill the SSM kernel n_layers times, all through ``ssm_cuda_fused``
   (none through the dta entry), and a decode step 0 times;
13. selection reaches the SSM kernel: one request under
   FixedPolicy(ssm_config=SsmConfig(8, 16)) launches ssm_bd8_c16 n_layers
   times at its prefill program's warm-up and again at its capture, and the
   default not at all;
13b. profile: as 5b; the prefill replay runs n_layers ``ssm_output_kernel``;
13c. eager against graphed, as 5c; then a cut SSM call on a stream with no
   workspace yet raises under a capture (a workspace is allocated only outside
   one, at its fixed bound);
14. CPU against card on Hymba, in process: reduced hymba-1.5b at 4 layers
   (one sliding-window layer, window 32), f32, cache_len 128, prompts of 20
   and 45 tokens (buckets 32 and 64: the ring is written by the ring-buffer
   prefill and wraps in decode), 16 new tokens each: equal greedy token
   streams on cuda and cpu;
15. timing: both SSM entries at (1, S, 1600, 16), S in {32, 64, 128, 2048},
   every config, each beside its own bound max(bytes / 3.35e12, 6 f32
   operations per (t, channel, state) / 67e12) (the fused entry reads x, dt
   and a; the dta entry dtx and the (B, S, d, N) dta), the plain version, the
   segments the default config launches and the kernels one call launches
   (torch.profiler: ssm_output_kernel, and ssm_state_kernel where the call is
   cut); the GEMM at hymba-1.5b's decode shapes as in phase 7;
16. attention against plain: every compiled (block_q, block_kv) config, q/k/v in
   bf16 and f32, head dims 64 and 128, causal and not, at (2, 3) heads for (sq,
   skv) in {(1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000), (300,
   200), (1, 4103), (4, 4103), (1, 32768), (4, 32768)} and (40, 24) (sq > skv:
   the rows that see nothing must be zeros), and at the served (1, 32, 1, 32768)
   and (1, 32, 4096, 4096), against ``attention_plain`` (TF32 off), each config
   called twice in a row (bitwise equal: the split-KV combine runs in split
   order and leaves its counters at 0), on the path its block_q names (wgmma at
   64 and 128, mma.sync at 32, SIMT for f32), split into as many KV splits as
   ``attention.launch_splits`` names (every decode shape splits); then 8 more
   passes over the bf16 shapes with fresh inputs.  Limits relative to
   max|plain|: 1e-2 for a bf16 output, 1e-4 for f32; every output finite;
   then the SASS of every attention kernel (``scripts/attn_race.py``): no
   stage release may leave a shared load of the ring in flight (block_q 32's
   release overtook its ldmatrix loads, and a TMA overwrote a V tile still
   being read: 4 wrong results in 36,000 calls before the fix), nor may
   the GEMM's wgmma kernels' (the persistent kernel's releases are read);
17. tune on the card, every family, as the fleet of the card and host_cpu:
   ``python -m repro_torch.launch.tune --devices <card>,host_cpu --archs
   granite-8b,rwkv6-7b,hymba-1.5b --n-kernels 4 --cpu-problems 8 --bundle
   build/bundle_h100.json --out build/deploy_h100.json`` in process (one
   tune: ``--out`` is the fleet's card Deployment): the matmul (99 problems x 12 configs), attention (11 x 9), WKV
   (4 x 5, through ``wkv_cuda`` at 64 heads, bf16) and scan (3 x 9, through
   ``ssm_cuda_fused``) tables measured with the port's kernels, every cell
   (``measured_fraction`` 1.0, full config-space widths, every family's
   launch counter moving), the paper's pipeline, the bundle and the Deployment
   written; the seconds and the oracle and classifier fractions of each family
   (and each deployment's oracle over the whole measured table);
17b. the staged bring-up: the same tune with ``--transfer-from`` phase 17's
   deployment, ``--prune-ratio 0.5`` and ``--measure-budget auto``: each
   family's measured fraction at most its resolved budget; its measured
   cells, seconds against phase 17's, the H100 model's error on the measured
   cells, and the staged deployment's oracle fraction over phase 17's full
   table;
17c. the fleet bundle of phase 17, loaded back (v6, checksums verified, no load
   errors); detection resolves the card's entry, and ``REPRO_DEVICE="NVIDIA
   A100-SXM4-80GB"`` resolves it through the same-platform step; the
   reference's TPU fixture ``tests/data/bundle_v5.json`` must not install on
   the card. Then rwkv6-7b and hymba-1.5b, full width in f32, serve phase 8's
   and 12's batches from the bundle through ``launch.serve``'s ``--bundle``
   path (``build_engine``) under CUDA graphs, beside the ``FixedPolicy()``
   engine: the WKV and scan configs the served prefills launched, by
   bucket, are the tree's; whether the greedy streams are equal.  The
   logits of each prompt's captured prefill program against
   ``FixedPolicy()``'s: within 2e-3 (rwkv6-7b) and 1e-4 (hymba-1.5b) of
   max|FixedPolicy()'s| on engines of the model's first 8 layers built the
   same way (required; each limit between the readings of
   ``scripts/logit_gate_draws.py``), and at full
   depth (reported: a deep random-weight model amplifies f32 rounding);
18. the quickstart's path: the Deployment loaded into a fresh KernelRuntime
   (selection logging on); under ``rt.activate()``, ``ops.attention`` at every
   harvested attention problem at (1, 32) heads in bf16, twice (the second a
   shape-cache hit), each call launching exactly the config
   ``Deployment.select_attention`` names (every decode problem split into more
   than one KV split) and matching the plain version within 1e-2;
   ``ops.matmul`` at the quickstart's two shapes launching the tree's matmul
   config.  Each problem's path, KV splits, kernel, plain and SDPA times beside
   its bound;
19. full-width granite-8b served as in phase 4 under the tuned Deployment: 7 *
   n_layers + 1 GEMM launches per forward, the split over the deployed configs,
   tokens/s, the decode step, and one decode step's GEMM device time under the
   tree's choices (from phase 7's per-config times) beside the default config's
   and each shape's best; whether the greedy streams equal phase 4's;
19b. profile: as 5b, under the tuned tree;
19c. ``FixedPolicy()`` installed mid-run in the tuned engine's runtime: the
   programs are captured again under the new epoch (prefill and decode), and
   their launches take the default config;
20. attention timing: every config at granite-8b's (1, 32, S, 128) and
   hymba-1.5b's (1, 25, S, 64), causal S in {512, 2048, 4096} and a decode step
   at 4096 and 32768 cached tokens, beside the bound max(FLOPs / 989e12, bytes /
   3.35e12), one call from an idle device, the plain version and SDPA with
   ``causal_lower_right`` (a yardstick only: the port never calls it);
20b. only where ``build/parent`` holds another checkout (the parent commit):
   ``scripts/gemm_ab.py`` times its GEMM and this tree's in turns (parent,
   this, this, parent) at every decode-step GEMM shape of the three models and
   the tall GEMM, and one decode step's GEMM time of each model, summed with
   the launch counts of phases 4, 8 and 12;
20c. only where ``build/parent`` holds the parent commit: ``scripts/attn_ab.py``
   times its attention kernel and this tree's in turns (parent, this, this,
   parent), every config at every problem of phases 18 and 20, and checks
   each decode shape at least 2x the parent and no prefill shape more than 5%
   slower (reported, not required);
20d. only where ``build/parent`` holds the parent commit: ``scripts/ssm_ab.py``
   times its selective scan and this tree's in turns (parent, this, this,
   parent) at (1, S, 1600, 16), S in {32, 64, 128, 2048}, every config of the
   dta entry (both trees have it) and of the fused entry (this tree);
21. fault containment and continuous tuning on the tuned granite-8b (run after
   19c, before its weights go):
   21a. guarded dispatch on direct ``ops`` calls: ``dispatch.matmul:compile_error``
   keyed on the config the tree serves at a decode shape is redirected to
   ``DEFAULT_CONFIG``, bitwise equal to a direct launch, incident ``quarantined``;
   ``QUARANTINE_BACKOFF`` more calls: redirected, then one re-probe, absolved; a
   ``nan`` fault caught by output validation and redirected; the same redirect for
   ``ops.wkv`` (1, 32, 64, 64) and ``ops.ssm_scan_fused`` (1, 32, 1600, 16); a fault
   on ``DEFAULT_CONFIG`` itself raises with ``unrecoverable``; host µs per eager
   call (direct ``matmul_cuda``, ``ops.matmul`` with no plan and with an armed plan
   that never fires);
   21b. phase 19's batch drained under ``engine.prefill:compile_error,
   engine.decode:compile_error:1:5`` and a ``dispatch.matmul:compile_error``
   keyed on the config other than ``DEFAULT_CONFIG`` that phase 19's tree
   selected most often among those whose outputs equal the default's bitwise at
   every problem the tree served them (a fault on the default itself is
   unrecoverable on the card, 21a; a redirect to a config that rounds otherwise
   may flip a greedy token). The breaker re-probes a config only after
   ``QUARANTINE_BACKOFF`` more selections, and a graphed engine selects only
   while it builds a program (once per problem in a scanned model), so the
   config must be selected more than that often in a clean drain. With no such
   config, the config the tree selected most often is replaced in the
   deployment by a compiled one that is bitwise neutral there, and the fault
   keyed on that.
   Under CUDA graphs: every request completes, 2 engine retries, the
   dispatch fault fired once and redirected, the programs dropped and
   captured again (and their seconds), health back to healthy, greedy streams
   equal to a clean drain of the same deployment (and, where it is phase
   19's, the clean drain's equal to phase 19's);
   21c. an engine served from phase 17's bundle adopts the card's bundle entry
   (offered, loaded again) at a step boundary, then, with ``retune_interval``,
   drains the batch (whose buckets the harvest lacks), retunes matmul on
   ``gpubench`` tables of the drifted problems, canaries the candidate on the
   card (``matmul_cuda`` at its config; an ``attention_cuda`` probe too) and
   hot-swaps it: events, seconds to measure, fit and canary, epochs, programs
   captured again, warm decode median before and after; a
   ``canary.matmul:nan`` candidate rejected; a forced swap rolled back by
   ``rollback_threshold`` injected decode faults (captured again);
   21d. ``OnlinePolicy`` with the CUDA-event measurer on direct ``ops.matmul``
   calls at granite-8b's decode shapes: warm-up cost, commits per bucket, how
   many equal phase 7's per-shape best;
22. the paged serving tier on the card (after 20d):
   22a. full-width granite-8b (bf16) under the tuned Deployment on the paged,
   prefix-shared, chunked engine (``max_batch=4``, ``cache_len=256``,
   ``block_size=16``, ``prefill_chunk_tokens=32``, 18 blocks) under CUDA
   graphs: 8 requests sharing a 64-token system prompt (tails 8-40, 24 new
   tokens; prompt 0 alone for two steps, the last two after decode step 4 at
   priority 2): all complete, >= 1 preemption, >= 6 prefix hits; the eager
   engine over the same traffic gives equal streams, ``EngineStatus`` and a
   bitwise-equal pool; a dense engine beside it (warm decode medians, first
   tokens, pool bytes, gather/scatter bytes a step from shapes, chunk
   programs and their seconds);
   22b. an 8-layer full-width granite-8b in f32: equal greedy streams at chunk
   32, chunk 128 and with sharing off, the CPU's equal to the card's, and a
   chunk program captured at start 0 replayed at starts 0 and 32 within 1e-5
   of eager calls;
   22c. SLO mode on 22a's engine: two requests targeted at 0.5x 22a's warm
   decode median, then one at 3x behind a long prompt: the mode enters and
   leaves, programs are captured again under the objective (their seconds),
   the configs the objective changed;
   22d. an int8 KV cache (paged, legacy admission): ``quantize_kv`` on the card
   within half a step of its input (its values at most one step and its
   scales 1e-6 off the CPU's); token agreement with the bf16 dense engine,
   warm decode median and pool bytes;
   22e. a ``Router`` over two engines on the card (own runtimes, one set of
   weights): prefix affinity over load, both engines take traffic, a targeted
   request avoids the engine in SLO mode, the aggregate status; the fleet
   bundle's ``router(devices=[card])`` serves one request;
   22f. full-width hymba-1.5b (bf16) under a paged pool: streams equal to the
   dense engine's, every SSM launch through ``ssm_cuda_fused``;
23. the tuning control plane (``repro_torch.control``) in process on
   127.0.0.1, driven over HTTP, with a registry under ``build/registry``
   and every retune's matmul table measured on the card:
   23a. a tune job (every family, ``TUNED_ARCHS``, 4 kernels, every cell
   measured): queued -> running -> succeeded, every family measured with
   launches, publishing the bundle again gives the same version, a
   ``transfer`` spec and a ``tpu_v5e`` spec fail with the tune CLI's and
   ``tune_fleet``'s messages; seconds and cells against phases 17 / 17b,
   oracle over phase 17's full table, ``/healthz``;
   23b. full-width granite-8b (bf16, CUDA graphs) served from
   ``registry://`` by two engines (own runtimes, one set of weights) over
   phase 19's prompts; their telemetry posted as two hosts: merged events
   equal the sum, the drift starts one retune job (a post while it runs
   starts none), measured on the card; the child (parent: 23a's version) is
   announced, delivered to the subscribed engine, and adopted at the next
   step with the programs captured again; latencies from post to adoption,
   recapture seconds, warm decode median before and after, the GEMM
   selections the child changed;
   23c. a runtime subscribed from seq 0 holds the child; direct
   ``ops.matmul`` calls at three granite-8b decode shapes launch the
   child's configs within phase 3's tolerance of ``matmul_plain``;
   23d. a retune job measures while the engine adopts and captures its
   programs again (the capture drain starts inside the measurement): both
   succeed, the replayed streams equal an eager engine's; the job's table
   against 23b's on the common cells;
   23e. ``launch.ctl status`` and ``artifacts`` list every version with its
   lineage; the subscribers and the plane stop within the poll timeout +
   15 s;
24. the remaining decoder architectures at full width in bf16 (random weights
   from a CUDA generator), one after another, each freed and collected before
   the next: 24a qwen3-moe-235b-a22b (cut in depth: 8 of 94 layers), 24b
   dbrx-132b (8 of 40), 24c qwen2.5-32b (QKV bias, all 64), 24d glm4-9b (all
   40), 24e llama-3.2-vision-90b (20 of 100: 4 groups of 4 self layers and a
   cross block, image embeddings from the generator as the engine's
   ``extra_inputs``). Each: phase 4's engine and requests, a cold then a warm
   drain with equal streams, tokens/s, prefill times, the decode step,
   ``max_memory_allocated``; GEMM launches of every program equal to 2 x its
   forward's (MoE 5 a layer, dense 7, a VLM group 7 (cross_every - 1) + 9 at
   prefill and + 5 at decode, and the vocab GEMM), all through matmul.cu;
   one selection per call of a build's scanned bodies; for an MoE model the
   expert einsums' device time a warm decode step, by CUDA events at the
   replay's shapes (a library call, as the reference's ``jnp.einsum``) beside
   the bytes of every expert's weights; then an eager engine's drain with
   the same streams;
   24f. CPU against card, in process, f32: reduced qwen3-moe-235b-a22b (dense
   pool; paged, prefix-shared, 32-token chunks), llama-3.2-vision-90b (seeded
   image embeddings; dense and paged) and qwen2.5-32b (seeded nonzero QKV
   biases): equal greedy streams;
25. training on the card (every plain version, the backward ones included,
   refused on a CUDA tensor throughout 25a-25f):
   25a. the GEMM's gradient: ``ops.matmul`` under grad (the ``repro_torch::gemm``
   op: ``grad_lhs = grad_out . rhs^T`` featurized as the forward, ``grad_rhs =
   lhs^T . grad_out`` over the flattened rows, both through ``ops.matmul``) at
   granite-8b's and seamless-m4t-large-v2's training shapes (B*S = 1024 rows;
   (k, n) of their Q, K/V, O, FFN and vocab GEMMs, seamless's head a K = 256,256
   reduction in grad_lhs) and phase 3's split-k / cp.async edges, bf16 and f32: the
   output and both gradients against autograd of ``matmul_plain`` on the card
   (TF32 off) within phase 3's limits, 3 launches a forward + backward, split
   f32 launches among them (granite-8b's K/V projection and seamless's head
   gradient: 64 output tiles), the transposed operands each case's backward
   copied (``matmul.TRANSPOSE_COPIES``: none for bf16 at the training shapes,
   whose backward the TMA path reads in place; two for f32); each
   of the three GEMMs of every granite projection timed with CUDA events
   beside its bound, the plain version and torch.matmul (bf16 gradients on the
   transposed views), with the ratio to torch.matmul of one layer's sums, and
   what a transpose copy costs; where ``build/parent`` holds the parent
   commit, ``scripts/gemm_ab.py --f32`` times the parent's f32 kernel and this
   one in turns at one granite-8b layer's GEMMs and seamless's head gradient,
   and ``--train`` the bf16 tall GEMM and the layer's three GEMMs;
   25b. granite-8b at full width (d 4096, ff 14336, vocab 49152), 2 of 36
   layers, f32 as the launcher trains: ``Trainer`` for 6 steps at batch 8, seq
   128, remat "full" (its final checkpoint included): the loss falls, every
   parameter has a non-zero gradient, GEMM launches per step = forward +
   recompute + 2 backward per GEMM (59), all on the SIMT path; step ms (warm
   median), peak memory, one profiled step (its GEMM kernels' time and share;
   the kernels it recorded) beside an estimate of the step's GEMM time from
   25a's CUDA-event times; then 3 bf16
   steps (TMA / wgmma, no SIMT launch; the persistent kernel launched, no
   transposed operand copied);
   25c. resume on the card (reduced granite-8b, f32): 6 steps against 3 +
   resume + 3, params within 1e-4 (a limit set while the embedding's
   backward added with atomics; its gradient is now an ordered sum,
   layers.table_grad, and the run prints the worst difference);
   25d. seamless-m4t-large-v2 at its full size (24 + 24 layers, d 1024, vocab
   256206, about 2.0 B params), f32: 3 loss_fn + AdamW steps at batch 8, seq
   128 (GEMM launches by the same formula; the loss falls), then prefill and 4
   decode steps from the params the steps return (no grad left on them);
   seconds and peak memory;
   25e. one train step's loss and every gradient, card against CPU: reduced
   granite-8b, qwen3-moe-235b-a22b, qwen2.5-32b (seeded nonzero biases),
   llama-3.2-vision-90b (bf16 image embeddings), seamless-m4t-large-v2
   (the encoder, cross-attention over its memory), and rwkv6-7b and
   hymba-1.5b at 4 layers (through the WKV / scan backward kernels: one
   launch a layer), within 1e-5 (loss) and 1e-4 of each gradient's max (1e-2
   for the VLM's three bf16-fed cross leaves); granite-8b again under remat
   "dots" on the card (the selective-checkpoint policy keeps the GEMM
   outputs: no GEMM launched in the recompute);
   25f. the recurrences' backward kernels and RWKV6 / Hymba training (its
   seconds printed):
   25f-i. the WKV backward (csrc/wkv_bwd.cu) at every compiled (chunk, hd),
   bf16 and f32 r/k/v, a ragged S and an S below the chunk, with and without
   an initial state and a final-state cotangent, at the wrapper's segments
   and in one segment: every gradient against autograd of ``wkv_plain`` on
   the card (TF32 off) within 1e-4 of its max (bf16 leaves 1e-2), and f32
   against f64 autograd within 1e-4 (the f32 plain's own gap printed beside
   it); two calls bitwise equal; at rwkv6-7b's training shape (B 8, S 128,
   H 64, hd 64), f32 and bf16, and the long (1, 2048, 64, 64) f32 call,
   checked and repeated as that, then timed with CUDA events beside its
   bound (the function's bytes and operations) and autograd of the plain
   version, with the walk's registers, spills, shared memory, CTAs an SM,
   grid, waves and segments; at the training shape one kernel a call and
   no state-gradient workspace; where ``build/parent`` exists, the parent's
   backward in turns (``scripts/wkv_ab.py --bwd``);
   25f-ii. the scan backward (csrc/ssm.cu ``ssm_bwd_kernel``), both entries,
   every compiled config and N 8 and 16, the same cases, and a long (1, 2048,
   1600, 16) call, each against f64 too; checked, repeated and timed at
   hymba-1.5b's shape (B 8, S 128, d 1600, N 16) as 25f-i, with the
   kernel's registers, CTAs an SM and waves there; where ``build/parent``
   exists, the parent's backward in turns (``scripts/ssm_ab.py --bwd``);
   25f-iii. rwkv6-7b at full width (d 4096, ff 14336, vocab 65536), 2 of 32
   layers, f32: ``Trainer`` 6 steps at batch 8, seq 128, remat "full"; the
   loss falls, every parameter has a non-zero gradient, per step and layer the
   WKV op runs forward, recompute and backward (2 forward-kernel launches, 1
   backward-kernel launch), GEMM launches per step from the code; warm step
   ms, peak memory, a profiled step's share of the backward kernels; then 3
   bf16 steps;
   25f-iv. hymba-1.5b whole (32 layers, ~1.5 B params), f32, as 25f-iii
   through the fused scan's backward;
   25g. ``python -m repro_torch.launch.train --arch granite-8b --reduced
   --steps 4 --batch 2 --seq 16 --ckpt-every 2 --deployment
   build/deploy_h100.json``, then the same with ``--arch rwkv6-7b``: exit 0,
   checkpoints at steps 2 and 4;
26. distribution on the card (granite-8b and rwkv6-7b at full width, 2
   layers, f32, batch 8 x seq 128, 3 steps; params, AdamW moments and batch
   as DTensors placed by ``dist.sharding``; every GEMM and WKV through its
   op's sharding rule onto the hand-written kernels):
   26a. a world-1 NCCL group, mesh (1, 1): the Trainer's sharded steps
   against the unsharded steps from the same init, every metric and leaf
   after each step within 1e-6 of its max (bitwise equality printed), the
   GEMM / WKV kernel launches of the sharded steps counted;
   26b. two processes on the one card (``--dist-child``): NCCL refuses two
   ranks on one device, so a gloo group (its collectives move the card's
   tensors through host memory; computing stays on the card), mesh (2, 1),
   granite-8b FSDP over ``data`` as ``param_pspecs`` gives it, each process
   holding half the params and moments and feeding its host shard of the
   batch: the losses and every gathered leaf within 1e-5 of one process's
   unsharded steps on the global batch;
   26c. ``REPRO_NUM_PROCESSES=2 python -m repro_torch.launch.train --fleet
   --dist-backend gloo --arch granite-8b --reduced --steps 4 --ckpt-every 2
   --deployment build/deploy_h100.json``: both processes exit 0,
   checkpoints at steps 2 and 4, a two-process resume to 6, the step-4 loss
   within 1e-5 of one process on the global batch;
   26d. qwen3-moe-235b-a22b at full width (d 4096, 128 experts of ff 1536,
   top 8, vocab 151936), 1 of 94 layers, f32, batch 8 x seq 128 (capacity
   80 an expert): unsharded steps first (the final leaves kept in host
   memory), then the Trainer's sharded steps on 26a's (1, 1) mesh: every
   metric after each step and every final leaf within 1e-6 of its max
   (bitwise equality printed), as 26a, every routing equal; the router,
   attention projections and unembed through the GEMM kernel, counted;
   26e. the same model on two processes of the one card (gloo), mesh (1, 2):
   each process holds 64 of the 128 experts (the expert-parallel dispatch:
   routes on its tokens, slots over the global order, the experts' partial
   outputs summed over ``model``): the losses and every leaf within 1e-5 of
   26d's unsharded steps, each process comparing its own shards; the
   (token, slot) assignments that route otherwise than in the unsharded
   steps are counted and printed;
   26d and 26e print their step seconds, peak memory and the last step's
   collectives (count and bytes, each process's);
27. no Python collection ran during any CUDA graph capture (one there could
   free a dead engine's graphs and invalidate the capture); the ``kernels``
   JSON line, then the card line, then the result line.

``python3 chip_smoke.py --only-training`` runs phases 1, 2 and 25 alone (25g
needs ``build/deploy_h100.json`` from a tune); ``--only-distribution`` runs
phases 1, 2 and 26 alone (26c needs it too); ``--only-wkv-backward`` runs
phases 1, 2 and 25f-i alone, ``--only-scan-backward`` phases 1, 2 and
25f-ii, and ``--only-gemm`` phases 1, 2, 3, 7's tall GEMM and 25a (each with
``build/parent``, its turns too; results in ``build/chip_smoke_gemm.json``).

Each phase's header shows the seconds since the start.

Everything measured also goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
TOL = {("bf16", "bf16"): 1e-2, ("bf16", "f32"): 1e-3, ("f32", "f32"): 1e-5}
GEMM_PAIRS = [f"{src}->{dst}" for src, dst in TOL]
WKV_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's tolerance
WKV_LONG = 2048  # a long prompt: 128 chunks of 16 through the state pass, a 268 MB workspace at chunk 8
GRANITE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 49152)]
RWKV_KN = [(4096, 4096), (4096, 64), (64, 4096), (4096, 14336), (14336, 4096), (4096, 65536)]
HYMBA_KN = [(1600, 1600), (1600, 320), (1600, 3200), (1600, 48), (48, 1600), (1600, 16), (1600, 5504),
            (5504, 1600), (1600, 32128)]
VOCAB_KN = {(4096, 49152), (4096, 65536), (1600, 32128), (1024, 256256)}
# Every (k, n) that phase 24's five models give the GEMM: Q, K/V, O, FFN or router, and the vocab
# head (qwen3-moe, dbrx, qwen2.5-32b, glm4-9b, llama-3.2-vision-90b), and the VLM's cross K / V over
# its 1024 image tokens, once a request.
ARCH_KN = [(4096, 8192), (4096, 512), (8192, 4096), (4096, 128), (4096, 151936),
           (6144, 6144), (6144, 1024), (6144, 16), (6144, 100352),
           (5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120), (5120, 152064),
           (4096, 4096), (4096, 256), (4096, 13696), (13696, 4096), (4096, 151552),
           (8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192), (8192, 128256)]
IMAGE_ROWS_MKN = (1024, 8192, 1024)
SSM_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's rtol
SSM_LONG = 2048  # a long prompt: the harvest's shortest long length, cut into segments across CTAs
PROMPT_LENGTHS = (8, 37, 64, 100)
# What a wrapper's launch counter counts on the served paths: the engine captures each
# program as a CUDA graph, so a wrapper call launches onto the card at the program's one
# eager warm-up and into the graph at its capture. A replay launches the captured kernels
# without a wrapper call: the profiler counts them in the profiled replays
# (kernels_in_profiled_replays), and the engine counts its replays (program_replays).
LAUNCHES_COUNTED_AS = ("wrapper calls: per program built, one at its warm-up (run on the card) and one at its "
                       "capture (recorded into the graph); replays make none (see kernels_in_profiled_replays "
                       "and program_replays)")
# Attention against plain, relative to max |plain|: a bf16 output is one rounding (2^-8) from
# the f32 answer on each side; f32 sums in another order.
ATTN_TOL = {"bf16": 1e-2, "f32": 1e-4}
TUNED_ARCHS = ("granite-8b", "rwkv6-7b", "hymba-1.5b")
DEPLOY_PATH = ROOT / "build" / "deploy_h100.json"
STAGED_PATH = ROOT / "build" / "deploy_h100_staged.json"
BUNDLE_PATH = ROOT / "build" / "bundle_h100.json"
TPU_FIXTURE = ROOT / "tests" / "data" / "bundle_v5.json"
SERVED_ARCHS = ("rwkv6-7b", "hymba-1.5b")  # phase 17c serves them from the bundle
LOGIT_DEPTH = 8  # 17c: layers over which bundle and FixedPolicy() logits must agree within LOGIT_TOL
# 17c's limits on max|bundle - FixedPolicy()| / max|FixedPolicy()| of those logits, per model, each
# between the readings of scripts/logit_gate_draws.py over 8 draws of weights (NVIDIA H100 80GB HBM3,
# 700.00 W): every compiled config against the default read at most 8.51e-4 (rwkv6-7b) and 6.43e-6
# (hymba-1.5b); the default kernel fed TF32-rounded f32 inputs read at least 4.25e-3 and 4.01e-4.
LOGIT_TOL = {"rwkv6-7b": 2e-3, "hymba-1.5b": 1e-4}
TALL = (16384, 4096, 14336)  # the harvest's tallest single GEMM (core/gpubench.FOLD_ROWS rows)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Split-k boundaries: k < block_k, k not a multiple of block_k x splits, m = 1, n = 16 (< block_n).
# An odd n (4, 4100, 97) takes the cp.async path, splits k and stores element by element.
SPLIT_SHAPES = [(1, 48, 1600), (4, 1000, 16), (3, 4100, 96), (1, 64, 4096), (4, 1600, 48), (4, 4104, 1024),
                (4, 4100, 97)]


def _misaligned(torch, x):
    """A contiguous copy of ``x`` whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = flat[1 : 1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


# Phase 3's f32-only shapes, which the f32 kernel splits along k under its wide tiles
# (matmul.split_k_f32): granite-8b's K/V projection and seamless's head gradient at 1024 rows.
F32_SPLIT_SHAPES = [(1024, 4096, 1024), (1024, 256256, 1024)]

# Extra passes of phase 3 over the bf16 pairs, with fresh inputs: a race between the TMA
# ring's stages once showed in only one of several such passes before it was fixed.
RACE_PASSES = 8
# Phase 3's compute-bound shapes, which the persistent kernel runs under its tiles
# (matmul.uses_persistent): tile rows even and odd (a cluster whose second CTA falls off
# m: 3 and 5 rows of 128), n off the tile edge, and a granite-8b layer GEMM at 1024 rows.
PERSISTENT_SHAPES = [(384, 1024, 1032), (640, 512, 2048), (1024, 4096, 4096), (256, 2048, 8192)]


def phase_kernel_vs_plain(torch, mm) -> dict:
    """Every compiled config against the plain version, all three type pairs,
    each config twice in a row on the same inputs; then RACE_PASSES more
    passes over the bf16 pairs; then the transposed operands (the backward's)
    at every bf16 config (:func:`_transposed_vs_plain`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    shapes = [(m, k, n) for m in (1, 4, 37, 128) for k in (100, 4100) for n in (96, 1024)]
    shapes += SPLIT_SHAPES + PERSISTENT_SHAPES
    shapes += [(m, k, n) for m in (1, 4, 32, 64, 128)
               for k, n in dict.fromkeys(GRANITE_KN + RWKV_KN + HYMBA_KN + ARCH_KN)]
    shapes.append(IMAGE_ROWS_MKN)
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {pair: {"rel": 0.0, "abs": 0.0} for pair in TOL}
    split_worst = {}
    checks = 0
    mm.reset_launches()
    cases = [(*shape, False) for shape in shapes] + [(4, 4096, 1024, True)]
    f32_split = [(m, k, n, False, {("f32", "f32"): mm.f32_limit(k)}) for m, k, n in F32_SPLIT_SHAPES]
    for m, k, n, misaligned, pairs in [(*c, TOL) for c in cases] + f32_split + [
            (*c, {p: t for p, t in TOL.items() if p[0] == "bf16"}) for _ in range(RACE_PASSES) for c in cases]:
        a32 = torch.randn(m, k, device="cuda", generator=g)
        b32 = torch.randn(k, n, device="cuda", generator=g)
        for (src, dst), tol in pairs.items():
            a, b = a32.to(dt[src]), b32.to(dt[src])
            if misaligned:
                a = _misaligned(torch, a)
            want = mm.matmul_plain(a, b, dt[dst]).float()
            scale = want.abs().max().item()
            for cfg in mm.config_space():
                first = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst])
                second = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst])
                where = f"{cfg.name()} {src}->{dst} at {(m, k, n)}{' (misaligned base)' if misaligned else ''}"
                for got in (first.float(), second.float()):
                    err = (got - want).abs().max().item()
                    require(err / scale <= tol, f"{where}: rel err {err / scale:.3g} > {tol:.3g}")
                    if (m, k, n) in F32_SPLIT_SHAPES:  # held to their own limit, reported apart
                        split_worst[(m, k, n)] = max(split_worst.get((m, k, n), 0.0), err / scale)
                    else:
                        w = worst[(src, dst)]
                        w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                    checks += 1
                require(torch.equal(first, second), f"{where}: two calls in a row differ")
    torch.cuda.synchronize()
    paths, splits = dict(mm.PATH_LAUNCHES), dict(mm.SPLIT_LAUNCHES)
    kernels = dict(mm.TMA_KERNEL_LAUNCHES)
    require(all(paths.values()), f"a kernel path was never launched: {paths}")
    require(splits["simt_f32"] > 0, f"no f32 launch split k: {splits}")
    require(all(kernels.values()), f"a TMA kernel was never launched: {kernels}")
    for (src, dst), w in worst.items():
        print(f"  {src}->{dst}: worst rel err {w['rel']:.3g} (limit {TOL[(src, dst)]}), "
              f"worst abs err {w['abs']:.3g}")
    print("  f32 alone: " + "; ".join(
        f"{shape} worst rel err {e:.3g} (limit {mm.f32_limit(shape[1]):.3g}), splits by config "
        f"{sorted({mm.split_k_f32(shape[0], shape[2], shape[1], c) for c in mm.config_space()})}"
        for shape, e in split_worst.items()))
    print(f"  {checks} checks over {len(cases)} shapes x {len(mm.config_space())} configs x 2 calls (3 type pairs, then "
          f"{RACE_PASSES} passes of the 2 bf16 pairs) and {len(F32_SPLIT_SHAPES)} f32 shapes: all within tolerance, "
          f"both calls bitwise equal; launches by path {paths}, of them split along k {splits}; TMA launches by "
          f"kernel {kernels}")
    transposed = _transposed_vs_plain(torch, mm, shapes[:16] + SPLIT_SHAPES + PERSISTENT_SHAPES + [
        (m, k, n) for m in (4, 128) for k, n in GRANITE_KN])
    return {f"{s}->{d}": w for (s, d), w in worst.items()} | {
        "checks": checks, "paths": paths, "split_launches": splits, "tma_kernels": kernels,
        "f32_split_shapes": {"x".join(map(str, shape)): e for shape, e in split_worst.items()},
        "transposed": transposed}


def _transposed_vs_plain(torch, mm, shapes) -> dict:
    """Phase 3's transposed operands: at every bf16 config and both bf16 type pairs, lhs
    passed as ``lhs.t()`` of its row-major transpose (the backward's grad_rhs) and rhs
    as ``rhs.t()`` (grad_lhs), each call twice, against the plain version at phase 3's
    limits and bitwise equal twice; where a tensor map takes the view (matmul.tma_aligned)
    the TMA kernels read it in place, else the wrapper copies it (TRANSPOSE_COPIES), and
    exactly there. How often the result is bitwise the row-major call's is counted."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device="cuda").manual_seed(31)
    worst = {pair: 0.0 for pair in TOL if pair[0] == "bf16"}
    checks = same_bits = calls = want_copies = 0
    mm.reset_launches()
    for m, k, n in shapes:
        a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        b = torch.randn(k, n, device="cuda", generator=g).bfloat16()
        views = {"lhs": (a.t().contiguous().t(), b), "rhs": (a, b.t().contiguous().t())}
        for (_, dst), tol in ((p, t) for p, t in TOL.items() if p[0] == "bf16"):
            want = mm.matmul_plain(a, b, dt[dst]).float()
            scale = want.abs().max().item()
            for cfg in mm.config_space():
                direct = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst])
                for side, (lhs, rhs) in views.items():
                    first = mm.matmul_cuda(lhs, rhs, cfg, out_dtype=dt[dst])
                    second = mm.matmul_cuda(lhs, rhs, cfg, out_dtype=dt[dst])
                    calls += 2
                    ta, tb = mm.transposed(lhs), mm.transposed(rhs)  # a vector's view is row-major too
                    want_copies += 2 * ((ta or tb) and not mm.tma_aligned(m, n, k, ta, tb, lhs.data_ptr(),
                                                                          rhs.data_ptr()))
                    where = f"{cfg.name()} bf16->{dst} at {(m, k, n)}, {side} transposed"
                    err = (first.float() - want).abs().max().item() / scale
                    require(err <= tol, f"{where}: rel err {err:.3g} > {tol:.3g}")
                    require(torch.equal(first, second), f"{where}: two calls in a row differ")
                    worst[("bf16", dst)] = max(worst[("bf16", dst)], err)
                    same_bits += bool(torch.equal(first, direct))
                    checks += 1
    torch.cuda.synchronize()
    reads, copies, kernels = dict(mm.TRANSPOSED_READS), dict(mm.TRANSPOSE_COPIES), dict(mm.TMA_KERNEL_LAUNCHES)
    require(all(reads.values()) and kernels["persistent"] > 0, f"no transposed read in place: {reads} {kernels}")
    require(sum(copies.values()) == want_copies,
            f"transposed operands copied {copies}, want {want_copies}: one for each view a tensor map cannot take")
    print(f"  transposed operands: {checks} checks ({len(shapes)} shapes x 2 bf16 pairs x {len(mm.config_space())} "
          f"configs x lhs / rhs, each called twice): worst rel err " + ", ".join(
              f"bf16->{d} {e:.3g} (limit {TOL[('bf16', d)]})" for (_, d), e in worst.items())
          + f"; both calls bitwise equal; {same_bits} of {checks} bitwise the row-major call's; read in place "
          f"{reads} (TMA launches by kernel {kernels}), copied {copies} of {calls} calls")
    return {"checks": checks, "worst": {f"bf16->{d}": e for (_, d), e in worst.items()}, "same_bits": same_bits,
            "reads_in_place": reads, "copies": copies, "tma_kernels": kernels}


def _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state):
    """r/k/v/u in ``dtype``, logw and the state in f32, drawn as the reference's
    kernel test draws them; ``decay`` picks logw: 'dist', 'clamp' or 'mix'."""
    shape = (b, s, h, hd)
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    r, k, v = randn(*shape) * 0.5, randn(*shape) * 0.5, randn(*shape)
    logw = -torch.exp(randn(*shape) * 0.5).clamp(1e-3, 5.0)
    if decay == "clamp":
        logw = torch.full(shape, -5.0, device="cuda")
    elif decay == "mix":
        logw = torch.where(torch.rand(shape, device="cuda", generator=g) < 0.5, -5.0, -1e-3)
    u = randn(h, hd) * 0.3
    state = randn(b, h, hd, hd) * 0.1 if with_state else None
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u.to(dtype), state


def phase_wkv_vs_plain(torch, wk) -> dict:
    """Every compiled chunk config against the plain version, each config
    called twice on the same inputs (both calls bitwise equal), and one long
    case at (1, 2048, 64, 64) in bf16 with a state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = [(2, s, 3, hd) for hd in (16, 64) for s in (1, 7, 16, 50, 128, 300)]
    shapes += [(1, s, 64, 64) for s in (32, 64, 128)]  # what rwkv6-7b prefill gives the kernel
    cases = [(shape, dtype, decay, with_state) for shape in shapes for dtype in (torch.bfloat16, torch.float32)
             for decay in ("dist", "clamp", "mix") for with_state in (True, False)]
    cases.append(((1, WKV_LONG, 64, 64), torch.bfloat16, "dist", True))
    worst = {"rel": 0.0, "abs": 0.0}
    clamp_finite = {c.name(): True for c in wk.config_space()}
    checks = 0
    for (b, s, h, hd), dtype, decay, with_state in cases:
        args = _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state)
        want = wk.wkv_plain(*args)
        scales = [w.abs().max().item() for w in want]
        for cfg in wk.config_space():
            first = wk.wkv_cuda(*args, config=cfg)
            second = wk.wkv_cuda(*args, config=cfg)
            where = f"{cfg.name()} at {(b, s, h, hd)} {dtype} {decay} state={with_state}"
            require(all(torch.equal(x, y) for x, y in zip(first, second)), f"{where}: two calls differ")
            for name, x, w, scale in zip(("o", "state"), first, want, scales):
                finite = bool(torch.isfinite(x).all())
                require(finite, f"{where}: {name} not finite")
                err = (x - w).abs().max().item()
                require(err <= WKV_TOL * scale, f"{where}: {name} rel err {err / scale:.3g} > {WKV_TOL}")
                worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
                if decay != "dist":
                    clamp_finite[cfg.name()] &= finite
            checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 dtypes x 3 decays x 2 states, and (1, {WKV_LONG}, 64, 64) "
          f"bf16 with a state, x {len(wk.config_space())} configs, each called twice): worst rel err "
          f"{worst['rel']:.3g} (limit {WKV_TOL}), worst abs err {worst['abs']:.3g}; both calls bitwise equal; "
          f"finite at logw = -5 and the -5 / -1e-3 mix: {clamp_finite}")
    return worst | {"checks": checks, "clamp_finite": clamp_finite}


def _ssm_inputs(torch, g, b, s, d, n, with_state):
    """dtx, dta, b, c (and the state) in f32, drawn as the reference's kernel
    test draws them (tests/test_ssm_kernel.py:_inputs)."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    dtx, dta = randn(b, s, d) * 0.5, -torch.exp(randn(b, s, d, n) * 0.3)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    return dtx, dta, bv, cv, (randn(b, d, n) * 0.1 if with_state else None)


def _ssm_fused_inputs(torch, g, b, s, d, n, with_state):
    """x, dt (softplus of a normal, as models/mamba.py makes it), a (-exp of 0.3 normal:
    dt * a lies where the reference test's dta does), b, c (and the state), all f32."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    x, dt = randn(b, s, d) * 0.5, torch.nn.functional.softplus(randn(b, s, d))
    a = -torch.exp(randn(d, n) * 0.3)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    return x, dt, a, bv, cv, (randn(b, d, n) * 0.1 if with_state else None)


# Segment counts forced at the cut cases of phase 3c besides the rule's own (2, 3, 5 and a
# count whose segments are uneven), so every fold length runs whatever the rule picks.
SSM_FORCED_SEGMENTS = (1, 2, 3, 5, 7)


def phase_ssm_vs_plain(torch, ss) -> dict:
    """Both entries (dta and fused) at every compiled (block_d, chunk) config against
    the plain version, each called twice (bitwise equal), each call launching the
    segments ``ssm.launch_segments`` names; the long case also under forced segment
    counts."""
    g = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(2, s, d, n) for d in (100, 50) for n in (8, 16) for s in (1, 7, 50, 128, 300)]
    shapes += [(1, s, 1600, 16) for s in (32, 64, 128)]  # what hymba-1.5b prefill gives the kernel
    cases = [(shape, with_state) for shape in shapes for with_state in (True, False)]
    cases.append(((1, SSM_LONG, 1600, 16), True))
    entries = {"dta": (_ssm_inputs, ss.ssm_cuda, ss.ssm_plain),
               "fused": (_ssm_fused_inputs, ss.ssm_cuda_fused, ss.ssm_fused_plain)}
    worst = {e: {"rel": 0.0, "abs": 0.0} for e in entries}
    checks, cut = 0, 0
    rule = ss.ssm_segments
    for (b, s, d, n), with_state in cases:
        for entry, (draw, kernel, plain) in entries.items():
            args = draw(torch, g, b, s, d, n, with_state)
            want = plain(*args)
            scales = [w.abs().max().item() for w in want]
            for cfg in ss.config_space():
                segs = ss.launch_segments(b, s, d, n, cfg, entry == "fused", 0)
                forced = SSM_FORCED_SEGMENTS if s in (300, SSM_LONG) else ()
                # The rule's count (unforced), then each forced count the chunks reach.
                counts = [None] + sorted({ss.reachable_segments(s, cfg, f) for f in forced} - {segs})
                for count in counts:
                    where = f"{cfg.name()} {entry} at {(b, s, d, n)} state={with_state} segments={count or segs}"
                    before = ss.SEGMENTS_LAUNCHED[cfg.name()]
                    try:
                        if count is not None:
                            ss.ssm_segments = lambda *_, c=count: c
                        first = kernel(*args, config=cfg)
                        second = kernel(*args, config=cfg)
                    finally:
                        ss.ssm_segments = rule
                    ran = ss.SEGMENTS_LAUNCHED[cfg.name()] - before
                    require(ran == 2 * (count or segs), f"{where}: launched {ran / 2} segments a call")
                    require(all(torch.equal(x, y) for x, y in zip(first, second)), f"{where}: two calls differ")
                    for name, x, w, scale in zip(("y", "state"), first, want, scales):
                        require(bool(torch.isfinite(x).all()), f"{where}: {name} not finite")
                        err = (x - w).abs().max().item()
                        require(err <= SSM_TOL * scale, f"{where}: {name} rel err {err / scale:.3g} > {SSM_TOL}")
                        w_ = worst[entry]
                        w_["rel"], w_["abs"] = max(w_["rel"], err / scale), max(w_["abs"], err)
                    checks += 1
                    cut += (count or segs) > 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 states and (1, {SSM_LONG}, 1600, 16) with a state, x 2 "
          f"entries x {len(ss.config_space())} configs, the 300- and {SSM_LONG}-step cases also at segments "
          f"{SSM_FORCED_SEGMENTS}; {cut} of them cut into segments), each called twice: worst rel err "
          + ", ".join(f"{e} {w['rel']:.3g} (abs {w['abs']:.3g})" for e, w in worst.items())
          + f" (limit {SSM_TOL}); every output finite; both calls bitwise equal; segments as launch_segments says")
    return {"rel": max(w["rel"] for w in worst.values()), "abs": max(w["abs"] for w in worst.values()),
            "by_entry": worst, "checks": checks, "cut": cut}


# Per arch: GEMM launches per forward, and launches per prefill of each
# sequence kernel (every decode step launches none of them).
# Models whose layer loop runs through ops.scan_layers, as the reference scans its layers:
# a program build selects layer 0's kernels once and every later layer reuses them.
SCANNED = ("granite-8b", "rwkv6-7b")


def _expected(cfg) -> tuple[int, dict[str, int]]:
    n = cfg.n_layers
    if cfg.name == "granite-8b":
        require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (4096, 32, 8, 14336, 49152),
                f"unexpected granite-8b config {cfg}")
        return 7 * n + 1, {"wkv": 0, "ssm": 0}
    if cfg.name == "rwkv6-7b":
        require((n, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab)
                == (32, 4096, 64, 64, 14336, 65536), f"unexpected rwkv6-7b config {cfg}")
        return 10 * n + 1, {"wkv": n, "ssm": 0}
    require((n, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.ssm_state,
             cfg.window) == (32, 1600, 25, 5, 64, 5504, 32001, 16, 2048), f"unexpected hymba-1.5b config {cfg}")
    return 13 * n + 1, {"wkv": 0, "ssm": n}


def _selections_per_build(cfg, launches: int) -> int:
    """Selections one program build makes for ``launches`` kernel calls per forward:
    one per call, or, in a scanned model, layer 0's and the head's."""
    if cfg.name not in SCANNED:
        return launches
    body, head = divmod(launches, cfg.n_layers)
    return body + head


_FAMILY = {"wkv": "wkv", "ssm": "ssm_scan"}  # launch counter -> selection family


def _drain(torch, engine, prompts, mm, seq: dict) -> dict:
    """Serve ``prompts`` x 16 tokens through ``engine`` (submit, drain), timing every
    forward on the host clock after a synchronize. Per forward: (kind, size, GEMM
    launches counted, {sequence kernel: launches counted}, programs built, seconds)."""
    events: list[tuple[str, int, int, dict, int, float]] = []
    mark = {"gemm": mm.total_launches(), "built": len(engine.program_log)} | {
        name: mod.total_launches() for name, mod in seq.items()}

    def record(kind):
        def hook(size):
            torch.cuda.synchronize()
            now, gemm, built = time.perf_counter(), mm.total_launches(), len(engine.program_log)
            counts = {name: mod.total_launches() for name, mod in seq.items()}
            events.append((kind, size, gemm - mark["gemm"], {k: v - mark[k] for k, v in counts.items()},
                           built - mark["built"], now - mark["t"]))
            mark.update(counts, gemm=gemm, built=built, t=now)
        return hook

    engine.on_prefill, engine.on_decode = record("prefill"), record("decode")
    torch.cuda.synchronize()
    mark["t"] = t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.on_prefill = engine.on_decode = None
    require(status.completed == len(prompts) and not status.exhausted, f"not every request completed: {status}")
    require(all(len(t.request.output) == 16 for t in tickets), "a request got fewer than 16 tokens")
    toks = sum(len(t.request.output) for t in tickets)
    decode_ms = [sec * 1e3 for kind, *_, sec in events if kind == "decode"]
    return {"events": events, "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
            "prefill_ms": [round(sec * 1e3, 3) for kind, *_, sec in events if kind == "prefill"],
            "prefill_buckets": [size for kind, size, *_ in events if kind == "prefill"],
            "decode_ms": decode_ms, "decode_median_ms": statistics.median(decode_ms),
            "decode_min_ms": min(decode_ms), "decode_max_ms": max(decode_ms),
            "outputs": [list(t.request.output) for t in tickets]}


def _print_drain(name: str, d: dict) -> None:
    print(f"  {name}: {d['tokens']} tokens in {d['wall_s']:.3f}s ({d['tok_per_s']:.1f} tok/s); prefill ms "
          f"{d['prefill_ms']} (buckets {d['prefill_buckets']}); decode step ms median {d['decode_median_ms']:.3f} "
          f"(min {d['decode_min_ms']:.3f}, max {d['decode_max_ms']:.3f}) over {len(d['decode_ms'])} steps")


def phase_serve(torch, mm, seq: dict, arch: str, policy=None) -> dict:
    """Serve 4 requests x 16 tokens at full width through the engine's CUDA graphs,
    twice on one engine: a cold drain (every program warmed up and captured) and a
    warm drain (replays only). ``policy`` (default ``FixedPolicy()``) is installed in
    the engine's runtime.

    The kernels' launch counters count in Python, so they count a program's warm-up
    and its capture (each one forward), never a replay: every program built adds
    2 x per_forward GEMM launches (a prefill program also 2 x n_layers WKV / SSM
    launches), and the warm drain adds none. The engine counts its replays."""
    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = registry.get(arch)
    per_forward, per_prefill = _expected(cfg)
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {arch} full width: {cfg.n_layers} layers (no depth cut), d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16; weights {weight_bytes / 1e9:.2f} GB, "
          f"init {init_s:.1f}s")

    # A direct prefill: finite f32 logits over the padded vocab (also warms up).
    tokens = torch.randint(0, cfg.vocab, (1, 32), device="cuda")
    logits, _ = model.prefill(params, {"tokens": tokens}, 256)
    require(tuple(logits.shape) == (1, 1, cfg.padded_vocab()) and logits.dtype == torch.float32,
            f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    rt = KernelRuntime(name=f"chip_smoke[{arch}]")
    rt.install(FixedPolicy() if policy is None else policy)
    rt.set_selection_logging(True, cap=1 << 16)
    engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt)
    require(engine.cuda_graphs, "the engine does not take CUDA graphs on a CUDA model")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]

    # The main path, both drains: counts to 0 just before, read just after.
    torch.cuda.synchronize()
    mm.reset_launches()
    for mod in seq.values():
        mod.reset_launches()
    encodes = mm.map_encodes()
    cold = _drain(torch, engine, prompts, mm, seq)
    launches_cold = mm.total_launches()
    warm = _drain(torch, engine, prompts, mm, seq)
    launches = dict(mm.LAUNCHES)
    paths = dict(mm.PATH_LAUNCHES)
    encodes = mm.map_encodes() - encodes
    seq_launches = {name: dict(mod.LAUNCHES) for name, mod in seq.items()}
    seq_entries = {name: dict(mod.ENTRY_LAUNCHES) for name, mod in seq.items() if hasattr(mod, "ENTRY_LAUNCHES")}

    built = engine.program_log
    programs = engine.programs()
    require(all(r.captured for r in built) and all(
        isinstance(p.graph, torch.cuda.CUDAGraph) for c in (engine._prefill_cache, engine._decode_cache)
        for p in c.values()), f"a program was not captured: {built}")
    require(len(built) == len(programs), f"programs built {built} but live {sorted(programs)}")
    n_prefill_progs = sum(r.kind == "prefill" for r in built)
    forwards = len(cold["events"]) + len(warm["events"])
    replays = sum(v["runs"] for v in programs.values())
    require(replays == forwards, f"{replays} replays for {forwards} forwards")
    replays_by_program = {f"{kind} {size}": v["runs"] for (kind, size), v in programs.items()}
    require(warm["outputs"] == cold["outputs"], "the warm drain's streams differ from the cold drain's")
    total = sum(launches.values())
    require(total == launches_cold == 2 * per_forward * len(built),
            f"GEMM launches {launches_cold} (cold) / {total} (both drains): want 2 x {per_forward} x "
            f"{len(built)} programs (a warm-up and a capture each), none in the warm drain")
    bad = [(kind, size, n, b) for kind, size, n, _, b, _ in cold["events"] + warm["events"] if n != 2 * per_forward * b]
    require(not bad, f"forwards whose GEMM launches are not 2 x {per_forward} x programs built: {bad}")
    require(paths["tma"] == total, f"served bf16 GEMMs off the TMA path: {paths}")
    stats = rt.shape_cache_stats()
    fam = stats["per_family"]
    for name in seq:
        want = 2 * per_prefill[name] * n_prefill_progs
        got = sum(seq_launches[name].values())
        require(got == want, f"{name} launches {got}: want 2 x {per_prefill[name]} x {n_prefill_progs} prefill programs")
    # One consultation per program build: its warm-up selects (once per call, or once per
    # scanned layer body) and pins the configs, and the capture launches them again.
    pins = {}
    for cache in (engine._prefill_cache, engine._decode_cache):
        for prog in cache.values():
            for op, _problem, _cfg in prog.pins.entries:
                pins[op] = pins.get(op, 0) + 1
    per_build = {"matmul": _selections_per_build(cfg, per_forward)} | {
        _FAMILY[k]: _selections_per_build(cfg, v) for k, v in per_prefill.items() if v}
    for op, n in [("matmul", total)] + [(_FAMILY[k], sum(v.values())) for k, v in seq_launches.items()]:
        got = fam.get(op, {"hits": 0, "misses": 0})
        builds = len(built) if op == "matmul" else n_prefill_progs
        want = per_build.get(op, 0) * builds
        require(got["hits"] + got["misses"] == pins.get(op, 0) == want,
                f"{op}: {got} selections, {pins.get(op, 0)} pinned, want one per call of each build's "
                f"warm-up ({per_build.get(op, 0)} x {builds} builds) for {n} launches")
    require(fam["matmul"]["hits"] > 0, f"matmul shape cache never hit: {fam}")
    # GEMM launches per width-4 decode forward, per (k, n), from the selection log: one entry
    # per call of each width-4 decode build (each layer body's once in a scanned model).
    decode4 = sum(1 for r in built if r.kind == "decode" and r.size == 4)
    counts: dict[str, int] = {}
    for op, problem, _cfg in rt.selection_log():
        # Decode GEMMs have 4 rows: a (4, 1, D) activation is (m, batch) = (1, 4), and Mamba's
        # output projection of a (4, D) one is (4, 1). Prefill GEMMs have >= 32 rows.
        if op == "matmul" and problem[0] * problem[3] == 4:
            kn = f"{problem[1]}x{problem[2]}"
            layers = cfg.n_layers if arch in SCANNED and (problem[1], problem[2]) not in VOCAB_KN else 1
            counts[kn] = counts.get(kn, 0) + layers
    per_step = {kn: c / decode4 for kn, c in counts.items()}
    decode_configs = sorted({(f"{p[1]}x{p[2]}", c.name()) for op, p, c in rt.selection_log()
                             if op == "matmul" and p[0] * p[3] == 4})
    require(sum(per_step.values()) == per_forward, f"decode-step GEMMs by shape {per_step} do not sum to {per_forward}")
    capture_s = sum(r.seconds for r in built)
    _print_drain("cold drain (captures included)", cold)
    _print_drain("warm drain (replays only)", warm)
    print(f"  programs: {len(built)} captured ({', '.join(f'{r.kind} {r.size}' for r in built)}) in "
          f"{capture_s:.3f}s (warm-up and capture), {replays} replays over both drains {replays_by_program}; "
          f"warm / cold streams equal")
    seq_text = "; ".join(f"{name.upper()} launches: {sum(seq_launches[name].values())} = 2 x {per_prefill[name]} x "
                         f"{n_prefill_progs} prefill programs" for name in seq)
    print(f"  GEMM launches (counted in Python: warm-ups and captures): {total} = 2 x {per_forward} per forward x "
          f"{len(built)} programs, 0 in the warm drain, all on the TMA path ({paths}), {encodes} tensor maps "
          f"encoded; {seq_text}; selection consulted once per call of each build's warm-up, pinned for its "
          f"capture ({per_build} a build; shape cache {stats['hits']} hits / {stats['misses']} misses)")
    print(f"  width-4 decode-step GEMM launches per (k x n): {per_step}")
    return {
        "arch": arch, "n_layers": cfg.n_layers, "weight_bytes": weight_bytes, "cold": cold, "warm": warm,
        "tokens": cold["tokens"], "wall_s": cold["wall_s"], "tok_per_s": cold["tok_per_s"],
        "prefill_ms": cold["prefill_ms"], "prefill_buckets": cold["prefill_buckets"], "decode_ms": cold["decode_ms"],
        "programs": [dataclasses.asdict(r) for r in built], "capture_s": capture_s, "replays": replays,
        "program_replays": replays_by_program,
        "launches": launches, "path_launches": paths, "map_encodes": encodes, "per_forward": per_forward,
        "forwards": forwards, "per_decode_step": per_step,
        "shape_cache": {k: stats[k] for k in ("hits", "misses")}, "per_family": fam,
        "decode_configs": decode_configs, "outputs": cold["outputs"],
        "engine": engine, "model": model, "params": params, "prompts": prompts, "policy": policy,
    } | {f"{name}_launches": seq_launches[name] for name in seq} | {
        f"{name}_entry_launches": launches for name, launches in seq_entries.items()} | {
        f"{name}_per_prefill": per_prefill[name] for name in seq}


def _programs_built(engine, kind: str | None = None) -> int:
    return sum(1 for r in engine.program_log if kind is None or r.kind == kind)


def phase_policy(mm, serve: dict) -> dict:
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    other = mm.MatmulConfig(16, 128, 64, "nmk")
    require(other in mm.config_space() and other != mm.DEFAULT_CONFIG, "bad choice of config")
    rt = KernelRuntime(name="chip_smoke-fixed")
    rt.install(FixedPolicy(matmul_config=other))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mm.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, default = mm.LAUNCHES[other.name()], mm.LAUNCHES[mm.DEFAULT_CONFIG.name()]
    want = 2 * serve["per_forward"] * _programs_built(engine)
    require(got == want and default == 0,
            f"FixedPolicy({other.name()}) launched it {got} times (want {want}), the default {default} times")
    print(f"  FixedPolicy({other.name()}): {got} launches of it at its {_programs_built(engine)} programs' warm-ups and "
          f"captures, {default} of the default")
    return {"config": other.name(), "launches": got, "default_launches": default}


def phase_seq_policy(mod, name: str, other, serve: dict) -> dict:
    """One request under ``FixedPolicy(<name>_config=other)`` launches the
    sequence kernel's config ``other`` n_layers times at its prefill program's
    warm-up and again at its capture, and the default config not at all."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    default = getattr(mod, f"DEFAULT_{name.upper()}_CONFIG")
    require(other in mod.config_space() and other != default, f"bad choice of {name} config")
    rt = KernelRuntime(name=f"chip_smoke-{other.name()}")
    rt.install(FixedPolicy(**{f"{name}_config": other}))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mod.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, n_default = mod.LAUNCHES[other.name()], mod.LAUNCHES[default.name()]
    want = 2 * serve[f"{name}_per_prefill"] * _programs_built(engine, "prefill")
    require(got == want and n_default == 0 and mod.total_launches() == got,
            f"FixedPolicy({name}_config={other.name()}) launched it {got} times (want {want}), the default "
            f"{n_default} times")
    print(f"  FixedPolicy({name}_config={other.name()}): {got} launches of it (one prefill program: its warm-up and "
          f"capture), {n_default} of {default.name()}")
    return {"config": other.name(), "launches": got, "default_launches": n_default}


def phase_hymba_cpu_vs_card(torch) -> dict:
    """Reduced hymba-1.5b at 4 layers (its layer 1 slides a 32-token window),
    served in process on cuda and on cpu from the same weights."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(registry.get("hymba-1.5b").reduced(), n_layers=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (20, 45)]
    streams = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        require(model._layer_kinds() == ["global", "swa", "global", "global"], "no sliding-window layer")
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        rt = KernelRuntime(name=f"chip_smoke-hymba4[{dev}]")
        rt.install(FixedPolicy())
        engine = ServingEngine(model, params, max_batch=2, cache_len=128, runtime=rt)
        ring = engine.pool.specs["['layer1']['k']"]
        require(ring.kind == "lane", f"the 32-token ring should be a lane leaf, got {ring}")
        tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
        status = engine.drain()
        require(status.completed == 2, f"hymba4 on {dev}: {status}")
        streams[dev] = [list(t.request.output) for t in tickets]
    if streams["cuda"] != streams["cpu"]:
        print(f"  cuda {streams['cuda']}\n  cpu  {streams['cpu']}")
    require(streams["cuda"] == streams["cpu"], "hymba4: greedy token streams differ between cuda and cpu")
    n_tok = sum(map(len, streams["cpu"]))
    print(f"  reduced hymba-1.5b at 4 layers, f32, prompts of 20 and 45 tokens (buckets 32, 64; ring 32): "
          f"cuda and cpu token streams equal ({n_tok} tokens)")
    return {"equal": True, "tokens": n_tok}


def phase_cpu_vs_card(arch: str) -> dict:
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", arch, "--reduced", "--requests", "4", "--max-new-tokens", "8"]
    card = serve_cli.main(argv + ["--device", "cuda"])
    cpu = serve_cli.main(argv + ["--device", "cpu"])
    if card != cpu:
        _report_divergence(arch, card, cpu)
    require(card == cpu, f"{arch}: greedy token streams differ between cuda and cpu")
    print(f"  reduced {arch} f32: cuda and cpu token streams equal ({sum(map(len, cpu))} tokens)")
    return {"equal": True, "tokens": sum(map(len, cpu))}


def _report_divergence(arch, card, cpu) -> None:
    """Top-2 logit gap at the first token where the streams part."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    i = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(card[i], cpu[i])) if a != b)
    cfg = registry.get(arch).reduced()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(len(card), 8))[i]
    seq = torch.as_tensor(np.concatenate([prompt, cpu[i][:j]]))[None]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        logits, _ = model.prefill(params, {"tokens": seq.to(dev)}, 128)
        top = torch.topk(logits[0, -1].float().cpu(), 2)
        print(f"  divergence at request {i} token {j}: {dev} top-2 {top.indices.tolist()} "
              f"gap {(top.values[0] - top.values[1]).item():.3g}")


GEMM_KERNELS = "matmul (gemm_*_kernel)"


def _kernel_name(key: str) -> str:
    """The port's kernels by name (cuBLAS kernels, which the models' plain attention
    reaches through einsum, also hold "gemm_" in theirs)."""
    if any(f"gemm_{path}_kernel" in key for path in ("tma", "persistent", "bf16", "f32")):
        return GEMM_KERNELS
    for kernel in ("wkv_bwd_walk_kernel", "wkv_bwd_state_kernel", "ssm_bwd_kernel"):
        if kernel in key:
            return f"{kernel.split('_')[0].replace('ssm', 'ssm_scan')} backward ({kernel})"
    for kernel in ("wkv_state_kernel", "wkv_output_kernel", "ssm_state_kernel", "ssm_output_kernel"):
        if kernel in key:
            return f"{kernel.split('_')[0].replace('ssm', 'ssm_scan')} ({kernel})"
    return key[:60]


def _profile_window(torch, fn, runs: int) -> dict:
    """``fn()``, which runs ``runs`` programs in turn, under torch.profiler (device
    activity only): host wall ms (after a synchronize), device ms and kernel count by
    kernel, and from the device's timeline (host copies left out) the ms one program
    run spans on the device, the idle ms inside the runs (the gaps between a run's
    device operations) and between them (the ``runs`` - 1 widest gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = _kernel_name(evt.key)
        ms[name] = ms.get(name, 0.0) + us / 1e3
        count[name] = count.get(name, 0) + evt.count
    busy = sum(ms.values())
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "HtoD" not in e.name and "DtoH" not in e.name)
    timeline = {}
    if spans:
        gaps, end = [], spans[0][1]
        for start, stop in spans[1:]:
            if start > end:
                gaps.append(start - end)
            end = max(end, stop)
        between = sorted(gaps)[len(gaps) - runs + 1:]
        run_us = end - spans[0][0] - sum(between)
        inside = sum(gaps) - sum(between)
        timeline = {"run_ms": run_us / runs / 1e3, "idle_in_runs_ms": inside / 1e3,
                    "idle_share_in_runs": inside / run_us, "between_runs_ms": sum(between) / 1e3,
                    "outside_device_span_ms": wall_ms - (end - spans[0][0]) / 1e3}
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms if busy else None,
            "ms": ms, "count": count, "timeline": timeline}


PROFILE_ATTEMPTS = 3


def phase_profile(torch, serve: dict, engine=None) -> dict:
    """Two windows under torch.profiler on warm programs: two decode steps at width
    4, and one prefill replay at bucket 32 alone. The profiler sees the kernels
    inside a graph replay: every window's GEMM kernels must be per_forward a forward,
    its WKV / SSM kernels n_layers a prefill (0 a decode step). The profiler can
    drop a few device records (PERF.md section 7), so a window whose counts differ
    is measured again, up to PROFILE_ATTEMPTS windows, and the phase fails when
    none counts every kernel; a kernel the path does not launch misses from each.
    ``engine`` defaults to the served (graphed) one."""
    import numpy as np

    engine = engine or serve["engine"]
    prompts, per_forward = serve["prompts"], serve["per_forward"]
    kinds = "graphed" if engine.cuda_graphs else "eager"

    def decode_window():
        engine.drain()
        for p in prompts:
            engine.submit(p, max_new_tokens=4)
        engine.step()  # 4 prefills + a decode step, outside the window
        return _profile_window(torch, lambda: (engine.step(), engine.step()), 2)

    tokens = np.zeros((1, 32), dtype=np.int64)
    tokens[0, -len(prompts[0]):] = prompts[0]  # left-padded, as the engine stages it

    def prefill_window():
        engine.drain()
        prog = engine._prefill_fn(32)
        require(prog.runs > 0, "the bucket-32 prefill program was not warm")
        prog.stage(tokens=tokens)
        return _profile_window(torch, lambda: prog.run(engine.runtime), 1)

    per_prefill = {"wkv": serve.get("wkv_per_prefill", 0), "ssm": serve.get("ssm_per_prefill", 0)}
    windows = {}
    for what, measure, forwards, prefills in (("2 decode steps", decode_window, 2, 0),
                                              ("1 prefill", prefill_window, 1, 1)):
        want = {GEMM_KERNELS: per_forward * forwards}
        for kernel, fam in (("wkv_state_kernel", "wkv"), ("wkv_output_kernel", "wkv"), ("ssm_output_kernel", "ssm")):
            want[_kernel_name(kernel)] = per_prefill[fam] * prefills
        misses = []
        for _ in range(PROFILE_ATTEMPTS):
            window = measure()
            c = window["count"]
            seen = {name: c.get(name, 0) for name in want}
            if not c or seen == want:
                break
            misses.append(seen)
        else:
            require(False, f"{kinds} {what}: in each of {PROFILE_ATTEMPTS} windows the profiler saw other kernel "
                           f"counts than {want}: {misses}")
        window["recounted"] = misses
        windows[what] = window
        if not c:
            print(f"  {what}: the profiler recorded no device time: not measured")
            continue
        got = c[GEMM_KERNELS]
        if misses:
            print(f"  {kinds} {what}: the profiler dropped records in {len(misses)} window(s) ({misses}); measured "
                  f"again")
        top = sorted(window["ms"].items(), key=lambda kv: -kv[1])[:6]
        print(f"  {kinds} {what}: wall {window['wall_ms']:.2f} ms, device busy {window['busy_ms']:.2f} ms, idle share "
              f"{window['idle_share']:.3f}; kernels seen: {got} GEMM (= {per_forward} x {forwards})"
              + "".join(f", {c[_kernel_name(k)]} {k}" for k in ("wkv_state_kernel", "wkv_output_kernel",
                                                               "ssm_state_kernel", "ssm_output_kernel")
                        if c.get(_kernel_name(k))))
        t = window["timeline"]
        print(f"    device timeline: one {'replay' if engine.cuda_graphs else 'eager run'} spans {t['run_ms']:.3f} ms, "
              f"idle inside the runs {t['idle_in_runs_ms']:.3f} ms (share {t['idle_share_in_runs']:.3f}), between "
              f"them {t['between_runs_ms']:.3f} ms, outside the device's span {t['outside_device_span_ms']:.3f} ms")
        for name, ms in top:
            print(f"    {ms:9.3f} ms  {name}")
    decode, prefill = windows["2 decode steps"], windows["1 prefill"]
    d, pf = decode["ms"], prefill["ms"]
    return {"decode": decode, "prefill": prefill, "wall_ms": decode["wall_ms"], "busy_ms": decode["busy_ms"],
            "idle_share": decode["idle_share"], "busy_per_step_ms": decode["busy_ms"] / 2,
            "wkv_state_ms": pf.get("wkv (wkv_state_kernel)", 0.0), "wkv_output_ms": pf.get("wkv (wkv_output_kernel)", 0.0),
            "ssm_state_ms": pf.get("ssm_scan (ssm_state_kernel)", 0.0),
            "ssm_output_ms": pf.get("ssm_scan (ssm_output_kernel)", 0.0),
            "gemm_decode_ms": d.get(GEMM_KERNELS, 0.0)}


def phase_eager(torch, mm, seq: dict, serve: dict, graphed_profile: dict) -> dict:
    """The graphed engine against the eager one (``cuda_graphs=False``, the same
    programs' bodies run op by op) on the same model, weights, policy and requests:
    a captured decode replay equal bitwise to its body run eagerly; memory reserved
    with the graphed engine's programs and after dropping them; then the eager
    engine's same programs, each warmed up once, and a warm drain whose token
    streams must equal the graphed engine's, and its profile; warm numbers side
    by side."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    graphed = serve["engine"]
    prog, pool = graphed._decode_cache[4], graphed.pool
    snap = {k: t.clone() for k, t in pool._store.items()}
    prog.replay()
    replayed = prog.outputs["logits"].clone()
    for k, t in pool._store.items():
        t.copy_(snap[k])
    with graphed.runtime.activate():
        eager_logits = prog.body()["logits"]
    require(torch.equal(replayed, eager_logits), "a captured decode replay differs from its body run eagerly")
    for k, t in pool._store.items():
        t.copy_(snap[k])
    del snap, replayed, eager_logits, prog
    with_graphs = _reserved(torch)
    graphed._prefill_cache.clear()
    graphed._rejit_decode()
    without = _reserved(torch)

    rt = KernelRuntime(name=f"chip_smoke-eager[{serve['arch']}]")
    rt.install(FixedPolicy() if serve["policy"] is None else serve["policy"])
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt, cuda_graphs=False)
    require(not engine.cuda_graphs, "cuda_graphs=False took graphs")
    # The programs the graphed engine's drains built, warmed up without a drain of their own.
    for kind, size in sorted({(r["kind"], r["size"]) for r in serve["programs"]}):
        (engine._prefill_fn if kind == "prefill" else engine._decode_fn)(size)
    warm = _drain(torch, engine, serve["prompts"], mm, seq)
    per_forward = serve["per_forward"]
    bad = [(kind, size, n, b) for kind, size, n, _, b, _ in warm["events"] if n != per_forward or b]
    require(not bad, f"warm eager forwards whose GEMM launches are not {per_forward}, or that built a program: {bad}")
    require(warm["outputs"] == serve["outputs"],
            f"{serve['arch']}: the eager engine's token streams differ from the graphed engine's")
    profile = phase_profile(torch, serve, engine)
    eager_reserved = _reserved(torch)
    g, e = serve["warm"], warm
    # The profiler slows the host around every launch and traces every device operation.
    # An estimate without it mixes two drains: the profiled busy time per step over the
    # unprofiled warm median.
    unprofiled = lambda prof, drain: 1 - prof["busy_per_step_ms"] / drain["decode_median_ms"]
    timeline = lambda prof, key: prof["decode"]["timeline"].get(key)
    rows = {
        "decode step ms, median": (g["decode_median_ms"], e["decode_median_ms"]),
        "decode step ms, min": (g["decode_min_ms"], e["decode_min_ms"]),
        "decode step ms, max": (g["decode_max_ms"], e["decode_max_ms"]),
        "idle share, 2 profiled decode steps": (graphed_profile["idle_share"], profile["idle_share"]),
        "device busy ms per decode step (profiled)": (graphed_profile["busy_per_step_ms"],
                                                      profile["busy_per_step_ms"]),
        "idle share inside a step's device span (profiled timeline)": (
            timeline(graphed_profile, "idle_share_in_runs"), timeline(profile, "idle_share_in_runs")),
        "ms between the 2 profiled steps' device spans (timeline)": (
            timeline(graphed_profile, "between_runs_ms"), timeline(profile, "between_runs_ms")),
        "estimate: 1 - profiled busy per step / unprofiled warm median": (unprofiled(graphed_profile, g),
                                                                          unprofiled(profile, e)),
        "tokens/s": (g["tok_per_s"], e["tok_per_s"]),
        "seconds building programs (warm-up, capture)": (serve["capture_s"],
                                                         sum(r.seconds for r in engine.program_log)),
        "memory reserved GB, engine live, after empty_cache": (with_graphs / 1e9, eager_reserved / 1e9),
    }
    print(f"  {serve['arch']}: eager and graphed token streams equal (warm drains); a captured decode "
          f"replay equals its body run eagerly, bitwise")
    print(f"  {'warm, same card, same run':<60} {'graphed':>10} {'eager':>10}")
    for name, (gv, ev) in rows.items():
        fmt = (lambda v: "n/m" if v is None else f"{v:10.3f}")
        print(f"  {name:<60} {fmt(gv):>10} {fmt(ev):>10}")
    print(f"  warm tokens/s, graphed / eager: {g['tok_per_s'] / e['tok_per_s']:.2f}x; decode step median: "
          f"{e['decode_median_ms'] / g['decode_median_ms']:.2f}x shorter; the graphed engine's programs hold "
          f"{(with_graphs - without) / 1e9:.3f} GB reserved ({with_graphs / 1e9:.3f} with them, "
          f"{without / 1e9:.3f} after dropping them)")
    return {"warm": warm, "profile": profile, "side_by_side": rows,
            "memory_reserved": {"with_graphs": with_graphs, "without_graphs": without, "eager": eager_reserved}}


def _reserved(torch) -> int:
    """Bytes the caching allocator holds once its free cached blocks are released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase_ssm_capture_guard(torch, ss) -> dict:
    """A cut selective-scan call on a stream that has no workspace yet raises while a
    CUDA graph is being captured: the workspace is allocated (at its fixed bound)
    only outside a capture, so no graph captures one that could move."""
    g = torch.Generator(device="cuda").manual_seed(14)
    b, s, d, n = 1, 2048, 64, 16
    x, dt, bv, cv = (torch.randn(shape, device="cuda", generator=g)
                     for shape in ((b, s, d), (b, s, d), (b, s, n), (b, s, n)))
    a = -torch.rand((d, n), device="cuda", generator=g)
    segments = ss.launch_segments(b, s, d, n, ss.DEFAULT_SSM_CONFIG, True, 0)
    require(segments > 1, f"(1, {s}, {d}, {n}) is not cut ({segments} segment)")
    from repro_torch.serve.engine import _no_gc

    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    require((0, stream.cuda_stream) not in ss._WORKSPACE, "the fresh stream already holds an ssm workspace")
    err = None
    try:
        with _no_gc(), torch.cuda.graph(graph, stream=stream):
            ss.ssm_cuda_fused(x, dt.abs(), a, bv, cv)
    except RuntimeError as e:
        err = f"{e} / {e.__context__}"
    require(err is not None and "ssm workspace" in err, f"a workspace allocation during a capture did not raise: {err}")
    torch.cuda.synchronize()
    del graph
    print(f"  a cut call ({segments} segments) on a fresh stream under capture raised: {err.split(';')[0]}")
    return {"segments": segments, "raised": err}


def phase_reinstall(torch, mm, serve: dict) -> dict:
    """Install another policy mid-run on the tuned engine's runtime: every program
    is captured again under the new epoch, and its launches take the new policy's
    config."""
    from repro_torch.kernels.ops import FixedPolicy

    engine = serve["engine"]
    rt = engine.runtime
    epoch0 = rt.policy_epoch()
    prompts = serve["prompts"]
    for p in prompts[:2]:
        engine.submit(p, max_new_tokens=6)
    engine.step()
    engine.step()
    n0 = len(engine.program_log)
    mm.reset_launches()
    rt.install(FixedPolicy())
    for p in prompts[2:]:  # their prefills, and the decodes, after the install
        engine.submit(p, max_new_tokens=6)
    status = engine.drain()
    require(status.completed == 4 and not status.exhausted, f"after the install: {status}")
    new = engine.program_log[n0:]
    live = engine.programs()
    require(new and all(r.epoch == epoch0 + 1 and r.captured for r in new), f"programs after the install: {new}")
    require({r.kind for r in new} == {"prefill", "decode"}, f"not every kind of program was captured again: {new}")
    require(all(v["epoch"] == epoch0 + 1 for v in live.values()), f"a live program of an old epoch: {live}")
    got = {name: c for name, c in mm.LAUNCHES.items() if c}
    want = {mm.DEFAULT_CONFIG.name(): 2 * serve["per_forward"] * len(new)}
    require(got == want, f"GEMM launches after the install {got}, want {want}")
    print(f"  installed FixedPolicy() mid-run (epoch {epoch0} -> {epoch0 + 1}): {len(new)} programs captured again "
          f"({', '.join(f'{r.kind} {r.size}' for r in new)}); their GEMM launches {got}")
    return {"epoch": epoch0 + 1, "recaptured": [dataclasses.asdict(r) for r in new], "launches": got}


def _time_ms(fn, n_warm=3, n_runs=20, queued=True) -> float:
    """Median time of one call of ``fn`` between CUDA events, by the tuning
    tables' clock (``core/gpubench.time_ms``: queued behind a device sleep
    unless ``queued`` is false), at the smoke's counts."""
    from repro_torch.core.gpubench import time_ms

    return time_ms(fn, n_warm=n_warm, n_runs=n_runs, queued=queued)


def phase_timing(torch, mm, per_step: dict, kn_list, ms=(4, 128)) -> list[dict]:
    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    for m in ms:
        for k, n in kn_list:
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16  # the vocab GEMM emits f32 logits
            a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            b_bytes = k * n * 2
            copies = max(1, -(-150_000_000 // b_bytes))  # rotate weights through > 3x the L2
            bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
            out_bytes = m * n * (4 if out_dtype == torch.float32 else 2)
            flops = 2 * m * k * n
            nbytes = m * k * 2 + b_bytes + out_bytes
            bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            per_cfg = {
                cfg.name(): _time_ms(lambda i, c=cfg: mm.matmul_cuda(a, bs[i % copies], c, out_dtype=out_dtype))
                for cfg in mm.config_space()
            }
            call = _time_ms(lambda i: mm.matmul_cuda(a, bs[i % copies], out_dtype=out_dtype), queued=False)
            plain = _time_ms(lambda i: mm.matmul_plain(a, bs[i % copies], out_dtype))
            library = _time_ms(lambda i: torch.matmul(a, bs[i % copies]).to(out_dtype))
            best = min(per_cfg, key=per_cfg.get)
            row = {
                "m": m, "k": k, "n": n, "out": str(out_dtype).replace("torch.", ""),
                "ms": per_cfg[mm.DEFAULT_CONFIG.name()], "best_config": best, "best_ms": per_cfg[best],
                "call_ms": call, "plain_ms": plain, "library_ms": library, "bound_ms": bound,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                "launches_per_decode_step": per_step.get(f"{k}x{n}", 0) if m == 4 else None,
                "per_config_ms": per_cfg,
            }
            rows.append(row)
            print(f"  m={m:<4} k={k:<6} n={n:<6} {row['out']:>8}: kernel {row['ms']:.4f} ms "
                  f"(best {best} {per_cfg[best]:.4f}; one call from idle {call:.4f}), bound {bound:.4f} ms "
                  f"({row['bound_by']}), plain {plain:.4f}, torch.matmul {library:.4f}"
                  + (f", {row['launches_per_decode_step']:g} launches/decode step" if m == 4 else ""))
            del bs
    return rows


def phase_tall(torch, mm) -> dict:
    """The harvest's tallest GEMM, (16384, 4096, 14336) bf16, under every config (the
    128-row tiles on the persistent kernel, as the wrapper routes it), and at the
    persistent tiles with the bf16 operand transposed as the backward passes it
    (lhs view, rhs view)."""
    m, k, n = TALL
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
    b = torch.randn(k, n, device="cuda", generator=g).bfloat16()
    flops = 2 * m * k * n
    bound = max(flops / BF16_FLOPS, (m * k + k * n + m * n) * 2 / HBM_BYTES_PER_S) * 1e3
    per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: mm.matmul_cuda(a, b, c), n_runs=5) for cfg in mm.config_space()}
    wide = [cfg for cfg in mm.config_space() if cfg.tile() in mm.PERSISTENT_TILES]
    at, bt = a.t().contiguous().t(), b.t().contiguous().t()
    views = {f"{cfg.name()} {side}": _time_ms(lambda i, c=cfg, l=l, r=r: mm.matmul_cuda(l, r, c), n_runs=5)
             for cfg in wide for side, (l, r) in (("lhs view", (at, b)), ("rhs view", (a, bt)))}
    library = _time_ms(lambda i: torch.matmul(a, b), n_runs=5)
    tflops = {name: flops / ms / 1e9 for name, ms in per_cfg.items()}
    best = min(per_cfg, key=per_cfg.get)
    print(f"  {TALL} bf16: {mm.DEFAULT_CONFIG.name()} {per_cfg[mm.DEFAULT_CONFIG.name()]:.3f} ms "
          f"({tflops[mm.DEFAULT_CONFIG.name()]:.1f} TFLOP/s), best {best} {per_cfg[best]:.3f} ms "
          f"({tflops[best]:.1f} TFLOP/s); bound {bound:.3f} ms (operations); torch.matmul {library:.3f} ms "
          f"({flops / library / 1e9:.1f} TFLOP/s)")
    print("    " + ", ".join(f"{name} {t:.0f}" for name, t in tflops.items()) + " TFLOP/s")
    print("    transposed operands: " + ", ".join(f"{name} {flops / ms / 1e9:.0f}" for name, ms in views.items())
          + " TFLOP/s")
    return {"shape": list(TALL), "per_config_ms": per_cfg, "tflops": tflops, "bound_ms": bound,
            "transposed_ms": views, "best": best, "best_tflops": tflops[best],
            "library_ms": library, "library_tflops": flops / library / 1e9}


def phase_parent_ab(serves: dict) -> dict | None:
    """The parent's GEMM against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import gemm_ab

    for arch, serve in serves.items():
        counted = {tuple(map(int, kn.split("x"))): c for kn, c in serve["per_decode_step"].items()}
        require(counted == gemm_ab.DECODE_STEP[arch], f"{arch}: decode-step GEMMs {counted} are not "
                                                       f"scripts/gemm_ab.py's {gemm_ab.DECODE_STEP[arch]}")
    result = gemm_ab.run_turns(base)
    gemm_ab.report(result)
    steps = gemm_ab.step_sums(result)
    return result | {"decode_steps": steps}


def phase_attention_parent_ab() -> dict | None:
    """The parent's attention kernel against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "attention.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import attn_ab

    result = attn_ab.run_turns(base)
    attn_ab.report(result)
    return result | {"verdict": attn_ab.verdict(result)}


def phase_ssm_parent_ab() -> dict | None:
    """The parent's selective scan against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "ssm.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import ssm_ab

    result = ssm_ab.run_turns(base)
    ssm_ab.report(result)
    return result


def phase_wkv_timing(torch, wk) -> list[dict]:
    """The WKV kernel at what rwkv6-7b's batch-1 prefill gives it (bf16 r/k/v
    and u, f32 logw, a zero f32 state), every config, beside its bound."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, hd = 1, 64, 64
    for s in (32, 64, 128, WKV_LONG):
        r, k, v, logw, u, _ = _wkv_inputs(torch, g, b, s, h, hd, torch.bfloat16, "dist", False)
        state = torch.zeros((b, h, hd, hd), device="cuda")
        args = (r, k, v, logw, u, state)
        # Each input read once, each output written once.
        nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * h * hd * 4 + b * h * hd * hd * 4
        # The recurrent form's count, the fewest for this function: per token and head,
        # o = r.S (2 hd^2), S = w (.) S + k v^T (3 hd^2), the u-bonus (4 hd).
        ops = b * s * h * (5 * hd * hd + 4 * hd)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: wk.wkv_cuda(*args, config=c))
                   for cfg in wk.config_space()}
        call = _time_ms(lambda i: wk.wkv_cuda(*args), queued=False)
        plain = _time_ms(lambda i: wk.wkv_plain(*args))
        launches = _kernel_launches(lambda: wk.wkv_cuda(*args), ("wkv_state_kernel", "wkv_output_kernel"))
        require(launches is None or set(launches.values()) == {1.0},
                f"one wkv_cuda call should launch the state pass and the output kernel once each: {launches}")
        best = min(per_cfg, key=per_cfg.get)
        row = {"s": s, "shape": [b, s, h, hd], "ms": per_cfg[wk.DEFAULT_WKV_CONFIG.name()], "best_config": best,
               "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain, "bound_ms": bound,
               "bytes": nbytes, "ops": ops,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
               "per_config_ms": per_cfg, "kernel_launches_per_call": launches}
        rows.append(row)
        cfgs = ", ".join(f"{name} {ms:.4f}" for name, ms in per_cfg.items())
        print(f"  (1, {s}, 64, 64) bf16: {cfgs} ms; bound {bound:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {wk.DEFAULT_WKV_CONFIG.name()} call from idle "
              f"{call:.4f} ms; plain {plain:.4f} ms; kernel launches per call {launches}")
    return rows


def _kernel_launches(fn, names, calls=4, tries=3) -> dict | None:
    """Device kernels per call of ``fn`` whose names hold one of ``names``, by
    name, over ``calls`` calls (torch.profiler); None where it records none.
    A small torch op opens the window: the profiler may drop its first kernel.
    Every call launches a whole number of each kernel, so a count that is not a
    multiple of ``calls`` means the profiler dropped records (PERF.md §7): the
    window is profiled again, up to ``tries`` times, and the last counts are
    returned, whole or not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {n: sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and n in e.key)
                  for n in names}
        if all(c % calls == 0 for c in counts.values()):
            break
    return {n: c / calls for n, c in counts.items()} if any(counts.values()) else None


def phase_ssm_timing(torch, ss) -> list[dict]:
    """Both SSM entries at what hymba-1.5b's batch-1 prefill gives them (f32, no
    initial state), S in the served buckets and SSM_LONG, every config, each beside
    its own bound, the plain version, and the kernels one call launches."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(8)
    b, d, n = 1, 1600, 16
    entries = {"fused": (_ssm_fused_inputs, ss.ssm_cuda_fused, ss.ssm_fused_plain),
               "dta": (_ssm_inputs, ss.ssm_cuda, ss.ssm_plain)}
    for s in (32, 64, 128, SSM_LONG):
        for entry, (draw, kernel, plain_fn) in entries.items():
            args = draw(torch, g, b, s, d, n, False)[:-1]
            # Each input read once (no initial state on the served path), y and the final
            # state written once: the fused entry reads x, dt, a, b, c; the dta entry dtx,
            # dta (B, S, d, N), b, c.
            nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * d * 4 + b * d * n * 4
            # Per (t, channel, state): exp, dtx * b, the fma into h, h * c and its sum: 6 f32 operations
            # (the fused entry's dt * x and dt * a add 1 + 1 / N).
            ops = 6 * b * s * d * n
            bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
            per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: kernel(*args, config=c)) for cfg in ss.config_space()}
            call = _time_ms(lambda i: kernel(*args), queued=False)
            plain = _time_ms(lambda i: plain_fn(*args), n_runs=5 if s == SSM_LONG else 20)
            segments = ss.launch_segments(b, s, d, n, ss.DEFAULT_SSM_CONFIG, entry == "fused", 0)
            launches = _kernel_launches(lambda: kernel(*args), ("ssm_state_kernel", "ssm_output_kernel"))
            want = {"ssm_state_kernel": float(segments > 1), "ssm_output_kernel": 1.0}
            require(launches is None or launches == want,
                    f"one {entry} call at S = {s} ({segments} segments) should launch {want}: {launches}")
            best = min(per_cfg, key=per_cfg.get)
            row = {"s": s, "entry": entry, "shape": [b, s, d, n], "ms": per_cfg[ss.DEFAULT_SSM_CONFIG.name()],
                   "best_config": best, "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain,
                   "bound_ms": bound, "bytes": nbytes, "ops": ops,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
                   "segments": segments, "kernel_launches_per_call": launches, "per_config_ms": per_cfg}
            rows.append(row)
            cfgs = ", ".join(f"{name} {ms * 1e3:.2f}" for name, ms in per_cfg.items())
            print(f"  (1, {s}, 1600, 16) f32 {entry}: {cfgs} us; bound {bound * 1e3:.2f} us ({row['bound_by']}: "
                  f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {ss.DEFAULT_SSM_CONFIG.name()} call from "
                  f"idle {call * 1e3:.2f} us; plain {plain:.4f} ms; {segments} segments, kernels per call {launches}")
    return rows


def _attention_bound(sq: int, skv: int, d: int, heads: int, causal: bool) -> tuple[float, str]:
    """(least ms, what bounds it) for one bf16 attention call: the larger of
    the useful FLOPs (both products over the visible (row, column) pairs of
    this call's mask) over the bf16 tensor-core peak and the bytes of q, k, v
    and the output (each read or written once) over the memory rate."""
    if causal:  # row i sees min(skv, i + skv - sq + 1) columns; rows below sq - skv see none
        pairs = sum(min(skv, i + skv - sq + 1) for i in range(max(0, sq - skv), sq))
    else:
        pairs = sq * skv
    flops = 4.0 * pairs * d * heads
    nbytes = (2 * sq + 2 * skv) * d * heads * 2
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attn_inputs(torch, g, lead, sq, skv, d, dtype):
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g, dtype=torch.float32).to(dtype)
    return randn(*lead, sq, d), randn(*lead, skv, d), randn(*lead, skv, d)


def _plain_by_head(at, q, k, v, causal=True):
    """The plain version head by head (its f32 logits of a 32768 x 32768 head
    take 4.3 GB; of all 32 heads at once, 137 GB)."""
    out = q.new_empty(q.shape)
    for h in range(q.shape[1]):
        out[:, h] = at.attention_plain(q[:, h], k[:, h], v[:, h], causal=causal)
    return out


# Phase 16's shapes: (leading dims, sq, skv). (40, 24) and (300, 200) have rows that see nothing
# (at (300, 200) whole query blocks); sq in {1, 4} at skv in {4103, 32768} take the split path; the
# last two are what granite-8b serving would give the kernel.
ATTN_SHAPES = [((2, 3), sq, skv) for sq, skv in ((1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000),
                                                  (40, 24), (300, 200), (1, 4103), (4, 4103), (1, 32768),
                                                  (4, 32768))]
ATTN_SHAPES += [((1, 32), 1, 32768), ((1, 32), 4096, 4096)]


def phase_attention_vs_plain(torch, at) -> dict:
    """Every compiled attention config against the plain version, each called twice in a
    row on the same inputs (bitwise equal), on the path its block_q names and split where
    kv_splits says so; then RACE_PASSES more passes over the bf16 shapes with fresh inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)
    worst = {name: {"rel": 0.0, "abs": 0.0} for name in ATTN_TOL}
    checks, splits_seen = 0, {}
    at.reset_launches()
    dtypes = (("bf16", torch.bfloat16), ("f32", torch.float32))
    passes = [(lead, sq, skv, dtypes) for lead, sq, skv in ATTN_SHAPES]
    passes += [(lead, sq, skv, dtypes[:1]) for _ in range(RACE_PASSES) for lead, sq, skv in ATTN_SHAPES]
    for lead, sq, skv, kinds in passes:
        bh = lead[0] * lead[1]
        for d in (64, 128):
            for name, dtype in kinds:
                q, k, v = _attn_inputs(torch, g, lead, sq, skv, d, dtype)
                for causal in (True, False):
                    want = _plain_by_head(at, q, k, v, causal=causal).float()
                    scale = want.abs().max().item()
                    for cfg in at.config_space():
                        paths, launched = dict(at.PATH_LAUNCHES), at.SPLITS_LAUNCHED[cfg.name()]
                        first = at.attention_cuda(q, k, v, cfg, causal=causal)
                        second = at.attention_cuda(q, k, v, cfg, causal=causal)
                        where = f"{cfg.name()} {name} {(*lead, sq, skv, d)} causal={causal}"
                        for got in (first.float(), second.float()):
                            require(bool(torch.isfinite(got).all()), f"{where}: output not finite")
                            if causal and sq > skv:
                                require(bool((got[..., : sq - skv, :] == 0).all()), f"{where}: rows that see "
                                                                                      f"nothing are not zeros")
                            err = (got - want).abs().max().item()
                            require(err <= ATTN_TOL[name] * scale, f"{where}: rel err {err / scale:.3g} > "
                                                                   f"{ATTN_TOL[name]}")
                            w = worst[name]
                            w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                            checks += 1
                        require(torch.equal(first, second), f"{where}: two calls in a row differ")
                        path = cfg.bf16_path() if name == "bf16" else "simt_f32"
                        splits = at.launch_splits(bh, sq, skv, d, cfg, causal, 0) if name == "bf16" else 1
                        delta = {p: c - paths[p] for p, c in at.PATH_LAUNCHES.items() if c != paths[p]}
                        launched = at.SPLITS_LAUNCHED[cfg.name()] - launched
                        require(delta == {path: 2, **({"split": 2} if splits > 1 else {})} and
                                launched == (2 * splits if splits > 1 else 0),
                                f"{where}: launches by path {delta}, {launched} splits; want {path}, {splits} splits")
                        if splits > 1:
                            splits_seen[f"{(*lead, sq, skv, d)} causal={causal} {cfg.name()}"] = splits
                del q, k, v
    torch.cuda.synchronize()
    paths = dict(at.PATH_LAUNCHES)
    require(all(paths.values()), f"an attention path was never launched: {paths}")
    # Every wgmma config took the wgmma path at sq >= 64, and every call whose rule splits
    # launched that many splits (checked per call above); the decode shapes did split:
    require(all(any(f"(2, 3, 1, {skv}, {d}) causal={c} {cfg.name()}" in splits_seen for c in (True, False))
                for skv in (4103, 32768) for d in (64, 128) for cfg in at.config_space()),
            f"a decode shape did not split: {sorted(splits_seen)}")
    sys.path.insert(0, str(ROOT / "scripts"))
    import attn_race

    releases = {}
    read = attn_race.overtaking_arrives(("attention", "matmul"), releases=releases)
    sass = read["attention"]
    late = {fn: n for fn, n in sass.items() if fn != "functions"}
    require(not late, f"attention stage releases that can overtake a shared load in flight: {late}")
    # The GEMM's wgmma kernels (the persistent one, and the ring kernel's 64- and 128-row
    # tiles) must have none either; its mma.sync tiles release the previous stage (read
    # against csrc/matmul.cu: no race) and are reported.
    wgmma = lambda fn: "gemm_persistent_kernel" in fn or re.search(r"gemm_tma_kernelILi(64|128)E", fn)
    mm_late = {fn: n for fn, n in read["matmul"].items() if fn != "functions"}
    mm_wgmma = {fn: n for fn, n in releases["matmul"].items() if wgmma(fn)}
    require(not {fn: n for fn, n in mm_late.items() if wgmma(fn)},
            f"GEMM wgmma kernels' stage releases that can overtake a shared load in flight: {mm_late}")
    require(any("gemm_persistent_kernel" in fn for fn in mm_wgmma),
            f"no stage release read in the persistent GEMM kernel: {sorted(releases['matmul'])[:4]}")
    for name, w in worst.items():
        print(f"  {name}: worst rel err {w['rel']:.3g} (limit {ATTN_TOL[name]}), worst abs err {w['abs']:.3g}")
    print(f"  SASS of the {sass['functions']} attention kernels: no stage release can overtake a shared load "
          f"(scripts/attn_race.py); of the {read['matmul']['functions']} GEMM kernels, the {len(mm_wgmma)} wgmma "
          f"ones ({sum(mm_wgmma.values())} stage releases, {sum('persistent' in fn for fn in mm_wgmma)} persistent): "
          f"none; the mma.sync ones' previous-stage releases: {sum(mm_late.values())} candidates in {len(mm_late)} "
          f"kernels")
    print(f"  {checks} checks ({len(ATTN_SHAPES)} shapes x 2 head dims x 2 dtypes x 2 masks x "
          f"{len(at.config_space())} configs x 2 calls, then {RACE_PASSES} bf16 passes with fresh inputs): every "
          f"output finite, both calls bitwise equal; at (40, 24) and (300, 200) causal the rows that see nothing are "
          f"zeros; launches by path {paths}; {len(splits_seen)} (shape, mask, config) triples split KV, "
          f"{min(splits_seen.values())}-{max(splits_seen.values())} splits")
    return {"worst": worst, "checks": checks, "paths": paths, "splits": splits_seen,
            "sass_kernels_read": sass["functions"], "sass_matmul_kernels_read": read["matmul"]["functions"],
            "sass_matmul_wgmma_releases": mm_wgmma, "sass_matmul_mma_sync_candidates": mm_late}


def _full_tables(result) -> dict:
    """Per family: {problem: row over the whole config space} of a tune that measured
    every cell (phase 17): matmul's train and test splits, each family's own table."""
    from repro_torch.core.families import get_family

    out = {"matmul": {tuple(p): row for ds in (result.train, result.test) for p, row in zip(ds.problems, ds.perf)}}
    for name, fr in result.family_results.items():
        require(fr.kept == tuple(range(len(get_family(name).config_space()))), f"{name}: not the whole space")
        out[name] = {tuple(p): row for p, row in zip(fr.problems, fr.perf)}
    return out


def _oracle_on(table: dict, configs, family: str) -> float:
    """Oracle fraction of the deployed ``configs`` over a full measured table."""
    import numpy as np

    from repro_torch.core.families import get_family
    from repro_torch.core.selection import achievable_fraction

    space = list(get_family(family).config_space())
    perf = np.stack([table[p] for p in sorted(table)])
    return achievable_fraction(perf, sorted({space.index(c) for c in configs}))


def phase_tune(torch, mm, at, wk, ss) -> dict:
    """The tuning entry point on the card, in process, every family, as a fleet of the
    card and host_cpu: measured tables -> cluster-select -> decision trees ->
    build/bundle_h100.json, and the card's Deployment from the same run ->
    build/deploy_h100.json."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.families import family_names, get_family
    from repro_torch.core.gpubench import card_name
    from repro_torch.launch import tune as tune_cli

    card = card_name()
    mods = {"matmul": mm, "attention": at, "wkv": wk, "ssm_scan": ss}
    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    fleet = tune_cli.main(["--devices", f"{card},host_cpu", "--archs", ",".join(TUNED_ARCHS), "--n-kernels", "4",
                           "--cpu-problems", "8", "--bundle", str(BUNDLE_PATH), "--out", str(DEPLOY_PATH)])
    wall = time.perf_counter() - t0
    launches = {fam: mod.total_launches() for fam, mod in mods.items()}
    require(sorted(fleet.results) == sorted([card, "host_cpu"]), f"fleet tuned {sorted(fleet.results)}")
    result = fleet.results[card]
    dep = result.deployment
    require(DEPLOY_PATH.is_file() and BUNDLE_PATH.is_file(), f"{DEPLOY_PATH} or {BUNDLE_PATH} not written")
    require(Deployment.load(DEPLOY_PATH).to_blob() == dep.to_blob(), "--out is not the fleet's card Deployment")
    require(result.train.source == "measured" and dep.device == card,
            f"not a measured card table: {result.train.source} on {dep.device}")
    lineage, tables, seconds = dep.meta["tuning_lineage"], dep.meta["tables"], dep.meta["measure_seconds"]
    require(set(tables) == set(family_names()) == set(mods), f"families tuned: {sorted(tables)}")
    for fam in tables:
        require(tables[fam][1] == len(get_family(fam).config_space()), f"{fam}: table {tables[fam]} is not the "
                                                                       f"full config space")
        require(lineage[fam]["measured_fraction"] == 1.0, f"{fam}: not every cell measured: {lineage[fam]}")
        require(launches[fam] > 0, f"{fam}: no launches while measuring: {launches}")
    full = _full_tables(result)
    fractions = {"matmul": [result.oracle_fraction, result.classifier_fraction]} | {
        name: [r.oracle_fraction, r.classifier_fraction] for name, r in result.family_results.items()}
    out = {
        "device": dep.device, "wall_s": wall, "tables": tables, "measure_seconds": seconds,
        "deployed": {fam: [c.name() for c in dep.family_tuning(fam).configs] for fam in tables},
        "fractions": fractions,
        "oracle_on_full_table": {fam: _oracle_on(full[fam], dep.family_tuning(fam).configs, fam) for fam in tables},
        "launches_while_measuring": launches, "full": full,
        "fleet": {name: {"oracle": r.oracle_fraction, "classifier": r.classifier_fraction}
                  for name, r in fleet.results.items()},
    }
    print(f"  fleet {sorted(fleet.results)} tuned in {wall:.1f}s; {dep.device}: tables {tables} (problems x configs), "
          f"measured in {seconds} s; launches while measuring {launches}; host_cpu: oracle "
          f"{out['fleet']['host_cpu']['oracle']:.4f} / classifier {out['fleet']['host_cpu']['classifier']:.4f}")
    for fam in tables:
        print(f"  {fam}: oracle {fractions[fam][0]:.4f} / classifier {fractions[fam][1]:.4f} "
              f"(oracle over the whole table {out['oracle_on_full_table'][fam]:.4f}); deployed {out['deployed'][fam]}")
    return out


def phase_staged(torch, mods: dict, tuning: dict) -> dict:
    """The staged bring-up on the card: phase 17's deployment as donor, half of each
    config space pruned on the H100 model, the budget sized from the donor's lineage;
    each family's measured cells against its budget, its seconds against phase 17's, the
    model's error on the measured cells, and the staged deployment's oracle fraction over
    phase 17's full measured table."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.pipeline import resolve_measure_budget
    from repro_torch.launch import tune as tune_cli

    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    result = tune_cli.main(["--archs", ",".join(TUNED_ARCHS), "--n-kernels", "4", "--transfer-from", str(DEPLOY_PATH),
                            "--prune-ratio", "0.5", "--measure-budget", "auto", "--out", str(STAGED_PATH)])
    wall = time.perf_counter() - t0
    launches = {fam: mod.total_launches() for fam, mod in mods.items()}
    dep, donor = result.deployment, Deployment.load(DEPLOY_PATH)
    lineage, seconds = dep.meta["tuning_lineage"], dep.meta["measure_seconds"]
    rows = {}
    for fam in mods:
        rec = lineage[fam]
        budget = resolve_measure_budget("auto", donor, family=fam)
        require(budget is not None and rec["measured_fraction"] <= budget,
                f"{fam}: measured {rec['measured_fraction']} of the cells, budget {budget}")
        require(rec["source_device"] == donor.device, f"{fam}: donor {rec['source_device']}")
        rows[fam] = {
            "n_measured": rec["n_measured"], "full_cost": rec["full_cost"],
            "measured_fraction": rec["measured_fraction"], "budget": budget, "prune_ratio": rec["prune_ratio"],
            "seconds": seconds[fam], "seconds_phase_17": tuning["measure_seconds"][fam],
            "model_error": rec["model_error"],
            "oracle_on_full_table": _oracle_on(tuning["full"][fam], dep.family_tuning(fam).configs, fam),
            "oracle_on_full_table_phase_17": tuning["oracle_on_full_table"][fam],
            "deployed": [c.name() for c in dep.family_tuning(fam).configs],
            "launches_while_measuring": launches[fam],
        }
        r = rows[fam]
        print(f"  {fam}: measured {r['n_measured']}/{r['full_cost']} cells ({r['measured_fraction']:.3f}, budget "
              f"{budget:.3f}, kept {r['prune_ratio']:.2f} of the space) in {r['seconds']:.2f}s (phase 17: "
              f"{r['seconds_phase_17']:.2f}s); model error {r['model_error']}; oracle over phase 17's full table "
              f"{r['oracle_on_full_table']:.4f} (phase 17's own deployment: {r['oracle_on_full_table_phase_17']:.4f})")
    print(f"  staged tune in {wall:.1f}s (phase 17: {tuning['wall_s']:.1f}s)")
    return {"wall_s": wall, "families": rows}


def _first_layers(tree, n: int):
    """The stacked per-layer weights of a params subtree, cut to the first ``n`` layers."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _bucket_configs(rt, family: str) -> dict:
    """{prefill bucket: config name} of ``family``'s selections in ``rt``'s log."""
    return {problem[0]: cfg.name() for op, problem, cfg in rt.selection_log() if op == family}


def _served_prefill_logits(torch, eng, prompt):
    """The logits of the captured prefill program ``eng`` admits ``prompt`` with:
    its bucket's program (``_prefill_fn``), staged as ``_admit`` stages it (left-
    padded with 0) and replayed."""
    import numpy as np

    from repro_torch.serve.engine import _bucket

    plen = _bucket(len(prompt), eng._ladder)
    tokens = np.zeros((1, plen), dtype=np.int64)
    tokens[0, plen - len(prompt):] = prompt
    prog = eng._prefill_fn(plen)
    require(prog.graph is not None, f"{eng.runtime.name}: prefill {plen} is not a captured program")
    prog.stage(tokens=tokens)
    logits = prog.run(eng.runtime)["logits"].clone()
    require(bool(torch.isfinite(logits).all()), f"{eng.runtime.name}: non-finite prefill logits at {plen}")
    return plen, logits


def phase_fleet_serve(torch, mods: dict, tuning: dict) -> dict:
    """The fleet bundle of phase 17 (the card and host_cpu), loaded into a fresh
    runtime (checksums verified), resolved by detection and by REPRO_DEVICE, then
    rwkv6-7b and hymba-1.5b served from it through launch.serve's --bundle path under
    CUDA graphs, beside the FixedPolicy() engine; a TPU bundle must not install."""
    from repro_torch import load_bundle
    from repro_torch.configs import registry
    from repro_torch.core import devices
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import build_model

    card = tuning["device"]
    bundle = load_bundle(BUNDLE_PATH)
    require(bundle.load_errors == [] and bundle.devices == sorted([card, "host_cpu"]),
            f"bundle {bundle.devices}, load errors {bundle.load_errors}")
    blob = json.loads(BUNDLE_PATH.read_text())
    require(blob["version"] == 6 and blob["checksums"], f"not a v6 bundle with checksums: {blob.get('version')}")
    detected = devices.detect_device(env={})
    a100 = devices.detect_device(env={devices.DEVICE_ENV_VAR: "NVIDIA A100-SXM4-80GB"})
    require(devices.resolve_device(detected, bundle.devices) == card, f"detected {detected} resolves elsewhere")
    # The A100 has no entry and no FALLBACKS chain: the same-platform step picks the card.
    require(a100 not in bundle.devices and not devices.fallback_order(a100) and a100.startswith("gpu_")
            and devices.resolve_device(a100, bundle.devices, strict=True) == card,
            f"REPRO_DEVICE A100 ({a100}) does not resolve to {card} by platform")
    rt = bundle.runtime()
    require(rt.active_device() == card, f"fresh runtime serves {rt.active_device()}")
    try:
        KernelRuntime(name="tpu-fixture").install_bundle(TPU_FIXTURE)
        tpu_err = None
    except ValueError as e:
        tpu_err = str(e)
    require(tpu_err is not None and "compiled space" in tpu_err, "a TPU bundle installed for the card")
    print(f"  bundle of phase 17: {bundle.devices}, v6, {len(blob['checksums'])} checksums verified, "
          f"load_errors []; detected {detected} -> {card}; REPRO_DEVICE A100 -> {a100} -> {card} (same platform); "
          f"TPU fixture refused: {tpu_err[:120]}...")
    card_dep = bundle.deployments[card]
    served = {}
    for arch in SERVED_ARCHS:
        cfg = registry.get(arch)
        per_forward, per_prefill = _expected(cfg)
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        rng = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]
        engines = {
            "bundle": serve_cli.build_engine(model, params, bundle=str(BUNDLE_PATH), name=f"bundle[{arch}]",
                                             max_batch=4, cache_len=256),
            "fixed": serve_cli.build_engine(model, params, name=f"fixed[{arch}]", max_batch=4, cache_len=256),
        }
        require(engines["bundle"].device == card and engines["bundle"].cuda_graphs, "bundle engine")
        outs, counts = {}, {}
        for label, eng in engines.items():
            eng.runtime.set_selection_logging(True, cap=1 << 16)
            torch.cuda.synchronize()
            for mod in mods.values():  # the main path: counts to 0 just before, read just after
                mod.reset_launches()
            tickets = [eng.submit(p, max_new_tokens=16) for p in prompts]
            status = eng.drain()
            torch.cuda.synchronize()
            require(status.completed == 4 and all(len(t.request.output) == 16 for t in tickets), f"{label}: {status}")
            require(all(r.captured for r in eng.program_log), f"{label}: a program was not captured")
            outs[label] = [list(t.request.output) for t in tickets]
            counts[label] = {fam: dict(mod.LAUNCHES) for fam, mod in mods.items()}
        seq_fam, seq_mod = ("wkv", "wkv") if cfg.family == "ssm" else ("ssm_scan", "ssm_scan")
        by_bucket = _bucket_configs(engines["bundle"].runtime, seq_fam)
        want = {s: card_dep.select(seq_fam, (s, 64 if seq_fam == "wkv" else cfg.d_model)).name() for s in by_bucket}
        require(by_bucket == want and by_bucket, f"{arch}: served {seq_fam} configs {by_bucket}, the tree names {want}")
        launched = {n: c for n, c in counts["bundle"][seq_mod].items() if c}
        require(set(launched) == set(by_bucket.values()), f"{arch}: launched {launched}, selected {by_bucket}")
        n_prefill = sum(r.kind == "prefill" for r in engines["bundle"].program_log)
        key = "wkv" if seq_fam == "wkv" else "ssm"
        require(sum(launched.values()) == 2 * per_prefill[key] * n_prefill,
                f"{arch}: {seq_fam} launches {launched}, want 2 x {per_prefill[key]} x {n_prefill} prefill programs")
        # Prefill logits of each prompt from each engine's captured prefill program (the
        # one it served the prompt with) against FixedPolicy()'s. Two configs of the WKV /
        # scan kernel sum in other orders, and a deep random-weight model amplifies f32
        # rounding, so the gate is LOGIT_TOL on engines of the model's first LOGIT_DEPTH
        # layers (the same weights), built through the same build_engine path; the full-
        # depth engines' difference is reported.
        shallow = dataclasses.replace(cfg, n_layers=LOGIT_DEPTH)
        shallow_model = build_model(shallow, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        shallow_params = dict(params, blocks=_first_layers(params["blocks"], LOGIT_DEPTH))
        gate = {
            "bundle": serve_cli.build_engine(shallow_model, shallow_params, bundle=str(BUNDLE_PATH),
                                             name=f"bundle[{arch}, {LOGIT_DEPTH} layers]", max_batch=4,
                                             cache_len=256),
            "fixed": serve_cli.build_engine(shallow_model, shallow_params, name=f"fixed[{arch}, {LOGIT_DEPTH} layers]",
                                            max_batch=4, cache_len=256),
        }
        gate["bundle"].runtime.set_selection_logging(True, cap=1 << 16)
        rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
        logit_rows = []
        for p in prompts:
            plen, full_b = _served_prefill_logits(torch, engines["bundle"], p)
            _, full_f = _served_prefill_logits(torch, engines["fixed"], p)
            _, gate_b = _served_prefill_logits(torch, gate["bundle"], p)
            _, gate_f = _served_prefill_logits(torch, gate["fixed"], p)
            row = {"bucket": plen, f"first_{LOGIT_DEPTH}_layers": rel(gate_b, gate_f),
                   "full_depth": rel(full_b, full_f)}
            require(row[f"first_{LOGIT_DEPTH}_layers"] <= LOGIT_TOL[arch],
                    f"{arch}: the bundle engine's captured prefill logits over the first {LOGIT_DEPTH} layers differ "
                    f"from FixedPolicy()'s by {row[f'first_{LOGIT_DEPTH}_layers']:.3g} (rel) > {LOGIT_TOL[arch]}")
            logit_rows.append(row)
            del full_b, full_f, gate_b, gate_f
        gate_by_bucket = _bucket_configs(gate["bundle"].runtime, seq_fam)
        require(gate_by_bucket == {b: by_bucket[b] for b in gate_by_bucket} and gate_by_bucket,
                f"{arch}: the {LOGIT_DEPTH}-layer bundle engine launched {gate_by_bucket}, the served one {by_bucket}")
        del gate, shallow_model, shallow_params
        served[arch] = {
            "device": engines["bundle"].device, f"{seq_fam}_configs_by_bucket": by_bucket,
            "default": (mods[seq_mod].DEFAULT_WKV_CONFIG if seq_fam == "wkv" else mods[seq_mod].DEFAULT_SSM_CONFIG).name(),
            "launches": {label: {fam: sum(c.values()) for fam, c in cnt.items()} for label, cnt in counts.items()},
            "prefill_logits": logit_rows, "streams_equal": outs["bundle"] == outs["fixed"],
            "programs": {label: len(eng.program_log) for label, eng in engines.items()},
        }
        print(f"  {arch} (f32, full width) from the bundle ({engines['bundle'].device}): {seq_fam} configs by prefill "
              f"bucket {by_bucket} (default {served[arch]['default']}), launches {launched}; greedy streams equal "
              f"FixedPolicy()'s: {served[arch]['streams_equal']}")
        for row in logit_rows:
            print(f"    bucket {row['bucket']}: captured prefill logits vs FixedPolicy()'s (rel): first {LOGIT_DEPTH} "
                  f"layers {row[f'first_{LOGIT_DEPTH}_layers']:.3g} (limit {LOGIT_TOL[arch]}); full depth "
                  f"{row['full_depth']:.3g} (reported)")
        del engines, model, params
        gc.collect()
        torch.cuda.empty_cache()
    return {"devices": bundle.devices, "checksums": len(blob["checksums"]),
            "detected": detected, "a100": a100, "tpu_fixture_refused": tpu_err, "served": served}


def phase_quickstart(torch, mm, at, ops) -> dict:
    """The quickstart's path on the card: the tuned Deployment in a fresh
    runtime, ops.attention at every harvested attention problem at (1, 32)
    heads in bf16 and ops.matmul at the quickstart's two shapes, each call
    launching exactly the config the Deployment's tree names."""
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.core.attnmodel import harvest_attn_problems
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import KernelRuntime

    dep = Deployment.load(DEPLOY_PATH)
    rt = KernelRuntime(name="chip_smoke-tuned")
    rt.install(dep)
    rt.set_selection_logging(True)
    problems = harvest_attn_problems(list(TUNED_ARCHS))
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(12)
    heads = 32
    # The main path: counts to 0 just before, read just after; every call's
    # output is checked afterwards, and the timing launches come after the read.
    torch.cuda.synchronize()
    at.reset_launches()
    mm.reset_launches()
    calls = []
    for sq, skv, d in problems:
        q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
        want_cfg = dep.select_attention(sq, skv, d)
        for _ in range(2):  # the second call is a shape-cache hit
            before, paths = dict(at.LAUNCHES), dict(at.PATH_LAUNCHES)
            splits = at.SPLITS_LAUNCHED[want_cfg.name()]
            with rt.activate():
                got = ops.attention(q, k, v)
            delta = {n: c - before[n] for n, c in at.LAUNCHES.items() if c != before[n]}
            require(delta == {want_cfg.name(): 1}, f"ops.attention at {(sq, skv, d)} launched {delta}, the tree "
                                                   f"names {want_cfg.name()}")
            route = {p: c - paths[p] for p, c in at.PATH_LAUNCHES.items() if c != paths[p]}
            splits = at.SPLITS_LAUNCHED[want_cfg.name()] - splits or 1
            require(sq > 1 or (route.get("split") == 1 and splits > 1),
                    f"decode ops.attention at {(sq, skv, d)} did not split KV: {route}, {splits} splits")
        calls.append(((sq, skv, d), want_cfg, (q, k, v), got, "+".join(sorted(route)), splits))
    mm_calls = []
    for m, k, n in ((512, 784, 512), (1, 4096, 512)):  # the quickstart's two GEMMs
        a = torch.randn((m, k), device="cuda", generator=g).bfloat16()
        b = torch.randn((k, n), device="cuda", generator=g).bfloat16()
        want_cfg = dep.select_matmul(m, k, n, 1)
        before = dict(mm.LAUNCHES)
        with rt.activate():
            got = ops.matmul(a, b)
        delta = {name: c - before[name] for name, c in mm.LAUNCHES.items() if c != before[name]}
        require(delta == {want_cfg.name(): 1}, f"ops.matmul at {(m, k, n)} launched {delta}, the tree names "
                                               f"{want_cfg.name()}")
        mm_calls.append(((m, k, n, 1), want_cfg, a, b, got))
    torch.cuda.synchronize()
    launches = {"attention": dict(at.LAUNCHES), "matmul": dict(mm.LAUNCHES)}
    paths = dict(mm.PATH_LAUNCHES)
    attn_paths, attn_splits = dict(at.PATH_LAUNCHES), sum(at.SPLITS_LAUNCHED.values())
    stats = rt.shape_cache_stats()["per_family"]
    require(stats["attention"]["misses"] == len(problems) and stats["attention"]["hits"] == len(problems),
            f"attention shape cache {stats['attention']}")

    rows, worst = [], {"rel": 0.0, "abs": 0.0}
    while calls:
        (sq, skv, d), cfg, (q, k, v), got, route, splits = calls.pop(0)
        want = _plain_by_head(at, q, k, v).float()
        got = got.float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["bf16"] * scale,
                f"ops.attention at {(sq, skv, d)}: rel err {err / scale:.3g} > {ATTN_TOL['bf16']}")
        worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
        bound, bound_by = _attention_bound(sq, skv, d, heads, True)
        mask = causal_lower_right(sq, skv)
        row = {"problem": [sq, skv, d], "config": cfg.name(), "path": route, "splits": splits, "rel_err": err / scale,
               "ms": _time_ms(lambda i: at.attention_cuda(q, k, v, cfg), n_runs=10),
               "plain_ms": _time_ms(lambda i: _plain_by_head(at, q, k, v), n_warm=1, n_runs=3),
               "library_ms": _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask), n_runs=10),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        print(f"  {(sq, skv, d)}: {row['config']} (tree) on {route}, {splits} KV split(s), rel err "
              f"{row['rel_err']:.2g}; kernel {row['ms']:.4f} ms, "
              f"bound {bound:.4f} ({bound_by}), plain {row['plain_ms']:.3f}, SDPA {row['library_ms']:.4f}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    mm_rows = []
    for problem, cfg, a, b, got in mm_calls:
        want = mm.matmul_plain(a, b).float()
        scale = want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        require(err <= TOL[("bf16", "bf16")] * scale, f"ops.matmul at {problem}: rel err {err / scale:.3g}")
        mm_rows.append({"problem": list(problem), "config": cfg.name(), "rel_err": err / scale})
    print(f"  ops.matmul at the quickstart's shapes: {[(r['problem'], r['config']) for r in mm_rows]}")
    print(f"  attention launches {sum(launches['attention'].values())} "
          f"({ {n: c for n, c in launches['attention'].items() if c} }), by path {attn_paths}, {attn_splits} KV splits "
          f"in the split launches; shape cache {stats}")
    return {"rows": rows, "matmul": mm_rows, "worst": worst, "launches": launches, "paths": paths,
            "attention_paths": attn_paths, "attention_splits": attn_splits, "shape_cache": stats}


def phase_attention_timing(torch, at) -> list[dict]:
    """Every config at the served shapes of granite-8b (32 heads of 128) and
    hymba-1.5b (25 heads of 64): causal prefill S in {512, 2048, 4096} and a
    decode step at 4096 and 32768 cached tokens, bf16."""
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for arch, heads, d in (("granite-8b", 32, 128), ("hymba-1.5b", 25, 64)):
        for sq, skv in ((512, 512), (2048, 2048), (4096, 4096), (1, 4096), (1, 32768)):
            q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
            bound, bound_by = _attention_bound(sq, skv, d, heads, True)
            per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: at.attention_cuda(q, k, v, c))
                       for cfg in at.config_space()}
            call = _time_ms(lambda i: at.attention_cuda(q, k, v), queued=False)
            plain = _time_ms(lambda i: at.attention_plain(q, k, v), n_runs=5)
            mask = causal_lower_right(sq, skv)
            library = _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask))
            best = min(per_cfg, key=per_cfg.get)
            row = {"arch": arch, "shape": [1, heads, sq, skv, d], "ms": per_cfg[at.DEFAULT_ATTN_CONFIG.name()],
                   "best_config": best, "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain,
                   "library_ms": library, "bound_ms": bound, "bound_by": bound_by, "per_config_ms": per_cfg}
            rows.append(row)
            print(f"  {arch} (1, {heads}, {sq}, {skv}, {d}): default {row['ms']:.4f} ms, best {best} {per_cfg[best]:.4f}; "
                  f"bound {bound:.4f} ({bound_by}); one call from idle {call:.4f}; plain {plain:.3f}; "
                  f"SDPA {library:.4f}")
            del q, k, v
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _release(torch, serve: dict) -> None:
    for key in ("engine", "model", "params", "prompts"):
        serve.pop(key)
    torch.cuda.empty_cache()


CHAOS = "engine.prefill:compile_error,engine.decode:compile_error:1:5"
CHAOS_DISPATCH = ("dispatch.matmul:compile_error on a config the deployment serves that computes bitwise what the "
                  "default does")


def _incident_summary(rt) -> dict:
    out: dict[str, int] = {}
    for rec in rt.incidents():
        out[rec["action"]] = out.get(rec["action"], 0) + 1
    return out


def _rebuilt(engine, start: int = 0) -> list:
    """Builds from ``program_log[start:]`` of a (kind, size) built before: programs
    dropped (a retry, a swap, a rollback) and captured again."""
    seen = {(r.kind, r.size) for r in engine.program_log[:start]}
    out = []
    for r in engine.program_log[start:]:
        if (r.kind, r.size) in seen:
            out.append(r)
        seen.add((r.kind, r.size))
    return out


def _tree_pick(dep, family: str, problem: tuple, default, space):
    """The tuned tree's config for ``problem``, else (when the tree serves the
    default there) the first other compiled config: a fault needs a config the
    breaker can redirect from."""
    cfg = dep.select(family, problem)
    if cfg != default:
        return cfg, "tree"
    return next(c for c in space if c != default), "not the tree's (it serves the default here)"


def phase_guard(torch, mods: dict) -> dict:
    """21a: the guard on direct ops calls on the card."""
    from repro_torch.core import faults
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import QUARANTINE_BACKOFF, KernelRuntime
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import FixedPolicy

    mm, wk, ss = mods["matmul"], mods["wkv"], mods["ssm_scan"]
    dep = Deployment.load(DEPLOY_PATH)
    g = torch.Generator(device="cuda").manual_seed(21)
    out: dict = {}
    # The GEMM: the first served decode shape (batch 4) whose tree config is not the default.
    picks = [((1, k, n, 4), dep.select_matmul(1, k, n, 4)) for k, n in GRANITE_KN if (k, n) not in VOCAB_KN]
    problem, cfg = next(((p, c) for p, c in picks if c != mm.DEFAULT_CONFIG), picks[0])
    policy, why = dep, "tree"
    if cfg == mm.DEFAULT_CONFIG:  # the tree serves the default at every decode shape
        cfg = next(c for c in mm.config_space() if c != mm.DEFAULT_CONFIG)
        policy, why = FixedPolicy(matmul_config=cfg), "not the tree's (it serves the default there)"
    _, k, n, _ = problem
    x = torch.randn((4, 1, k), device="cuda", generator=g, dtype=torch.bfloat16)
    w = torch.randn((k, n), device="cuda", generator=g, dtype=torch.bfloat16)
    direct = mm.matmul_cuda(x.reshape(4, k), w, mm.DEFAULT_CONFIG).reshape(4, 1, n)
    rt = KernelRuntime(name="chip_smoke-guard")
    rt.install(policy)
    plan = faults.FaultPlan()
    plan.inject("dispatch.matmul", "compile_error", times=1, match=cfg.name())
    rt.set_fault_plan(plan)
    mm.reset_launches()
    with rt.activate():
        got = ops.matmul(x, w)
        require(torch.equal(got, direct), "the redirected GEMM is not bitwise equal to a direct DEFAULT_CONFIG launch")
        require([i["action"] for i in rt.incidents()] == ["quarantined"], f"incidents {rt.incidents()}")
        require(mm.LAUNCHES[cfg.name()] == 0 and mm.LAUNCHES[mm.DEFAULT_CONFIG.name()] == 1,
                f"launches {dict(mm.LAUNCHES)}")
        states = []
        for _ in range(QUARANTINE_BACKOFF):
            ops.matmul(x, w)
            states.append([e["state"] for e in rt.quarantined()] or ["closed"])
    torch.cuda.synchronize()
    require([i["action"] for i in rt.incidents()] == ["quarantined", "absolved"] and not rt.quarantined(),
            f"breaker did not re-probe and absolve: {rt.incidents()} {rt.quarantined()}")
    require(mm.LAUNCHES[cfg.name()] == 1 and mm.LAUNCHES[mm.DEFAULT_CONFIG.name()] == QUARANTINE_BACKOFF,
            f"after the cycle: {dict(mm.LAUNCHES)}")
    out["matmul"] = {"problem": problem, "config": cfg.name(), "picked_by": why, "redirect": mm.DEFAULT_CONFIG.name(),
                     "bitwise_equal_direct": True, "breaker_states": states, "incidents": _incident_summary(rt)}
    print(f"  ops.matmul at {problem}: dispatch.matmul:compile_error on {cfg.name()} ({why}) -> redirected to "
          f"{mm.DEFAULT_CONFIG.name()}, bitwise equal to a direct launch; quarantined, then {QUARANTINE_BACKOFF} "
          f"calls (states {states}): {QUARANTINE_BACKOFF - 1} redirected, 1 re-probe at {cfg.name()}, absolved")
    # NaN under output validation, on the eager path.
    rt2 = KernelRuntime(name="chip_smoke-nan")
    rt2.install(policy)
    plan2 = faults.FaultPlan()
    plan2.inject("dispatch.matmul", "nan", times=1, match=cfg.name())
    rt2.set_fault_plan(plan2)
    with rt2.activate():
        got = ops.matmul(x, w)
    require(bool(torch.isfinite(got).all()) and torch.equal(got, direct), "the NaN was served")
    require(rt2.incidents()[0]["error"].startswith("NonFiniteOutputError"), f"{rt2.incidents()}")
    out["nan"] = {"contained": True, "incident": rt2.incidents()[0]["error"]}
    print(f"  dispatch.matmul:nan on {cfg.name()}: caught by output validation, redirected, finite and equal")
    # WKV and the scan, at their served prefill shapes.
    r, kk, v = (torch.randn((1, 32, 64, 64), device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(3))
    logw = -torch.rand((1, 32, 64, 64), device="cuda", generator=g) * 4.99 - 1e-3
    u = torch.randn((64, 64), device="cuda", generator=g, dtype=torch.bfloat16)
    xs, dt = (torch.randn((1, 32, 1600), device="cuda", generator=g) for _ in range(2))
    dt = dt.abs() * 0.1
    a = -torch.rand((1600, 16), device="cuda", generator=g) - 0.1
    bs, cs = (torch.randn((1, 32, 16), device="cuda", generator=g) for _ in range(2))
    for fam, mod, default, field, call, direct_fn, prob in (
            ("wkv", wk, wk.DEFAULT_WKV_CONFIG, "wkv_config", lambda: ops.wkv(r, kk, v, logw, u),
             lambda c: wk.wkv_cuda(r, kk, v, logw, u, None, c), (32, 64)),
            ("ssm_scan", ss, ss.DEFAULT_SSM_CONFIG, "ssm_config", lambda: ops.ssm_scan_fused(xs, dt, a, bs, cs),
             lambda c: ss.ssm_cuda_fused(xs, dt, a, bs, cs, None, c), (32, 1600))):
        served, why = _tree_pick(dep, fam, prob, default, mod.config_space())
        rt3 = KernelRuntime(name=f"chip_smoke-{fam}")
        rt3.install(dep if why == "tree" else FixedPolicy(**{field: served}))
        rt3.set_fault_plan(faults.FaultPlan.parse(f"dispatch.{fam}:compile_error"))
        mod.reset_launches()
        with rt3.activate():
            got = call()
        want = direct_fn(default)
        require(all(torch.equal(gt, wt) for gt, wt in zip(got, want)),
                f"{fam}: the redirected call is not bitwise equal to a direct {default.name()} launch")
        require([(i["action"], i["config"]) for i in rt3.incidents()] == [("quarantined", served.name())],
                f"{fam}: {rt3.incidents()}")
        require(mod.LAUNCHES[served.name()] == 0 and mod.LAUNCHES[default.name()] == 2, f"{dict(mod.LAUNCHES)}")
        out[fam] = {"config": served.name(), "picked_by": why, "redirect": default.name(), "bitwise_equal_direct": True}
        print(f"  ops.{'wkv' if fam == 'wkv' else 'ssm_scan_fused'} at {prob}: dispatch.{fam}:compile_error on "
              f"{served.name()} ({why}) -> {default.name()}, bitwise equal to a direct launch")
    # A fault on the default config itself: nothing compiled is left.
    rt4 = KernelRuntime(name="chip_smoke-unrecoverable")
    rt4.install(FixedPolicy())
    rt4.set_fault_plan(faults.FaultPlan.parse("dispatch.matmul:compile_error"))
    try:
        with rt4.activate():
            ops.matmul(x, w)
        raised = None
    except faults.InjectedCompileError as e:
        raised = type(e).__name__
    require(raised and [i["action"] for i in rt4.incidents()] == ["unrecoverable"], f"{raised} {rt4.incidents()}")
    out["unrecoverable"] = {"raised": raised, "incident": "unrecoverable"}
    print(f"  a fault on {mm.DEFAULT_CONFIG.name()} itself: raised {raised}, incident 'unrecoverable'")
    # The guard's host cost per eager call: no plan, and a plan that is armed but never fires.
    never = faults.FaultPlan()
    never.inject("dispatch.matmul", "compile_error", times=None, match="never-a-config")

    def host_us(fn, calls=300, reps=9):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(times)

    rt5 = KernelRuntime(name="chip_smoke-cost")
    rt5.install(policy)
    x2 = x.reshape(4, k)
    with rt5.activate():
        cost = {"direct matmul_cuda": host_us(lambda: mm.matmul_cuda(x2, w, cfg)),
                "ops.matmul, no plan": host_us(lambda: ops.matmul(x, w))}
        rt5.set_output_validation(True)  # what an attached plan turns on: a host sync per call
        cost["ops.matmul, output validation only"] = host_us(lambda: ops.matmul(x, w))
        rt5.set_output_validation(False)
        rt5.set_fault_plan(never)
        cost["ops.matmul, armed plan that never fires (validation on)"] = host_us(lambda: ops.matmul(x, w))
    out["host_us_per_call"] = cost
    out["launches"] = {"matmul": mm.total_launches(), "wkv": wk.total_launches(), "ssm_scan": ss.total_launches()}
    print(f"  host µs per eager call ({problem}, {cfg.name()}, median of 9 x 300 calls): "
          + ", ".join(f"{name} {v:.2f}" for name, v in cost.items()))
    return out


def phase_engine_chaos(torch, mm, seq: dict, tuned: dict) -> dict:
    """21b: phase 19's batch drained under CHAOS on the tuned granite-8b (CUDA graphs)."""
    from repro_torch.core import faults
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import QUARANTINE_BACKOFF, KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    default = mm.DEFAULT_CONFIG.name()
    # The dispatch fault is keyed on a config the guard can redirect: the tree picks the
    # default at some shapes, and on the card a fault there has nothing compiled left. A
    # redirect runs the default config, so the drain's streams equal a clean drain's only where
    # the two configs compute bitwise the same sums (a config that rounds otherwise can flip a
    # near-tied greedy token; random bf16 operands decide, as phase 17's tree is measured anew
    # each run). Health is back to healthy only once the breaker has re-probed the config,
    # after QUARANTINE_BACKOFF more selections of it, and a graphed engine selects only while
    # it builds a program, once per problem in a scanned model: the fault is keyed on the
    # neutral non-default config a clean drain of the deployment selects most often, if that is
    # more than QUARANTINE_BACKOFF times (phase 19's log also holds its rebuilds after an
    # install, so its counts can exceed a drain's); else the config the clean drain selects
    # most often is replaced in the deployment by a compiled one that is neutral at its
    # problems, and the fault keyed on that.
    dep = Deployment.load(DEPLOY_PATH)
    served: dict[str, list] = {}  # name -> [config, problems, selections in phase 19's drains]
    for op, prob, cfg in tuned["engine"].runtime.selection_log():
        if op == "matmul" and cfg == dep.select_matmul(*prob):
            entry = served.setdefault(cfg.name(), [cfg, set(), 0])
            entry[1].add(prob)
            entry[2] += 1
    require(served, "phase 19 served no GEMM from the tree")
    g = torch.Generator(device="cuda").manual_seed(21)

    def neutral(cfg, problems) -> bool:
        for m, k, n, batch in sorted(problems):
            a = torch.randn(m * batch, k, device="cuda", generator=g).to(torch.bfloat16)
            w = (torch.randn(k, n, device="cuda", generator=g) * k ** -0.5).to(torch.bfloat16)
            od = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16
            if not torch.equal(mm.matmul_cuda(a, w, cfg, out_dtype=od), mm.matmul_cuda(a, w, out_dtype=od)):
                return False
        return True

    verdicts = {name: neutral(cfg, probs) for name, (cfg, probs, _) in served.items() if name != default}
    selections = {name: count for name, (_, _, count) in served.items()}
    print(f"  served non-default configs bitwise equal to {default} at every problem the tree served them: "
          f"{verdicts}; selections in phase 19 {selections}")
    # The streams the drain must give: a clean drain of the same deployment, which, where the
    # deployment is phase 19's, must also equal phase 19's.
    def clean_drain(dep) -> tuple[list, dict]:
        clean_rt = KernelRuntime(name="chip_smoke-chaos-clean")
        clean_rt.install(dep)
        clean_rt.set_selection_logging(True, cap=1 << 16)
        outputs = _drain(torch, ServingEngine(tuned["model"], tuned["params"], max_batch=4, cache_len=256,
                                              runtime=clean_rt), tuned["prompts"], mm, seq)["outputs"]
        counts: dict[str, int] = {}
        for op, _, cfg in clean_rt.selection_log():
            if op == "matmul":
                counts[cfg.name()] = counts.get(cfg.name(), 0) + 1
        return outputs, counts

    clean, counts = clean_drain(dep)
    require(clean == tuned["outputs"], "a clean drain of phase 19's deployment gives other streams than phase 19's")
    print(f"  selections in a clean drain {counts}")
    ready = [name for name, ok in verdicts.items() if ok and counts.get(name, 0) > QUARANTINE_BACKOFF]
    key = max(ready, key=counts.get, default=None)
    replaced = None
    if key is None:
        first, probs, _ = served[max(served, key=lambda name: counts.get(name, 0))]
        sub = next((c for c in mm.config_space() if c.name() != default and c.name() not in served
                    and neutral(c, probs)), None)
        require(sub is not None, f"no compiled config computes bitwise what {default} does at the problems the tree "
                f"served {first.name()}: no dispatch fault whose redirect leaves the streams unchanged")
        dep.configs = [sub if c == first else c for c in dep.configs]
        key, replaced = sub.name(), first.name()
        print(f"  none selected more than {QUARANTINE_BACKOFF} times: the deployment serves {key} where the tree "
              f"served {replaced}")
        clean, counts = clean_drain(dep)
    key_selections = counts.get(key, 0)
    require(key_selections > QUARANTINE_BACKOFF,
            f"a clean drain selects {key} {key_selections} times: too few for the breaker to re-probe it after "
            f"{QUARANTINE_BACKOFF}")
    rt = KernelRuntime(name="chip_smoke-chaos")
    rt.install(dep)
    plan = faults.FaultPlan.parse(CHAOS, seed=0)
    plan.inject("dispatch.matmul", "compile_error", times=1, match=key)
    rt.set_fault_plan(plan)
    engine = ServingEngine(tuned["model"], tuned["params"], max_batch=4, cache_len=256, runtime=rt)
    mm.reset_launches()
    for mod in seq.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(pr, max_new_tokens=16) for pr in tuned["prompts"]]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outputs = [list(t.request.output) for t in tickets]
    rebuilt = _rebuilt(engine)
    res = {
        "submitted": len(tickets), "completed": status.completed, "exhausted": status.exhausted,
        "retries": sum(t.request.retries for t in tickets), "incidents": _incident_summary(rt),
        "faults_fired": [(e.site, e.kind, e.key) for e in plan.events],
        "programs_built": len(engine.program_log), "programs_captured_again": [(r.kind, r.size) for r in rebuilt],
        "recapture_s": sum(r.seconds for r in rebuilt), "capture_s": sum(r.seconds for r in engine.program_log),
        "health_events": engine.health_events, "health": status.health, "wall_s": wall,
        "fault_key": key, "fault_key_selections_clean": key_selections, "replaced": replaced,
        "streams_equal_clean": outputs == clean,
        "streams_equal_phase_19": outputs == tuned["outputs"],
        "launches": {"matmul": mm.total_launches()} | {_FAMILY[k]: mod.total_launches() for k, mod in seq.items()},
    }
    require(status.completed == len(tickets) and not status.exhausted, f"requests dropped under chaos: {status}")
    require(res["incidents"].get("retry") == 2, f"want 2 engine retries, got {res['incidents']}")
    require(("dispatch.matmul", "compile_error", key) in res["faults_fired"]
            and res["incidents"].get("quarantined") == 1 and res["incidents"].get("absolved") == 1,
            f"the dispatch fault on {key} did not fire once, redirect and get absolved on a re-probe: "
            f"{res['faults_fired']} / {res['incidents']}")
    require(rebuilt, "no program was dropped and captured again")
    require(status.health == "healthy" and engine.health_events and engine.health_events[-1][1] == "healthy",
            f"health did not end healthy: {engine.health_events} / {status.health}")
    require(res["streams_equal_clean"], "the greedy streams under chaos differ from a clean drain's")
    print(f"  {CHAOS} + dispatch.matmul:compile_error on {key} ({key_selections} selections in a clean drain): "
          f"{status.completed}/{len(tickets)} completed, {res['retries']} request retries, incidents "
          f"{res['incidents']}, faults {res['faults_fired']}")
    print(f"  programs captured again: {res['programs_captured_again']} in {res['recapture_s']:.3f}s (all captures "
          f"{res['capture_s']:.3f}s); health {engine.health_events}; streams equal the clean drain's: True "
          f"(phase 19's: {res['streams_equal_phase_19']})")
    return res


def phase_retune_on_card(torch, mm, at, seq: dict, tuned: dict) -> dict:
    """21c: on the tuned granite-8b served from phase 17's bundle, an adoption at a
    step boundary, then drift -> retune on measured tables -> canary on the card ->
    hot swap, a rejected candidate, and a rollback."""
    from repro_torch.core import faults, retune
    from repro_torch.core.bundle import DeploymentBundle
    from repro_torch.core.gpubench import build_gpu_dataset
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    measured: list[float] = []

    def gpu_table(problems, device):
        ds, sec = build_gpu_dataset("matmul", problems)
        measured.append(sec)
        return ds

    rt = KernelRuntime(name="chip_smoke-retune")
    # Served from phase 17's fleet bundle, as launch.serve --bundle serves: the card's entry.
    engine = ServingEngine(tuned["model"], tuned["params"], max_batch=4, cache_len=256, runtime=rt,
                           bundle=BUNDLE_PATH, retune_min_events=16, retune_dataset_builder=gpu_table)
    dep = engine.deployment
    rt.set_selection_logging(True, cap=1 << 16)
    prompts = tuned["prompts"]
    mm.reset_launches()
    at.reset_launches()
    _drain(torch, engine, prompts, mm, seq)
    before = _drain(torch, engine, prompts, mm, seq)
    # Adoption of phase 17's bundle entry for this card, loaded again (the incumbent's own
    # tune, so the canary passes), at a step boundary.
    offered = DeploymentBundle.load(BUNDLE_PATH).deployments[engine.device]
    built_a = len(engine.program_log)
    engine.submit(prompts[0], max_new_tokens=16)
    engine.step()
    step0 = engine.steps
    engine.offer_deployment(offered)
    engine.drain()
    ev = engine.retune_events[0]
    require(ev.source == "control-plane" and ev.swapped and ev.step == step0 and engine.deployment is offered,
            f"adoption: {ev}; incidents {rt.incidents()[-2:]}")
    adopt_recaptured = [r for r in engine.program_log[built_a:] if r.epoch >= ev.epoch]
    require(adopt_recaptured, "the adoption did not capture the programs again")
    adopt = dataclasses.asdict(ev)
    print(f"  offer_deployment(phase 17's {engine.device} bundle entry): adopted at step {ev.step} (the boundary after "
          f"step {step0 - 1}), epoch {ev.epoch}, canaried {ev.families}; its drain captured "
          f"{[(r.kind, r.size) for r in adopt_recaptured]} again")
    # Drift: the served buckets are not in the harvest; the check runs every 4 steps.
    n_ev = len(engine.retune_events)
    epoch0, built0 = rt.policy_epoch(), len(engine.program_log)
    engine.retune_interval = 4
    during = _drain(torch, engine, prompts, mm, seq)  # the first drift check swaps
    engine.retune_interval = None
    swaps = [e for e in engine.retune_events[n_ev:] if e.swapped]
    require(swaps and swaps[0].families == ("matmul",),
            f"no matmul retune swapped in: {engine.retune_events[n_ev:]}; incidents {rt.incidents()[-2:]}")
    epoch1 = rt.policy_epoch()
    after = _drain(torch, engine, prompts, mm, seq)
    # Every build after the swap captures a program the swap dropped.
    recaptured = [r for r in engine.program_log[built0:] if r.epoch >= epoch1]
    require(recaptured, f"programs not captured again after the swap: {engine.program_log[built0:]}")
    adopt["programs_captured_again"] = [(r.kind, r.size) for r in engine.program_log[built_a:]
                                        if adopt["epoch"] <= r.epoch < epoch1]
    res = {"adopt": adopt, "events": [dataclasses.asdict(e) for e in engine.retune_events[n_ev:]],
           "seconds": engine.retune_seconds,
           "measure_s": measured, "epoch_before": epoch0, "epoch_after": epoch1,
           "programs_captured_again": [(r.kind, r.size) for r in recaptured],
           "recapture_s": sum(r.seconds for r in recaptured),
           "warm_decode_median_ms_before": before["decode_median_ms"],
           "warm_decode_median_ms_after": after["decode_median_ms"],
           "streams_equal_phase_19": [during["outputs"], after["outputs"]] == [tuned["outputs"]] * 2,
           "new_configs": [c.name() for c in engine.deployment.configs]}
    print(f"  retune events: {[(e.step, round(e.drift_score, 4), e.swapped, e.families) for e in engine.retune_events[n_ev:]]}")
    print(f"  swap: epoch {epoch0} -> {epoch1}; seconds {engine.retune_seconds} (gpubench tables {measured}); "
          f"{len(recaptured)} programs captured again (this drain and the next) in {res['recapture_s']:.3f}s; "
          f"deployed {res['new_configs']}")
    print(f"  warm decode median {before['decode_median_ms']:.3f} ms before, {after['decode_median_ms']:.3f} after; "
          f"zero drops; streams equal phase 19's: {res['streams_equal_phase_19']}")
    # The canary's attention probe on the card (granite-8b's traffic calls no ops.attention).
    ok, why = retune._numeric_agreement("attention", dep.select_attention(1, 4096, 128), rt, device="cuda")
    require(ok, f"attention canary probe: {why}")
    # A NaN-poisoned candidate: rejected, never installed.
    incumbent = engine.deployment
    rt.set_fault_plan(faults.FaultPlan.parse("canary.matmul:nan:-1"))
    ev = engine.maybe_retune(force=True)
    rt.set_fault_plan(None)
    require(ev is not None and not ev.swapped and "matmul" in ev.rejected and rt.policy() is incumbent,
            f"a NaN-poisoned candidate was not rejected: {ev}")
    res["rejected"] = dataclasses.asdict(ev) | {"reason": rt.incidents()[-1]["error"]}
    print(f"  canary.matmul:nan candidate: rejected {ev.rejected} ({res['rejected']['reason']}), incumbent kept "
          f"(epoch {rt.policy_epoch()})")
    # A forced swap (its canary off: the H100 model may score a second retune of the same
    # traffic below the first), then rollback_threshold injected incidents roll it back.
    engine.canary = False
    ev = engine.maybe_retune(force=True)
    engine.canary = True
    require(ev is not None and ev.swapped, f"forced retune did not swap: {ev}")
    epoch2, built2 = rt.policy_epoch(), len(engine.program_log)
    rt.set_fault_plan(faults.FaultPlan.parse(f"engine.decode:oom:{engine.rollback_threshold}"))
    tickets = [engine.submit(pr, max_new_tokens=16) for pr in prompts]
    status = engine.drain()
    rt.set_fault_plan(None)
    rolled = [e for e in engine.retune_events if e.rolled_back]
    require(len(rolled) == 1 and engine.deployment is incumbent and status.completed == len(tickets),
            f"no rollback: {engine.retune_events[-2:]} {status}")
    rb_recaptured = _rebuilt(engine, built2)
    require(rt.policy_epoch() > epoch2 and rb_recaptured, "the rollback did not move the epoch and capture again")
    res["rollback"] = {"event": dataclasses.asdict(rolled[0]), "epoch": [epoch2, rt.policy_epoch()],
                       "programs_captured_again": [(r.kind, r.size) for r in rb_recaptured],
                       "streams_equal_phase_19": [list(t.request.output) for t in tickets] == tuned["outputs"]}
    print(f"  forced swap (canary off) then {engine.rollback_threshold} injected engine.decode faults: rolled back at step "
          f"{rolled[0].step}, epoch {epoch2} -> {rt.policy_epoch()}, {len(rb_recaptured)} programs captured again; "
          f"{status.completed}/{len(tickets)} completed")
    res["launches"] = {"matmul": mm.total_launches(), "attention": at.total_launches()}
    return res


def phase_online(torch, mm, rows: list) -> dict:
    """21d: OnlinePolicy with the CUDA-event measurer on direct ops.matmul calls at
    granite-8b's served decode shapes."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.online import OnlinePolicy, cuda_event_measure, shape_bucket
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels import ops

    pol = OnlinePolicy(cuda_event_measure(), mm.config_space(), prior=Deployment.load(DEPLOY_PATH))
    rt = KernelRuntime(name="chip_smoke-online")
    rt.install(pol)
    g = torch.Generator(device="cuda").manual_seed(4)
    mm.reset_launches()
    shapes = [(k, n) for k, n in GRANITE_KN]
    with rt.activate():
        for k, n in shapes:
            x = torch.randn((4, 1, k), device="cuda", generator=g, dtype=torch.bfloat16)
            w = torch.randn((k, n), device="cuda", generator=g, dtype=torch.bfloat16)
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else None
            for _ in range(len(mm.config_space()) + 1):
                ops.matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    committed = {str(b): c.name() for b, c in pol.committed().items()}
    best = {shape_bucket((1, r["k"], r["n"], 4)): r["best_config"] for r in rows if r["m"] == 4}
    agree = sum(pol.committed().get(b) is not None and pol.committed()[b].name() == name for b, name in best.items())
    require(len(committed) == len(shapes), f"not every shape committed: {committed}")
    res = {"warmup_cost_s": pol.warmup_cost(), "committed": committed, "stats": dict(pol.stats),
           "phase_7_best": {str(b): c for b, c in best.items()}, "commits_equal_phase_7_best": agree,
           "launches": {"matmul": mm.total_launches()}}
    print(f"  warm-up cost {pol.warmup_cost() * 1e3:.3f} ms over {pol.stats['explore']} measured arms; commits "
          f"{committed}; {agree} of {len(best)} equal phase 7's per-shape best")
    return res


# ---------------------------------------------------------------------------
# phase 22: the paged serving tier on the card
# ---------------------------------------------------------------------------
# 22a's engine: n_blocks small enough that the pool runs dry while the lanes decode (a CPU
# rehearsal at these token counts preempts twice with 18 blocks and never with 20).
PAGED = dict(max_batch=4, cache_len=256, block_size=16, prefill_chunk_tokens=32, n_blocks=18)
SYSTEM_LEN = 64  # a system prompt of 4 full blocks
PAGED_TAILS = (8, 40, 17, 29, 12, 35, 23, 31)  # distinct tails of 8-40 tokens
PAGED_NEW = 24


def _paged_prompts(cfg, seed: int = 22):
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, SYSTEM_LEN)
    return [np.concatenate([system, rng.integers(0, cfg.vocab, n)]).astype(np.int32) for n in PAGED_TAILS]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _pool_bytes(pool) -> int:
    """Bytes a pool's storage holds: its blocks, the scratch block and the lane rows."""
    return sum(t.numel() * t.element_size() for t in pool._store.values())


def _paged_traffic(torch, engine, prompts, new: int = PAGED_NEW, targets: dict | None = None) -> dict:
    """22a's traffic through ``engine``: prompt 0 alone for two steps (its chunks index the
    system prompt's blocks), prompts 1-5, then, after decode step 4, prompts 6-7 at priority
    2; stepped until drained. Per forward (on_prefill / on_decode, after a synchronize): kind,
    size, ms since the previous one, programs built meanwhile. Per request: the decode step
    and host ms (after the step's synchronize, from its submission) of its first token."""
    events, mark = [], {"built": len(engine.program_log)}
    targets = targets or {}

    def hook(kind):
        def record(size):
            torch.cuda.synchronize()
            now, built = time.perf_counter(), len(engine.program_log)
            events.append((kind, size, (now - mark["t"]) * 1e3, built - mark["built"]))
            mark.update(t=now, built=built)
        return record

    engine.on_prefill, engine.on_decode = hook("prefill"), hook("decode")
    tickets, submitted, first = [], [], {}

    def submit(i, priority=0):
        tickets.append(engine.submit(prompts[i], max_new_tokens=new, priority=priority,
                                     latency_target_ms=targets.get(i)))
        submitted.append(time.perf_counter())

    def step():
        progressed = engine.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        for i, t in enumerate(tickets):
            if i not in first and t.request.output:
                first[i] = (engine.steps, round((now - submitted[i]) * 1e3, 3))
        return progressed

    torch.cuda.synchronize()
    mark["t"] = t0 = time.perf_counter()
    submit(0)
    step()
    step()
    for i in range(1, min(6, len(prompts))):
        submit(i)
    while engine.steps < 4 and engine.pending():
        step()
    for i in range(6, len(prompts)):
        submit(i, priority=2)
    while engine.pending():
        if not step():
            break
    wall = time.perf_counter() - t0
    status = engine.drain()
    engine.on_prefill = engine.on_decode = None
    warm = [ms for kind, _, ms, built in events if kind == "decode" and not built]
    return {"status": status, "outputs": [list(t.request.output) for t in tickets],
            "requests": [t.request for t in tickets], "first_token": [first.get(i) for i in range(len(tickets))],
            "events": events, "wall_s": wall, "steps": engine.steps,
            "warm_decode_median_ms": statistics.median(warm) if warm else None, "warm_decode_steps": len(warm)}


def _status_dict(status) -> dict:
    return dataclasses.asdict(status) | {"prefix_hit_rate": status.prefix_hit_rate}


def _gather_scatter_bytes(pool, width: int) -> int:
    """Bytes one decode step's gather and scatter move, from shapes: the gather reads the
    width's blocks (``cache_len`` tokens a lane, every paged leaf) and writes the view, the
    scatter reads the view and writes the blocks."""
    per_token = sum(pool._store[key].numel() * pool._store[key].element_size()
                    for key, spec in pool.specs.items() if spec.kind == "paged") / (
        (pool.n_blocks + 1) * pool.block_size)
    return int(4 * width * pool.cache_len * per_token)


def _engine(model, params, policy, name: str, **kw):
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    rt = KernelRuntime(name=name)
    rt.install(policy)
    rt.set_selection_logging(True, cap=1 << 16)
    return ServingEngine(model, params, runtime=rt, **kw)


def phase_paged(torch, mm, model, params, policy) -> dict:
    """22a: full-width granite-8b (bf16) on the paged, prefix-shared, chunked engine under
    CUDA graphs; the eager engine and a dense engine over the same traffic."""
    cfg = model.cfg
    prompts = _paged_prompts(cfg)
    engine = _engine(model, params, policy, "chip_smoke-paged", **PAGED)
    require(engine.cuda_graphs and engine._streaming and engine._sharing, "22a's engine is not streaming on graphs")
    torch.cuda.synchronize()
    mm.reset_launches()
    run = _paged_traffic(torch, engine, prompts)
    launches = mm.total_launches()
    st = run["status"]
    require(st.completed == len(prompts) and not st.exhausted and all(len(o) == PAGED_NEW for o in run["outputs"]),
            f"22a: not every request completed: {st}")
    require(st.preempted >= 1, f"22a: the pool never ran dry: {st}")
    require(st.prefix_hits >= 6, f"22a: {st.prefix_hits} prefix hits of {st.prefix_lookups} lookups, want >= 6")
    built = engine.program_log
    require(all(r.captured for r in built), f"22a: a program was not captured: {built}")
    chunks = [(r.size, round(r.seconds, 3)) for r in built if r.kind == "chunk"]
    require(chunks and launches > 0, f"22a: no chunk program ({built}) or no GEMM launch ({launches})")
    graphed_pool = {k: t.clone() for k, t in engine.pool._store.items()}

    eager = _engine(model, params, policy, "chip_smoke-paged-eager", cuda_graphs=False, **PAGED)
    erun = _paged_traffic(torch, eager, prompts)
    require(erun["outputs"] == run["outputs"], "22a: the eager engine's streams differ from the graphed one's")
    require(_status_dict(erun["status"]) == _status_dict(st),
            f"22a: EngineStatus graphed {st} against eager {erun['status']}")
    pool_equal = all(torch.equal(graphed_pool[k], t) for k, t in eager.pool._store.items())
    require(pool_equal, "22a: the pool after the graphed drain differs from the eager drain's (bitwise)")
    del eager

    dense = _engine(model, params, policy, "chip_smoke-dense", max_batch=4, cache_len=256)
    drun = _paged_traffic(torch, dense, prompts)
    require(drun["status"].completed == len(prompts), f"22a dense: {drun['status']}")
    res = {
        "engine": engine, "prompts": prompts, "dense_outputs": drun["outputs"],
        "status": _status_dict(st), "steps": run["steps"], "wall_s": run["wall_s"],
        "prefill_tokens_skipped": engine._prefix_reused_tokens,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "preemptions": [r.preemptions for r in run["requests"]],
        "first_token_step_ms": run["first_token"], "dense_first_token_step_ms": drun["first_token"],
        "warm_decode_median_ms": run["warm_decode_median_ms"], "eager_warm_decode_median_ms":
            erun["warm_decode_median_ms"], "dense_warm_decode_median_ms": drun["warm_decode_median_ms"],
        "chunk_programs_s": chunks, "programs": [dataclasses.asdict(r) for r in built],
        "pool_bytes": _pool_bytes(engine.pool), "dense_pool_bytes": _pool_bytes(dense.pool),
        "gather_scatter_bytes_per_step": {w: _gather_scatter_bytes(engine.pool, w) for w in engine._width_buckets},
        "dense_gather_scatter_bytes_per_step": {w: _gather_scatter_bytes(dense.pool, w)
                                                for w in dense._width_buckets},
        "gemm_launches": launches, "eager_equal": True, "pool_bitwise_equal_eager": pool_equal,
        "streams_equal_dense": sum(a == b for a, b in zip(run["outputs"], drun["outputs"])),
    }
    del dense
    print(f"  granite-8b full width, bf16, paged: {PAGED}; 8 requests (a {SYSTEM_LEN}-token system prompt, tails "
          f"{PAGED_TAILS}, {PAGED_NEW} new tokens; the last two after decode step 4 at priority 2)")
    print(f"  {st.completed} completed in {run['steps']} decode steps, {run['wall_s']:.3f}s; preempted "
          f"{st.preempted} ({res['preemptions']}); prefix hits {st.prefix_hits} / {st.prefix_lookups} lookups; "
          f"{res['prefill_tokens_skipped']} of {res['prompt_tokens']} prompt tokens skipped by aliasing")
    print(f"  first token (decode step, ms from submit): {run['first_token']} (dense engine: {drun['first_token']})")
    print(f"  warm decode step median: paged {run['warm_decode_median_ms']:.3f} ms, eager paged "
          f"{erun['warm_decode_median_ms']:.3f} ms, dense {drun['warm_decode_median_ms']:.3f} ms")
    print(f"  chunk programs captured (width, s): {chunks}; programs {[(r.kind, r.size) for r in built]}")
    print(f"  pool bytes: paged {res['pool_bytes'] / 1e6:.1f} MB ({engine.pool.n_blocks} blocks + scratch) against "
          f"dense {res['dense_pool_bytes'] / 1e6:.1f} MB; gather + scatter a decode step (from shapes, by width): "
          f"{ {w: f'{b / 1e6:.1f} MB' for w, b in res['gather_scatter_bytes_per_step'].items()} }")
    print(f"  eager engine: equal streams, equal EngineStatus, pool bitwise equal after the drain; GEMM launches "
          f"{launches}; streams equal to the dense engine's (left-padded prefill): "
          f"{res['streams_equal_dense']} of {len(prompts)}")
    return res


def phase_paged_cpu_vs_card(torch) -> dict:
    """22b: an 8-layer full-width granite-8b in f32, the same weights on the card and the CPU."""
    from repro_torch.configs import registry
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(registry.get("granite-8b"), n_layers=8)
    cpu_model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    cpu_params = cpu_model.init(torch.Generator(device="cpu").manual_seed(0))
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    params = _to(cpu_params, "cuda")
    prompts = _paged_prompts(cfg, seed=23)[:3]
    base = dict(max_batch=2, cache_len=256, block_size=16)
    variants = {"chunk 32": dict(prefill_chunk_tokens=32), "chunk 128": dict(prefill_chunk_tokens=128),
                "sharing off": dict(prefill_chunk_tokens=32, prefix_sharing=False)}
    streams, hits = {}, {}
    for name, kw in variants.items():
        eng = _engine(model, params, FixedPolicy(), f"chip_smoke-22b[{name}]", **base, **kw)
        run = _paged_traffic(torch, eng, prompts, new=6)
        streams[name], hits[name] = run["outputs"], run["status"].prefix_hits
    cpu_eng = _engine(cpu_model, cpu_params, FixedPolicy(), "chip_smoke-22b[cpu]", **base, prefill_chunk_tokens=32)
    cpu_run = _paged_traffic(torch, cpu_eng, prompts, new=6)
    del cpu_eng
    for name, s in streams.items():
        if s != streams["chunk 32"]:
            print(f"  {name}: {s}\n  chunk 32: {streams['chunk 32']}")
    require(all(s == streams["chunk 32"] for s in streams.values()), "22b: streams differ between chunk widths")
    if cpu_run["outputs"] != streams["chunk 32"]:
        print(f"  cuda {streams['chunk 32']}\n  cpu  {cpu_run['outputs']}")
    require(cpu_run["outputs"] == streams["chunk 32"], "22b: greedy streams differ between the CPU and the card")
    res = {"streams": streams["chunk 32"], "prefix_hits": hits, "cpu_prefix_hits": cpu_run["status"].prefix_hits,
           "cpu_s": cpu_run["wall_s"]}

    # A chunk program captured with its inputs at zero (start 0), replayed at start 0 and 32,
    # against eager prefill_chunk calls at 0 and 32 on a cache of its own.
    eng = _engine(model, params, FixedPolicy(), "chip_smoke-22b[capture]", **base, prefill_chunk_tokens=32)
    eng.pool.ensure(0, 256)
    prog = eng._chunk_fn(32)
    require(isinstance(prog.graph, torch.cuda.CUDAGraph), "22b: the chunk program was not captured")
    blocks, lanes = eng.pool.row_ids([0])
    ref = model.init_cache(1, 256)
    errs = []
    for start in (0, 32):
        chunk = prompts[0][start:start + 32].astype("int64")[None]
        prog.stage(tokens=chunk, start=start, last_row=31, blocks=blocks, lanes=lanes)
        got = prog.run(eng.runtime)["logits"].clone()
        with eng.runtime.activate():
            want, ref = model.prefill_chunk(params, ref, torch.from_numpy(chunk).cuda(),
                                            torch.tensor(start, device="cuda"), torch.tensor(31, device="cuda"))
        errs.append(float((got - want).abs().max() / want.abs().max()))
    view = eng.pool.gather([0])
    cache_err = max(float((view[k][:, :, :64] - ref[k][:, :, :64]).abs().max()) for k in ("k", "v"))
    require(max(errs) <= 1e-5 and cache_err <= 1e-5,
            f"22b: the chunk program captured at start 0 against eager calls: logits {errs}, cache {cache_err}")
    res |= {"capture_replay_rel_err": errs, "capture_replay_cache_err": cache_err}
    print(f"  granite-8b at 8 layers, full width, f32, {base}: 3 prompts ({SYSTEM_LEN}-token system prompt), 6 new "
          f"tokens: equal greedy streams at chunk 32, chunk 128 and sharing off (prefix hits {hits}); the CPU's "
          f"equal to the card's ({res['cpu_s']:.1f}s on the CPU, prefix hits {res['cpu_prefix_hits']})")
    print(f"  a chunk program captured at start 0, replayed at starts 0 and 32, against eager calls: logits "
          f"rel err {errs}, cache abs err {cache_err:.2e}")
    return res


def _live_pins(engine) -> dict:
    """(family, problem) -> config name over the engine's live programs' pins."""
    out = {}
    for cache in (engine._prefill_cache, engine._chunk_cache, engine._decode_cache):
        for prog in cache.values():
            for family, problem, cfg in prog.pins.entries:
                out[(family, tuple(problem))] = cfg.name() if hasattr(cfg, "name") else str(cfg)
    return out


def phase_slo(torch, paged: dict) -> dict:
    """22c: SLO mode on 22a's engine (the tuned Deployment, whose select_for_objective
    ranks its configs on the H100 model): two requests targeted at 0.5x 22a's warm decode
    median, then one at 3x it behind an untargeted long prompt."""
    engine, prompts = paged["engine"], paged["prompts"]
    median = paged["warm_decode_median_ms"]
    rt = engine.runtime
    before = _live_pins(engine)
    n_events, n_built, epoch0 = len(engine.slo_events), len(engine.program_log), rt.policy_epoch()
    steps, slo_pins = [], {}
    rounds = ({1: 0.5 * median, 3: 0.5 * median}, {1: 3.0 * median})
    for targets in rounds:
        mark = {"built": len(engine.program_log)}
        tickets = [engine.submit(p, max_new_tokens=PAGED_NEW, latency_target_ms=targets.get(i))
                   for i, p in enumerate(prompts[:4])]
        while engine.pending():
            t0 = time.perf_counter()
            progressed = engine.step()
            torch.cuda.synchronize()
            built = engine.program_log[mark["built"]:]
            mark["built"] = len(engine.program_log)
            steps.append({"step": engine.steps, "ms": round((time.perf_counter() - t0) * 1e3, 3),
                          "slo": engine._slo_mode, "cap": engine._slo_cap, "chunk_cap": engine._chunk_cap(),
                          "built": [(r.kind, r.size, round(r.seconds, 3)) for r in built]})
            if engine._slo_mode:
                slo_pins.update(_live_pins(engine))
            if not progressed:
                break
        status = engine.drain()
        require(status.completed == len(tickets) and not status.exhausted, f"22c: {status}")
    events = engine.slo_events[n_events:]
    kinds = [kind for _, kind, _ in events]
    require("enter" in kinds and "exit" in kinds, f"22c: SLO mode did not enter and leave: {events}")
    rebuilt = [r for r in engine.program_log[n_built:] if r.epoch > epoch0]
    require(rebuilt and all(r.captured for r in rebuilt), "22c: no program captured again under the objective")
    require(rt.objective() is None, f"22c: an objective is left installed: {rt.objective()}")
    changed = {f"{fam} {problem}": (before[(fam, problem)], cfg) for (fam, problem), cfg in slo_pins.items()
               if (fam, problem) in before and before[(fam, problem)] != cfg}
    transitions = [s for s in steps if s["built"]]
    res = {"decode_median_ms": median, "targets_ms": [sorted(r.values()) for r in rounds], "slo_events": events,
           "caps": sorted({(s["cap"], s["chunk_cap"]) for s in steps if s["slo"]}, key=str),
           "configs_changed_by_objective": changed, "selections_under_objective": len(slo_pins),
           "programs_recaptured": [(r.kind, r.size, round(r.seconds, 3), r.epoch) for r in rebuilt],
           "recapture_s": sum(r.seconds for r in rebuilt), "transition_steps": transitions, "steps": steps}
    print(f"  targets {res['targets_ms']} ms against a warm decode median of {median:.3f} ms; slo_events {events}")
    print(f"  in SLO mode (admission cap, chunk cap): {res['caps']}; {len(rebuilt)} programs captured again under "
          f"the objective or after it, {res['recapture_s']:.3f}s: {res['programs_recaptured']}")
    print(f"  steps that built programs (ms): {[(s['step'], s['ms'], s['built']) for s in transitions]}")
    print(f"  configs the objective changed ({len(changed)} of {len(slo_pins)} selections): {changed}")
    return res


def phase_int8(torch, paged: dict, model, params, policy) -> dict:
    """22d: granite-8b with an int8 KV cache, full width, paged (the legacy admission:
    chunked prefill refuses int8 caches)."""
    from repro_torch.models.layers import quantize_kv
    from repro_torch.models.model import build_model

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((4, 256, 8, 128), generator=g, device="cuda").to(torch.bfloat16)
    q, s = quantize_kv(x)
    back_err = float(((q.float() * s[..., None] - x.float()).abs() / (s[..., None] * 0.5 + 1e-6)).max())
    # The CPU's values beside them: torch divides by a Python scalar on the card through its
    # reciprocal, so a scale may differ in its last bit and a value by one step.
    qc, sc = quantize_kv(x.cpu())
    q_diff = int((q.cpu().int() - qc.int()).abs().max())
    q_equal = float((q.cpu() == qc).float().mean())
    s_rel = float(((s.cpu() - sc).abs() / sc).max())
    require(back_err <= 1.0 and q_diff <= 1 and s_rel <= 1e-6,
            f"22d: quantize_kv on the card: round trip err/bound {back_err}, values off the CPU's by {q_diff}, "
            f"scales by {s_rel}")
    model8 = build_model(model.cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda", kv_quant=True)
    kw = dict(max_batch=4, cache_len=256, block_size=16)
    engine = _engine(model8, params, policy, "chip_smoke-int8", **kw)
    require(not engine._streaming, "22d: an int8 cache must take the legacy admission")
    run = _paged_traffic(torch, engine, paged["prompts"])
    require(run["status"].completed == len(paged["prompts"]), f"22d: {run['status']}")
    dense = paged["dense_outputs"]
    same = sum(a == b for o8, o in zip(run["outputs"], dense) for a, b in zip(o8, o))
    total = sum(len(o) for o in dense)
    prefix = [next((i for i, (a, b) in enumerate(zip(o8, o)) if a != b), len(o))
              for o8, o in zip(run["outputs"], dense)]
    bf16 = _pool_bytes(_engine(model, params, policy, "chip_smoke-bf16-pool", **kw).pool)
    int8 = _pool_bytes(engine.pool)
    res = {"quantize_kv_equal_cpu_share": q_equal, "quantize_kv_max_step_off_cpu": q_diff,
           "quantize_kv_scale_rel_off_cpu": s_rel, "roundtrip_err_over_half_step": back_err,
           "token_agreement": same / total, "tokens_before_divergence": prefix,
           "warm_decode_median_ms": run["warm_decode_median_ms"],
           "dense_bf16_warm_decode_median_ms": paged["dense_warm_decode_median_ms"],
           "pool_bytes": int8, "bf16_pool_bytes": bf16, "pool_ratio": int8 / bf16,
           "status": _status_dict(run["status"])}
    print(f"  quantize_kv on the card: round trip within {back_err:.5f} of half a step; {q_equal:.6f} of the int8 "
          f"values equal the CPU's (the rest one step off), scales within {s_rel:.2e} relative")
    print(f"  int8 cache, paged {kw}: {same} of {total} tokens agree with the bf16 dense engine's "
          f"({res['token_agreement']:.3f}; equal for the first {prefix} tokens); warm decode median "
          f"{run['warm_decode_median_ms']:.3f} ms (bf16 dense {paged['dense_warm_decode_median_ms']:.3f}); pool "
          f"{res['pool_bytes'] / 1e6:.1f} MB against {bf16 / 1e6:.1f} MB in bf16 ({res['pool_ratio']:.3f}x)")
    return res


def phase_router(torch, paged: dict, model, params, policy, card: str) -> dict:
    """22e: two engines on the card, each on its own runtime, over one set of weights,
    behind a Router; then the fleet bundle's router for the card's entry."""
    import numpy as np

    from repro_torch.core.bundle import DeploymentBundle
    from repro_torch.serve.router import Router

    prompts = paged["prompts"]
    kw = dict(max_batch=2, cache_len=256, block_size=16, prefill_chunk_tokens=32)
    ea = _engine(model, params, policy, "chip_smoke-router[a]", **kw)
    eb = _engine(model, params, policy, "chip_smoke-router[b]", **kw)
    router = Router({"card-a": ea, "card-b": eb}, name="chip_smoke")
    tickets = [router.submit(prompts[0], max_new_tokens=8)]
    require(tickets[0].request.routed_to == "card-a", "22e: the first request should go to card-a (name)")
    router.drain()
    rng = np.random.default_rng(24)
    other = [rng.integers(0, model.cfg.vocab, 40).astype(np.int32) for _ in range(3)]
    tickets.append(ea.submit(other[0], max_new_tokens=8))  # card-a now carries more load
    require(router.dispatch() == "card-b", "22e: load should pick card-b")
    affinity = router.dispatch(prompt=prompts[1])
    require(affinity == "card-a", f"22e: a shared-prompt request went to {affinity}, not the engine caching it")
    tickets += [router.submit(p, max_new_tokens=8) for p in (prompts[1], prompts[2])]
    tickets += [router.submit(p, max_new_tokens=8) for p in other[1:]]
    ea._slo_mode = True  # as the reference's router tests press an engine
    avoided = router.dispatch(latency_target_ms=5.0, prompt=prompts[3])
    tickets.append(router.submit(prompts[3], max_new_tokens=8, latency_target_ms=1e9))
    ea._slo_mode = False
    require(avoided == "card-b" and tickets[-1].request.routed_to == "card-b",
            f"22e: a targeted request went to the engine in SLO mode ({avoided})")
    routes = [t.request.routed_to for t in tickets]
    require({"card-a", "card-b"} <= set(r for r in routes if r), f"22e: one engine took all traffic: {routes}")
    agg = router.drain()
    done = sum(t.done for t in tickets)
    per = [ea.status(), eb.status()]
    require(all(t.done for t in tickets), "22e: a request did not complete")
    require((agg.prefix_hits, agg.prefix_lookups, agg.shared_blocks, agg.steps) == (
        sum(s.prefix_hits for s in per), sum(s.prefix_lookups for s in per), sum(s.shared_blocks for s in per),
        max(ea.steps, eb.steps)), f"22e: aggregate {agg} against {per}")
    require(agg.completed == done - 1,
            f"22e: aggregate completed {agg.completed} for {done - 1} done since the first drain")
    bundle = DeploymentBundle.load(BUNDLE_PATH)
    brouter = bundle.router(model, params, devices=[card], name="chip_smoke-bundle", **kw)
    bt = brouter.submit(prompts[4], max_new_tokens=4)
    bstatus = brouter.drain()
    beng = brouter.engines[card]
    require(bt.done and len(bt.request.output) == 4 and bstatus.completed == 1 and beng.cuda_graphs
            and beng.runtime.active_device() == card, f"22e: bundle.router on {card}: {bstatus}")
    res = {"routes": routes, "affinity": affinity, "slo_avoided_to": avoided, "aggregate": _status_dict(agg),
           "per_engine": [_status_dict(s) for s in per], "bundle_router_device": card,
           "bundle_router_output": list(bt.request.output)}
    print(f"  Router over two engines (own runtimes, one set of weights): routes {routes}; shared prompt -> "
          f"{affinity} (prefix affinity over load); targeted request with card-a in SLO mode -> {avoided}")
    print(f"  drain aggregate: completed {agg.completed}, prefix hits {agg.prefix_hits} / {agg.prefix_lookups}, "
          f"steps {agg.steps} (per engine {[s.steps for s in per]}); bundle.router(devices=[{card!r}]) served "
          f"{bt.request.output}")
    return res


def phase_paged_hymba(torch, mm, ss) -> dict:
    """22f: full-width hymba-1.5b (bf16) under a paged pool: the legacy admission (no
    prefill_chunk), every SSM launch through ssm_cuda_fused; streams equal to the dense
    engine's over the same prompts."""
    from repro_torch.configs import registry
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model

    cfg = registry.get("hymba-1.5b")
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]
    outputs, res = {}, {}
    for name, kw in (("dense", {}), ("paged", dict(block_size=16, n_blocks=40))):
        eng = _engine(model, params, FixedPolicy(), f"chip_smoke-hymba[{name}]", max_batch=4, cache_len=256, **kw)
        torch.cuda.synchronize()
        mm.reset_launches()
        ss.reset_launches()
        tickets = [eng.submit(p, max_new_tokens=16) for p in prompts]
        status = eng.drain()
        torch.cuda.synchronize()
        require(status.completed == len(prompts) and not status.exhausted, f"22f {name}: {status}")
        outputs[name] = [list(t.request.output) for t in tickets]
        res[name] = {"gemm_launches": mm.total_launches(), "ssm_launches": ss.total_launches(),
                     "ssm_entry_launches": dict(ss.ENTRY_LAUNCHES), "status": _status_dict(status),
                     "pool_bytes": _pool_bytes(eng.pool),
                     "kinds": {k: s.kind for k, s in eng.pool.specs.items() if k.startswith("['layer1']")}}
        if name == "paged":
            require(not eng._streaming and eng.pool.blocks_per_lane == 16, "22f: not a paged legacy engine")
        del eng
    paged = res["paged"]
    require(paged["ssm_entry_launches"] == {"fused": paged["ssm_launches"], "dta": 0} and paged["ssm_launches"] > 0,
            f"22f: SSM launches {paged['ssm_entry_launches']} (want all through ssm_cuda_fused)")
    require(outputs["paged"] == outputs["dense"], "22f: hymba-1.5b's paged streams differ from the dense engine's")
    print(f"  hymba-1.5b full width, bf16, paged (16-token blocks, 40 blocks; layer 1's sliding-window ring of "
          f"min(2048, 256) tracks cache_len: {paged['kinds']}): streams equal to the dense engine's over "
          f"{len(prompts)} prompts x 16 tokens; GEMM launches {paged['gemm_launches']}, SSM launches "
          f"{paged['ssm_entry_launches']}; pool {paged['pool_bytes'] / 1e6:.1f} MB against dense "
          f"{res['dense']['pool_bytes'] / 1e6:.1f} MB")
    return res | {"streams_equal_dense": True}


# ---------------------------------------------------------------------------
# phase 23: the tuning control plane on the card
# ---------------------------------------------------------------------------
REGISTRY_ROOT = ROOT / "build" / "registry"
# 23a's tune job measures every cell, as phase 17 does. With phase 17b's knobs and no donor
# (prune 0.5, budget 0.3) its parent held the H100 model's favourites, and the engine's canary,
# which scores selections on that model, rejected the measured retune's child (PERF.md, PR 24).
POLL_TIMEOUT = 2.0  # the subscribers' long-poll, seconds
SUBSCRIBER_KN = [(4096, 4096), (4096, 14336), (4096, 49152)]  # 23c: three granite-8b decode shapes


class _MeasuredTables:
    """The plane's ``retune_dataset_builder``: each retune's matmul table measured on the
    card (``gpubench.build_gpu_dataset``), every call kept with its wall-clock interval."""

    def __init__(self, card: str):
        self.card = card
        self.calls: list[dict] = []
        self.entered = 0  # calls begun (a call runs on the plane's worker thread)

    def __call__(self, problems, device):
        from repro_torch.core.gpubench import build_gpu_dataset

        require(device == self.card, f"a retune asked for a table of {device!r}, not this card's")
        self.entered += 1
        t0 = time.time()
        ds, seconds = build_gpu_dataset("matmul", problems)
        self.calls.append({"t0": t0, "t1": time.time(), "seconds": seconds, "source": ds.source,
                           "cells": {(tuple(p), c.name()): float(ds.perf[i, j]) for i, p in enumerate(ds.problems)
                                     for j, c in enumerate(ds.configs)}})
        return ds


def _phase19_prompts(torch, cfg):
    rng = torch.Generator().manual_seed(2)  # phase_serve's prompts
    return [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]


def _history(job: dict) -> dict:
    return {state: t for state, t in job["history"]}


def _await(cond, timeout: float, what: str) -> float:
    deadline = time.monotonic() + timeout
    while not cond():
        require(time.monotonic() < deadline, f"no {what} after {timeout:.0f}s")
        time.sleep(0.005)
    return time.time()


def _job_error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message a failed job must carry
        return f"{type(e).__name__}: {e}"
    raise RuntimeError("chip_smoke: expected the direct call to raise")


def phase_control_job(torch, mods: dict, tuning: dict, staged: dict, plane, client, card: str) -> dict:
    """23a: a tune job over HTTP, measured on the card; idempotent publish; refused specs."""
    from repro_torch.core.tuner import TRANSFER_REFUSED, tune_fleet

    spec = {"devices": [card], "archs": list(TUNED_ARCHS), "n_kernels": 4}
    for mod in mods.values():
        mod.reset_launches()
    job = client.submit(spec)
    require(job["state"] == "queued", f"a submitted job is {job['state']!r}")
    done = client.wait_job(job["id"], timeout=600)
    launches = {fam: mod.total_launches() for fam, mod in mods.items()}
    require(done["state"] == "succeeded", f"23a: the tune job {done['state']}: {done['error']}")
    require([s for s, _ in done["history"]] == ["queued", "running", "succeeded"], f"job walk {done['history']}")
    art = done["artifact"]
    bundle = client.fetch_bundle("default", art["version"])
    require(art["devices"] == bundle.devices == [card] and bundle.load_errors == [],
            f"artifact {art}, devices {bundle.devices}, load errors {bundle.load_errors}")
    dep = bundle.deployments[card]
    lineage, seconds, tables = dep.meta["tuning_lineage"], dep.meta["measure_seconds"], dep.meta["tables"]
    require(dep.meta["source"] == "measured" and set(lineage) == set(mods) == set(tables),
            f"not a measured card table over every family: {dep.meta['source']}, {sorted(lineage)}")
    for fam in mods:
        rec = lineage[fam]
        require(rec["measured_fraction"] == 1.0 and rec["n_measured"] == rec["full_cost"] > 0,
                f"{fam}: measured {rec['n_measured']} of {rec['full_cost']} cells")
        require(launches[fam] > 0, f"{fam}: no launches while the job measured: {launches}")
    again = plane.registry.publish("default", bundle, spec=spec)
    require(again.version == art["version"] and len(plane.registry.versions("default")) == 1,
            f"publishing the same bundle again gave {again.version} (first {art['version']})")
    refused = {}
    for label, bad, want in (
            ("transfer", {**spec, "transfer": True}, f"ValueError: {TRANSFER_REFUSED}"),
            ("tpu_v5e", {**spec, "devices": ["tpu_v5e"]},
             _job_error(lambda: tune_fleet(list(TUNED_ARCHS), device_names=("tpu_v5e",), n_kernels=4)))):
        got = client.wait_job(client.submit(bad)["id"], timeout=60)
        require(got["state"] == "failed" and got["error"] == want, f"the {label} spec: {got['state']} {got['error']!r}")
        refused[label] = got["error"]
    hist = _history(done)
    health = client.healthz()
    rows = {fam: {"n_measured": lineage[fam]["n_measured"], "full_cost": lineage[fam]["full_cost"],
                  "measured_fraction": lineage[fam]["measured_fraction"], "seconds": seconds[fam],
                  "seconds_phase_17": tuning["measure_seconds"][fam],
                  "seconds_phase_17b": staged["families"][fam]["seconds"],
                  "oracle_on_full_table": _oracle_on(tuning["full"][fam], dep.family_tuning(fam).configs, fam),
                  "oracle_on_full_table_phase_17": tuning["oracle_on_full_table"][fam],
                  "launches_while_measuring": launches[fam]} for fam in mods}
    res = {"version": art["version"], "spec": spec, "job_s": hist["succeeded"] - hist["running"],
           "queued_s": hist["running"] - hist["queued"], "families": rows, "refused": refused, "health": health,
           "launches": launches}
    print(f"  job {done['id']} queued -> running -> succeeded in {res['job_s']:.2f}s (phase 17: {tuning['wall_s']:.1f}s, "
          f"17b: {staged['wall_s']:.1f}s); default@{art['version']}, published again: the same version")
    for fam, r in rows.items():
        print(f"  {fam}: measured {r['n_measured']}/{r['full_cost']} cells in {r['seconds']:.2f}s (17: "
              f"{r['seconds_phase_17']:.2f}s, 17b: {r['seconds_phase_17b']:.2f}s); oracle over phase 17's full table "
              f"{r['oracle_on_full_table']:.4f} (17's deployment {r['oracle_on_full_table_phase_17']:.4f}); "
              f"launches {r['launches_while_measuring']}")
    print(f"  refused: {refused}")
    print(f"  /healthz: {health}")
    return res


def _serve_engine(model, params, bundle, name: str, **kw):
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    rt = KernelRuntime(name=name)
    rt.set_selection_logging(True, cap=1 << 16)
    return ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt, bundle=bundle, **kw)


def _ratios(cells: dict, base: dict) -> dict | None:
    """GFLOP/s of ``cells`` over ``base`` on their common (problem, config) cells."""
    ratios = [v / base[key] for key, v in cells.items() if key in base]
    if not ratios:
        return None
    return {"cells": len(ratios), "median": statistics.median(ratios), "min": min(ratios), "max": max(ratios),
            "below_half": sum(r < 0.5 for r in ratios)}


def phase_control_serve(torch, mm, seq: dict, model, params, plane, client, card: str, tables, job: dict,
                        tuning: dict) -> dict:
    """23b: full-width granite-8b served from ``registry://``, two hosts' telemetry
    federated, one retune measured on the card, its child pushed to the subscribed
    engine and adopted at a step boundary under CUDA graphs."""
    import repro_torch
    from repro_torch.control import PolicySubscriber, content_version

    bundle = repro_torch.load_bundle(f"registry://127.0.0.1:{plane.port}/default")
    require(content_version(bundle.to_blob()) == job["version"], "registry:// did not load 23a's version")
    prompts = _phase19_prompts(torch, model.cfg)
    eng, eng_b = (_serve_engine(model, params, bundle, f"chip_smoke-23b[{h}]") for h in ("engine-a", "engine-b"))
    require(eng.cuda_graphs and eng.device == eng_b.device == card, f"engine on {eng.device}, graphs {eng.cuda_graphs}")
    sub = PolicySubscriber(client, card, eng, poll_timeout=POLL_TIMEOUT).start()
    parent = eng.deployment
    launches = {}
    mm.reset_launches()
    cold = _drain(torch, eng, prompts, mm, seq)
    before = _drain(torch, eng, prompts, mm, seq)
    _drain(torch, eng_b, prompts, mm, seq)
    launches["control plane: served from registry://, two engines (23b)"] = mm.total_launches()
    snaps = [e.runtime.telemetry() for e in (eng, eng_b)]
    n_calls = len(tables.calls)
    mm.reset_launches()
    t_post = time.time()
    acks = [client.post_telemetry(card, snaps[0], host="engine-a")]
    acks.append(client.post_telemetry(card, snaps[1], host="engine-b"))
    fired = [a["retune_job"] for a in acks if a["retune_job"]]
    if not acks[0]["retune_job"]:  # the trigger came with the second host: one more post must start no other
        acks.append(client.post_telemetry(card, snaps[0], host="engine-a"))
        fired += [a["retune_job"] for a in acks[2:] if a["retune_job"]]
    t_posted = time.time()
    require(len(fired) == 1, f"the drift started {len(fired)} retune jobs: {acks}")
    require(acks[1]["merged_events"] == snaps[0].n_events + snaps[1].n_events and acks[1]["hosts"] == 2,
            f"federation: {acks[1]['merged_events']} events from {acks[1]['hosts']} hosts, snapshots "
            f"{snaps[0].n_events} + {snaps[1].n_events}")
    done = client.wait_job(fired[0], timeout=600)
    launches["control plane: retune job's measured table (23b)"] = mm.total_launches()
    require(done["state"] == "succeeded", f"23b: the retune job {done['state']}: {done['error']}")
    hist = _history(done)
    require(hist["succeeded"] > t_posted, "the retune ended before the last post: the dedup went unchecked")
    measured = tables.calls[n_calls:]
    require(measured and all(c["source"] == "measured" for c in measured) and launches[
        "control plane: retune job's measured table (23b)"] > 0, "the retune did not measure its matmul table on the card")
    art = done["artifact"]
    require(art["parent"] == job["version"] and art["device"] == card and "matmul" in art["families"],
            f"child artifact {art}")
    require(plane.policy_state(card)["seq"] == 2, f"board {plane.policy_state(card)}")
    t_delivered = _await(lambda: sub.updates or sub.errors, 30, "delivery to the subscribed engine")
    require(sub.errors == [] and sub.updates[-1]["version"] == art["version"], f"subscriber {sub.updates} {sub.errors}")
    child = client.fetch_bundle("default", art["version"]).deployments[card]
    epoch0, built0, n_re, s0 = eng.runtime.policy_epoch(), len(eng.program_log), len(eng.retune_events), eng.steps
    mm.reset_launches()
    tickets = [eng.submit(p, max_new_tokens=16) for p in prompts]
    torch.cuda.synchronize()
    t_a0 = time.time()
    eng.step()  # adopts the offered child first
    torch.cuda.synchronize()
    t_a1 = time.time()
    eng.drain()
    require(all(t.done and len(t.request.output) == 16 for t in tickets), "the drain after the adoption dropped a request")
    after = _drain(torch, eng, prompts, mm, seq)
    launches["control plane: adoption, recapture, drains (23b)"] = mm.total_launches()
    ev = eng.retune_events[n_re] if len(eng.retune_events) > n_re else None
    require(ev is not None and ev.source == "control-plane" and ev.swapped and ev.step == s0,
            f"adoption: {ev}; incidents {eng.runtime.incidents()[-2:]}")
    require(eng.deployment.to_blob() == child.to_blob() and eng.runtime.policy_epoch() > epoch0,
            "the engine does not serve the child under a new epoch")
    recaptured = _rebuilt(eng, built0)
    require(recaptured and all(r.captured and r.epoch >= ev.epoch for r in recaptured),
            f"programs not captured again after the adoption: {eng.program_log[built0:]}")
    space = [c.name() for c in mm.config_space()]
    phase17 = {(p, space[j]): float(v) for p, row in tuning["full"]["matmul"].items() for j, v in enumerate(row)}
    table_vs_17 = _ratios({k: v for c in measured for k, v in c["cells"].items()}, phase17)
    served = sorted(set(snaps[0].family_problems.get("matmul", {}).values()) | set(
        snaps[1].family_problems.get("matmul", {}).values()))
    changed = {str(p): [parent.select("matmul", p).name(), child.select("matmul", p).name()] for p in served
               if parent.select("matmul", p) != child.select("matmul", p)}
    res = {"uri": f"registry://127.0.0.1:{plane.port}/default", "snapshot_events": [s.n_events for s in snaps],
           "acks": acks, "retune_job": done, "child": art["version"],
           "post_to_job_s": hist["queued"] - t_post, "job_queued_s": hist["running"] - hist["queued"],
           "retune_s": hist["succeeded"] - hist["running"], "retune_measure_s": sum(c["seconds"] for c in measured),
           "job_to_announcement_s": hist["succeeded"] - hist["running"],
           "announcement_to_delivery_s": t_delivered - hist["succeeded"],
           "delivery_to_adoption_s": t_a0 - t_delivered, "adoption_step_s": t_a1 - t_a0,
           "recaptured": [(r.kind, r.size) for r in recaptured], "recapture_s": sum(r.seconds for r in recaptured),
           "warm_decode_median_ms_before": before["decode_median_ms"],
           "warm_decode_median_ms_after": after["decode_median_ms"],
           "cold_tok_per_s": cold["tok_per_s"], "streams_equal_across_swap": before["outputs"] == after["outputs"],
           "selections_changed": changed, "served_problems": len(served), "event": dataclasses.asdict(ev),
           "table_vs_phase_17": table_vs_17,
           "launches": launches}
    print(f"  {res['uri']} -> {len(bundle.devices)} device; two engines drained phase 19's prompts (cold "
          f"{cold['tok_per_s']:.1f} tok/s); telemetry {res['snapshot_events']} events; acks "
          f"{[(a['merged_events'], a['hosts'], a['retune_job'], a['drift']) for a in acks]}")
    print(f"  post -> retune job queued {res['post_to_job_s'] * 1e3:.1f} ms; queued {res['job_queued_s']:.3f}s; "
          f"retune {res['retune_s']:.2f}s (of it measuring {res['retune_measure_s']:.2f}s); announcement -> "
          f"delivery {res['announcement_to_delivery_s']:.3f}s; adoption step {res['adoption_step_s']:.3f}s; "
          f"recaptured {res['recaptured']} in {res['recapture_s']:.3f}s")
    print(f"  child default@{art['version']} (parent {art['parent']}); epoch {epoch0} -> {eng.runtime.policy_epoch()}; "
          f"{len(changed)} of {len(served)} served GEMM selections changed {changed}; warm decode median "
          f"{before['decode_median_ms']:.3f} ms before, {after['decode_median_ms']:.3f} after")
    print(f"  the retune's table against phase 17's on the common cells (GFLOP/s ratio, nothing served meanwhile): "
          f"{table_vs_17}")
    return res | {"engines": (eng, eng_b), "subscriber": sub, "prompts": prompts, "child_dep": child}


def phase_control_runtime(torch, mm, ops, client, card: str, child, child_version: str) -> dict:
    """23c: an engine-less runtime subscribed from seq 0 receives the child; direct
    ops.matmul calls launch the child's configs and agree with the plain version."""
    from repro_torch.control import PolicySubscriber
    from repro_torch.core.runtime import KernelRuntime

    rt = KernelRuntime(name="chip_smoke-23c")
    sub = PolicySubscriber(client, card, rt, start_from=0, poll_timeout=POLL_TIMEOUT).start()
    _await(lambda: sub.updates or sub.errors, 30, "delivery to the runtime")
    require(sub.errors == [] and sub.updates[-1]["version"] == child_version, f"{sub.updates} {sub.errors}")
    require(rt.active_device() == card and rt.policy().to_blob() == child.to_blob(),
            f"the runtime's active deployment is not the child ({rt.active_device()})")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    mm.reset_launches()
    for k, n in SUBSCRIBER_KN:
        x = torch.randn((4, 1, k), device="cuda", generator=g, dtype=torch.bfloat16)
        w = torch.randn((k, n), device="cuda", generator=g, dtype=torch.bfloat16)
        out_dtype = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16
        want_cfg = child.select("matmul", (1, k, n, 4))
        before = dict(mm.LAUNCHES)
        with rt.activate():
            got = ops.matmul(x, w, out_dtype=None if out_dtype == torch.bfloat16 else out_dtype)
        delta = {c: v - before[c] for c, v in mm.LAUNCHES.items() if v != before[c]}
        require(delta == {want_cfg.name(): 1}, f"({k}, {n}): launched {delta}, the child selects {want_cfg.name()}")
        want = mm.matmul_plain(x.reshape(4, k), w, out_dtype).float()
        err = (got.reshape(4, n).float() - want).abs().max().item()
        scale = want.abs().max().item()
        tol = TOL[("bf16", "f32" if out_dtype == torch.float32 else "bf16")]
        require(err / scale <= tol, f"({k}, {n}) under {want_cfg.name()}: rel err {err / scale:.3g} > {tol}")
        rows.append({"k": k, "n": n, "config": want_cfg.name(), "max_abs_err": err, "rel_err": err / scale,
                     "tol": tol})
    res = {"updates": sub.updates, "rows": rows, "launches": mm.total_launches(), "subscriber": sub}
    print(f"  runtime subscriber (start_from=0): received default@{child_version}, active on {rt.active_device()}; "
          f"ops.matmul at (4, 1, k) x (k, n): {[(r['k'], r['n'], r['config'], round(r['rel_err'], 6)) for r in rows]}")
    return res


def phase_control_concurrent(torch, mm, seq: dict, model, params, client, card: str, tables, served: dict) -> dict:
    """23d: a retune job measures on the plane's worker while the engine captures its
    programs again (an adoption at a step boundary): both succeed; the replayed streams
    equal an eager engine's."""
    eng = served["engines"][0]
    prompts = served["prompts"]
    t0 = time.perf_counter()
    served["subscriber"].stop()  # this engine adopts only what 23d offers it
    sub_stop_s = time.perf_counter() - t0
    snap = eng.runtime.telemetry()  # its window since 23b's adoption
    n_calls, n_entered = len(tables.calls), tables.entered
    mm.reset_launches()
    ack = client.post_telemetry(card, snap, host="engine-a")
    job_id = ack["retune_job"] or client.submit({"kind": "retune", "device": card, "families": ["matmul"]})["id"]
    _await(lambda: tables.entered > n_entered, 60, "a retune measurement")
    built0, n_re = len(eng.program_log), len(eng.retune_events)
    eng.offer_deployment(eng.deployment, source="capture-while-measuring")  # same policy: programs captured again
    t_c0 = time.time()
    graphed = _drain(torch, eng, prompts, mm, seq)
    t_c1 = time.time()
    warm = _drain(torch, eng, prompts, mm, seq)
    done = client.wait_job(job_id, timeout=600)
    launches = mm.total_launches()
    require(done["state"] == "succeeded", f"23d: the retune job {done['state']}: {done['error']}")
    call = tables.calls[n_calls]
    require(call["t0"] <= t_c0 <= call["t1"], f"the capture drain (from {t_c0:.3f}) did not start while the "
                                              f"table was measured ({call['t0']:.3f}-{call['t1']:.3f})")
    ev = eng.retune_events[n_re] if len(eng.retune_events) > n_re else None
    recaptured = _rebuilt(eng, built0)
    require(ev is not None and ev.swapped and recaptured and all(r.captured for r in recaptured),
            f"the engine did not capture again during the job: {ev}, {eng.program_log[built0:]}")
    eager_eng = _serve_engine(model, params, client.fetch_bundle("default", served["child"]), "chip_smoke-23d[eager]",
                              cuda_graphs=False)
    mm.reset_launches()
    eager = _drain(torch, eager_eng, prompts, mm, seq)
    eager_launches = mm.total_launches()
    require(graphed["outputs"] == warm["outputs"] == eager["outputs"],
            "the streams replayed after a capture beside a measurement differ from the eager engine's")
    ratios = _ratios(call["cells"], {key: v for c in tables.calls[:n_calls] for key, v in c["cells"].items()})
    res = {"job": done["artifact"], "job_s": _history(done)["succeeded"] - _history(done)["running"],
           "measure_s": call["seconds"], "capture_drain": [t_c0, t_c1], "table": [call["t0"], call["t1"]],
           "recaptured": [(r.kind, r.size) for r in recaptured], "recapture_s": sum(r.seconds for r in recaptured),
           "decode_median_ms_capture_drain": graphed["decode_median_ms"], "decode_median_ms_next": warm["decode_median_ms"],
           "table_vs_23b": ratios,
           "streams_equal_eager": True, "launches": launches, "eager_launches": eager_launches,
           "subscriber_stop_s": sub_stop_s}
    print(f"  retune job {done['id']} measured {call['seconds']:.2f}s ({call['t0']:.3f}-{call['t1']:.3f}); the engine "
          f"adopted at step {ev.step} and captured {res['recaptured']} again in {res['recapture_s']:.3f}s during it "
          f"(drain {t_c0:.3f}-{t_c1:.3f}); job {res['job_s']:.2f}s, child default@{done['artifact']['version']}")
    print(f"  its table against 23b's on the common cells (GFLOP/s ratio, the engine serving meanwhile): {ratios}; "
          f"decode median {graphed['decode_median_ms']:.3f} ms during, {warm['decode_median_ms']:.3f} next; "
          f"replayed streams equal the eager engine's")
    return res


def phase_control_cli(plane, versions: list) -> dict:
    """23e: ``repro_torch.launch.ctl`` status and artifacts against the plane."""
    import contextlib
    import io

    from repro_torch.launch import ctl

    outs = {}
    for cmd in (["status", "--url", plane.url], ["artifacts", "--url", plane.url, "--name", "default"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ctl.main(cmd)
        outs[cmd[0]] = buf.getvalue()
    lines = outs["artifacts"].splitlines()
    require(lines[0] == f"default@{versions[0]} seq=0", f"ctl artifacts: {lines}")
    for seq, (parent, child) in enumerate(zip(versions, versions[1:]), start=1):
        require(f"default@{child} seq={seq} parent={parent}" in lines, f"ctl artifacts: {lines} (want {child})")
    require('"status": "ok"' in outs["status"] and all(f"-> default@{v}" in outs["status"] for v in versions),
            f"ctl status: {outs['status']}")
    print("  ctl artifacts:\n    " + "\n    ".join(lines))
    print("  ctl status (jobs):\n    " + "\n    ".join(ln for ln in outs["status"].splitlines() if ln.startswith("job-")))
    return outs


def phase_control_plane(torch, mods: dict, seq: dict, ops, tuning: dict, staged: dict, model, params, card: str) -> dict:
    """Phase 23: the control plane in process, driven over HTTP (23a-e), then stopped."""
    import shutil

    from repro_torch.control import ControlPlane, ControlPlaneClient

    shutil.rmtree(REGISTRY_ROOT, ignore_errors=True)
    tables = _MeasuredTables(card)
    plane = ControlPlane(port=0, registry_root=REGISTRY_ROOT, retune_dataset_builder=tables).start()
    client = ControlPlaneClient(plane.url)
    mm = mods["matmul"]
    print(f"  control plane on {plane.url}, registry {REGISTRY_ROOT.relative_to(ROOT)}")
    print("[23a] a tune job over HTTP")
    job = phase_control_job(torch, mods, tuning, staged, plane, client, card)
    print("[23b] serving from registry://, federated telemetry, a retune on the card, the push and the adoption")
    served = phase_control_serve(torch, mm, seq, model, params, plane, client, card, tables, job, tuning)
    print("[23c] a runtime subscriber")
    runtime = phase_control_runtime(torch, mm, ops, client, card, served["child_dep"], served["child"])
    print("[23d] capture and measurement together")
    concurrent = phase_control_concurrent(torch, mm, seq, model, params, client, card, tables, served)
    print("[23e] the ctl CLI")
    versions = [job["version"], served["child"], concurrent["job"]["version"]]
    cli = phase_control_cli(plane, versions)
    stops = {"engine subscriber (23d)": concurrent["subscriber_stop_s"]}
    for name, stoppable in (("runtime subscriber", runtime["subscriber"]), ("plane", plane)):
        t0 = time.perf_counter()
        stoppable.stop()
        stops[name] = time.perf_counter() - t0
    for name in stops:
        require(stops[name] <= POLL_TIMEOUT + 15.0, f"{name}.stop() took {stops[name]:.1f}s")
    require(REGISTRY_ROOT.is_dir() and len(list(REGISTRY_ROOT.glob("default/*.json"))) == len(versions),
            f"the registry root holds {sorted(p.name for p in REGISTRY_ROOT.glob('*/*.json'))}")
    print(f"  stop() seconds: {stops}; runtime subscriber updates {[u['seq'] for u in runtime['updates']]}")
    for key in ("engines", "subscriber", "prompts", "child_dep"):
        served.pop(key)
    runtime.pop("subscriber")
    return {"job": job, "served": served, "runtime": runtime, "concurrent": concurrent, "cli": cli, "stops": stops}


# ---------------------------------------------------------------------------
# phase 24: the remaining decoder architectures served at full width
# ---------------------------------------------------------------------------
# (arch, layers served): the two MoE models and the VLM are cut in depth to fit the card
# in bf16 (the VLM at 4 whole groups of 4 self layers and a cross block); the dense ones
# run whole.
ARCH_RUNS = (("qwen3-moe-235b-a22b", 8), ("dbrx-132b", 8), ("qwen2.5-32b", None), ("glm4-9b", None),
             ("llama-3.2-vision-90b", 20))
ARCH_WIDTHS = {  # (d_model, heads, KV heads, d_ff, vocab, experts, top-k): the registered configs
    "qwen3-moe-235b-a22b": (4096, 64, 4, 1536, 151936, 128, 8),
    "dbrx-132b": (6144, 48, 8, 10752, 100352, 16, 4),
    "qwen2.5-32b": (5120, 40, 8, 27648, 152064, None, None),
    "glm4-9b": (4096, 32, 2, 13696, 151552, None, None),
    "llama-3.2-vision-90b": (8192, 64, 8, 28672, 128256, None, None),
}
EXPERT_EINSUMS = ("ecd,edf->ecf", "ecd,edf->ecf", "ecf,efd->ecd")  # models/moe.py: gate, up, down


def _arch_cfg(arch: str, depth):
    from repro_torch.configs import registry

    cfg = registry.get(arch)
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
           cfg.moe.n_experts if cfg.moe else None, cfg.moe.top_k if cfg.moe else None)
    require(got == ARCH_WIDTHS[arch], f"unexpected {arch} config {cfg}")
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def _arch_per_forward(model) -> dict[str, int]:
    """GEMM launches of one forward by program kind: an MoE layer makes 5 (Q, K, V,
    O, router), a dense one 7; a VLM group 7 (cross_every - 1) + 9 at prefill (the
    cross block's Q, K, V, O and FFN, then the cached cross K and V) and 7
    (cross_every - 1) + 5 at decode (Q, O and the FFN over the cached K / V); each
    program adds the vocab GEMM."""
    c = model.cfg
    if model.is_vlm:
        g, spg = model.n_groups, model.self_per_group
        return {"prefill": g * (7 * spg + 9) + 1, "decode": g * (7 * spg + 5) + 1}
    n = c.n_layers * (5 if model.is_moe else 7) + 1
    return {"prefill": n, "decode": n}


def _arch_selections(model) -> dict[str, int]:
    """Selections one program build makes: the scanned layer body's calls once (a
    VLM's first self layer and first cross block), and the head."""
    if model.is_vlm:
        return {"prefill": 7 + 9 + 1, "decode": 7 + 5 + 1}
    n = (5 if model.is_moe else 7) + 1
    return {"prefill": n, "decode": n}


def _expert_einsum_ms(torch, model, params) -> dict:
    """The expert einsums (a library batched GEMM, as the reference's
    ``jnp.einsum``) of a warm width-4 decode step: the same three calls at the
    replay's shapes, timed with CUDA events (each call queued behind a device
    sleep, so the events bracket device time), times n_layers.  The profiler is
    not used: late in a long run a short profiled window recorded no kernels at
    all (PERF.md §7)."""
    c = model.cfg
    e, d, ff = c.moe.n_experts, c.d_model, c.d_ff
    cap = max(1, int(4 * c.moe.top_k / e * c.moe.capacity_factor))  # 4 tokens a width-4 step
    blk = params["blocks"]["moe"]
    buf = torch.randn((e, cap, d), device="cuda", dtype=torch.bfloat16)
    h = torch.randn((e, cap, ff), device="cuda", dtype=torch.bfloat16)

    def einsums():
        torch.einsum(EXPERT_EINSUMS[0], buf, blk["w_gate"][0])
        torch.einsum(EXPERT_EINSUMS[1], buf, blk["w_up"][0])
        torch.einsum(EXPERT_EINSUMS[2], h, blk["w_down"][0])

    ms = _time_ms(lambda _: einsums()) * c.n_layers
    require(ms > 0, f"expert einsums timed at {ms} ms")
    weight_bytes = 3 * e * d * ff * 2 * c.n_layers  # every expert's weights, read once a step
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  expert einsums (library call: torch.einsum, as the reference's jnp.einsum; capacity {cap}): "
          f"{ms:.3f} ms a decode step by CUDA events ({c.n_layers} layers x the 3 calls at the replay's shapes); "
          f"every expert's weights read once: {weight_bytes / 1e9:.2f} GB, bound {bound_ms:.3f} ms (bytes)")
    return {"ms": ms, "capacity": cap, "bound_ms": bound_ms, "bound_by": "bytes"}


def _free(torch) -> None:
    """Between models, never during a capture: collect, then give the cache back."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_arch_serve(torch, mm, arch: str, depth) -> dict:
    """One of the remaining architectures at full width in bf16 (random weights from a
    CUDA generator, cut in depth where it must be): phase 4's engine and requests,
    cold then warm drains with equal streams, the GEMM launches of every program
    against its formula, all through matmul.cu; an eager engine's drain with the
    same streams; for an MoE model the expert einsums' device time a decode step."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    full = _arch_cfg(arch, None)
    cfg = _arch_cfg(arch, depth)
    cut = f"cut in depth: {cfg.n_layers} of {full.n_layers} layers" if depth else "no depth cut"
    _free(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    extra = {}
    if model.is_vlm:
        extra["image_embs"] = torch.randn((1, cfg.n_image_tokens, cfg.d_model), generator=gen, device="cuda",
                                          dtype=torch.bfloat16)
    per_forward, per_build = _arch_per_forward(model), _arch_selections(model)
    print(f"  {arch} full width, {cut} ({before / 1e9:.2f} GB allocated before the "
          f"model): d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}" if model.is_moe else "")
          + (f", QKV bias" if cfg.qkv_bias else "")
          + (f", {model.n_groups} groups of {model.self_per_group} self layers + 1 cross block over "
             f"{cfg.n_image_tokens} image tokens" if model.is_vlm else "")
          + f"; bf16 weights {weight_bytes / 1e9:.2f} GB, init {init_s:.1f}s")

    rt = KernelRuntime(name=f"chip_smoke[{arch}]")
    rt.install(FixedPolicy())
    engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt, extra_inputs=extra)
    require(engine.cuda_graphs, "the engine does not take CUDA graphs on a CUDA model")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]
    torch.cuda.synchronize()
    mm.reset_launches()
    cold = _drain(torch, engine, prompts, mm, {})
    launches_cold = mm.total_launches()
    warm = _drain(torch, engine, prompts, mm, {})
    total, paths = mm.total_launches(), dict(mm.PATH_LAUNCHES)
    require(warm["outputs"] == cold["outputs"], f"{arch}: the warm drain's streams differ from the cold drain's")
    built = engine.program_log
    programs = engine.programs()
    require(all(r.captured for r in built), f"{arch}: a program was not captured: {built}")
    forwards = len(cold["events"]) + len(warm["events"])
    replays = sum(v["runs"] for v in programs.values())
    require(replays == forwards, f"{arch}: {replays} replays for {forwards} forwards")
    bad = [(kind, size, n, b) for kind, size, n, _, b, _ in cold["events"] + warm["events"]
           if n != 2 * per_forward[kind] * b]
    require(not bad, f"{arch}: forwards whose GEMM launches are not 2 x {per_forward} x programs built: {bad}")
    want_total = sum(2 * per_forward[r.kind] for r in built)
    require(total == launches_cold == want_total, f"{arch}: GEMM launches {launches_cold} (cold) / {total}: want "
                                                  f"{want_total}, none in the warm drain")
    require(paths.get("simt_f32", 0) == 0 and paths["tma"] + paths["cp_async"] == total,
            f"{arch}: served bf16 GEMMs off matmul.cu's bf16 paths: {paths}")
    fam = rt.shape_cache_stats()["per_family"]["matmul"]
    want_sel = sum(per_build[r.kind] for r in built)
    require(fam["hits"] + fam["misses"] == want_sel,
            f"{arch}: {fam} matmul selections, want {per_build} a build over {len(built)} builds")
    peak = torch.cuda.max_memory_allocated()
    _print_drain("cold drain (captures included)", cold)
    _print_drain("warm drain (replays only)", warm)
    print(f"  programs: {len(built)} captured ({', '.join(f'{r.kind} {r.size}' for r in built)}) in "
          f"{sum(r.seconds for r in built):.3f}s; {replays} replays; warm / cold streams equal")
    print(f"  GEMM launches (warm-ups and captures): {total} = sum over programs of 2 x {per_forward} per forward, 0 in "
          f"the warm drain, all through matmul.cu ({paths}); selections {per_build} a build")
    experts = _expert_einsum_ms(torch, model, params) if model.is_moe else None

    # The eager engine on the same weights and requests: the same streams.
    ert = KernelRuntime(name=f"chip_smoke-eager[{arch}]")
    ert.install(FixedPolicy())
    eager_engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=ert, extra_inputs=extra,
                                 cuda_graphs=False)
    mm.reset_launches()
    eager = _drain(torch, eager_engine, prompts, mm, {})
    eager_launches = mm.total_launches()
    require(eager["outputs"] == cold["outputs"], f"{arch}: the eager engine's streams differ from the graphed one's")
    _print_drain("eager drain (cuda_graphs=False)", eager)
    print(f"  max_memory_allocated {peak / 1e9:.2f} GB (before the eager engine); eager and graphed streams equal")
    del engine, eager_engine, model, params, extra
    return {"arch": arch, "n_layers": cfg.n_layers, "published_layers": full.n_layers, "cut": cut,
            "weight_bytes": weight_bytes, "init_s": init_s, "cold": cold, "warm": warm, "eager": eager,
            "per_forward": per_forward, "selections_per_build": per_build,
            "programs": [dataclasses.asdict(r) for r in built], "replays": replays, "gemm_launches": total,
            "eager_gemm_launches": eager_launches, "path_launches": paths, "max_memory_allocated": peak,
            "expert_einsums": experts}


# Card against CPU (24f): the reduced models in f32, in process, on the same weights and inputs.
ARCH_PARITY = (("qwen3-moe-235b-a22b", {}), ("qwen3-moe-235b-a22b", {"block_size": 16, "prefill_chunk_tokens": 32}),
               ("llama-3.2-vision-90b", {}), ("llama-3.2-vision-90b", {"block_size": 16}), ("qwen2.5-32b", {}))


def phase_arch_cpu_vs_card(torch, mm) -> dict:
    """Reduced qwen3-moe (dense pool; paged, prefix-shared, 32-token chunks),
    llama-3.2-vision (seeded image embeddings; dense and paged) and qwen2.5-32b (QKV
    biases set to seeded normals) in f32, served on cuda and on cpu from the same
    weights: equal greedy streams."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    out = {}
    mm.reset_launches()
    for arch, kw in ARCH_PARITY:
        cfg = registry.get(arch).reduced()
        rng = np.random.default_rng(24)
        system = rng.integers(0, cfg.vocab, 24)
        prompts = [np.concatenate([system, rng.integers(0, cfg.vocab, n)]).astype(np.int32) for n in (4, 20, 36)]
        extra = {}
        if cfg.family == "vlm":
            extra["image_embs"] = torch.randn((1, cfg.n_image_tokens, cfg.d_model),
                                              generator=torch.Generator().manual_seed(5))
        streams = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
            params = model.init(torch.Generator(device="cpu").manual_seed(0))
            if cfg.qkv_bias:
                g = torch.Generator().manual_seed(11)
                for key in ("bq", "bk", "bv"):
                    bias = params["blocks"]["attn"][key]
                    bias.copy_(torch.randn(bias.shape, generator=g) * 0.5)
            rt = KernelRuntime(name=f"chip_smoke-parity[{arch}, {dev}]")
            rt.install(FixedPolicy())
            engine = ServingEngine(model, params, max_batch=2, cache_len=128, runtime=rt, extra_inputs=extra, **kw)
            tickets = [engine.submit(p, max_new_tokens=12) for p in prompts]
            status = engine.drain()
            require(status.completed == len(prompts), f"{arch} {kw} on {dev}: {status}")
            streams[dev] = [list(t.request.output) for t in tickets]
        if streams["cuda"] != streams["cpu"]:
            print(f"  cuda {streams['cuda']}\n  cpu  {streams['cpu']}")
        require(streams["cuda"] == streams["cpu"], f"reduced {arch} {kw}: greedy streams differ between cuda and cpu")
        name = f"{arch} {', '.join(f'{k}={v}' for k, v in kw.items()) or 'dense pool'}"
        out[name] = sum(map(len, streams["cpu"]))
        print(f"  reduced {name}, f32{', nonzero QKV biases' if cfg.qkv_bias else ''}"
              f"{', seeded image embeddings' if extra else ''}: cuda and cpu token streams equal "
              f"({out[name]} tokens)")
    return {"tokens": out, "gemm_launches": mm.total_launches()}



# ---------------------------------------------------------------------------
# phase 25: training on the card
# ---------------------------------------------------------------------------
TRAIN_ROWS = 1024  # granite-8b's and seamless's training GEMMs at batch 8, seq 128: B * S rows
# seamless-m4t-large-v2's (k, n): Q, K, V, O (self and cross), gate and up, down, the vocab head
SEAMLESS_KN = [(1024, 1024), (1024, 8192), (8192, 1024), (1024, 256256)]
# 25a's f32 limit (and phase 3's at its f32-only shapes) is ``matmul.f32_limit``: 1e-5 up to a
# reduction of 16,384 terms, then growing as sqrt(K).  Seamless's head gradient sums K = 256,256
# (limit 3.95e-5); both sides are also held against an f64 product.
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_PARITY_TOL = 1e-4  # 25e: card against CPU, relative to each gradient's max (f32, sums in other orders)
BF16_FED = ("cross/attn/wk", "cross/attn/wv", "cross/ln_img")  # 25e: VLM leaves behind bf16 roundings (2^-8)
# 25c: set while the embedding's backward added with atomics (layers.table_grad now sums in
# order); kept until a run shows the resume bitwise.
RESUME_TOL = dict(rtol=1e-4, atol=1e-5)


class _PlainOnCard(RuntimeError):
    pass


def _no_plain_on_card(ops):
    """Replace the plain versions ``ops`` calls by guards that raise on a CUDA
    tensor (and run the plain version on a CPU one); returns the restore."""
    names = ("matmul_plain", "wkv_plain", "ssm_plain", "ssm_fused_plain", "attention_plain", "wkv_backward_plain",
             "ssm_backward_plain", "ssm_fused_backward_plain")
    saved = {name: getattr(ops, name) for name in names}

    def guard(name, fn):
        def run(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise _PlainOnCard(f"ops.{name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return run

    for name, fn in saved.items():
        setattr(ops, name, guard(name, fn))
    return lambda: [setattr(ops, name, fn) for name, fn in saved.items()]


def _train_runtime(name: str):
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy

    rt = KernelRuntime(name=name)
    rt.install(FixedPolicy())
    return rt


def phase_grad_gemms(torch, mm, ops) -> dict:
    """25a: ``ops.matmul``'s forward and both gradients through the kernel against
    autograd of ``matmul_plain`` on the card, bf16 and f32 (TF32 off), at granite-8b's
    and seamless-m4t-large-v2's training shapes and phase 3's split-k / cp.async
    edges, with the transposed operands each backward copied, by path
    (``matmul.TRANSPOSE_COPIES``: a bf16 backward on the TMA path reads rhs^T
    and lhs2^T in place and copies none); then each of the three GEMMs of every
    granite projection timed with CUDA events beside its bound, the plain
    version and torch.matmul (bf16: the gradients on the transposed views, as
    the backward passes them; f32: on copies, as its kernel reads them), and
    what a transpose copy costs; and where build/parent holds the parent
    commit, its f32 kernel against this one in turns (``scripts/gemm_ab.py
    --f32``), and its bf16 kernel at the training shapes (``--train``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device="cuda").manual_seed(25)
    cases = [((TRAIN_BATCH, TRAIN_ROWS // TRAIN_BATCH), k, n, False) for k, n in GRANITE_KN + SEAMLESS_KN]
    cases += [((m,), k, n, False) for m, k, n in SPLIT_SHAPES] + [((4,), 4096, 1024, True)]
    worst = {name: {"rel": 0.0, "abs": 0.0} for name in dt}  # held to phase 3's TOL by type pair
    exact = {"kernel": 0.0, "plain": 0.0, "where": None}  # f32: the largest reduction's errors against f64
    rt = _train_runtime("chip_smoke[25a]")
    launches_per_case = []
    copies_by_case = {}  # (dtype, k, n) -> transposed operands the case's backward copied
    mm.reset_launches()
    ops.GRAD_GEMMS.clear()
    with rt.activate():
        for lead, k, n, misaligned in cases:
            a32 = torch.randn(*lead, k, device="cuda", generator=g)
            b32 = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
            gout = torch.randn(*lead, n, device="cuda", generator=g)
            for name, dtype in dt.items():
                out_dtype = torch.float32 if (k, n) in VOCAB_KN else dtype  # the head's f32 logits
                a, b = a32.to(dtype), b32.to(dtype)
                if misaligned:
                    a = _misaligned(torch, a)
                a.requires_grad_(True)
                b.requires_grad_(True)
                before, copied = mm.total_launches(), sum(mm.TRANSPOSE_COPIES.values())
                out = ops.matmul(a, b, out_dtype=out_dtype)
                ga, gb = torch.autograd.grad(out, (a, b), gout.to(out_dtype))
                torch.cuda.synchronize()
                launches_per_case.append(mm.total_launches() - before)
                if len(lead) == 2:  # the training shapes
                    copies_by_case[(name, k, n)] = sum(mm.TRANSPOSE_COPIES.values()) - copied
                ap, bp = a.detach().requires_grad_(True), b.detach().requires_grad_(True)
                want = mm.matmul_plain(ap.reshape(-1, k), bp, out_dtype).reshape(*lead, n)
                wa, wb = torch.autograd.grad(want, (ap, bp), gout.to(out_dtype))
                where = f"{name} {lead + (k,)} @ {(k, n)}{' (misaligned base)' if misaligned else ''}"
                for what, got, ref, k_red in (("out", out, want, k), ("grad_lhs", ga, wa, n),
                                              ("grad_rhs", gb, wb, a.numel() // k)):
                    require(got.dtype == ref.dtype and got.shape == ref.shape, f"{where} {what}: {got.dtype} "
                            f"{tuple(got.shape)} against {ref.dtype} {tuple(ref.shape)}")
                    err = (got.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    tol = TOL[(name, "bf16")] if got.dtype == torch.bfloat16 else (
                        TOL[("bf16", "f32")] if name == "bf16" else mm.f32_limit(k_red))
                    require(err / scale <= tol, f"{where} {what}: rel err {err / scale:.3g} > {tol:.3g}")
                    w = worst[name]
                    w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                    if name == "f32" and k_red > mm.F32_K_ANCHOR:
                        a64, b64 = a.detach().reshape(-1, k).double(), b.detach().double()
                        g64 = gout.reshape(-1, n).double()
                        e64 = {"out": lambda: a64 @ b64, "grad_lhs": lambda: g64 @ b64.t(),
                               "grad_rhs": lambda: a64.t() @ g64}[what]().reshape(got.shape)
                        scale64 = e64.abs().max().item()
                        errs = [(t.double() - e64).abs().max().item() / scale64 for t in (got, ref)]
                        require(errs[0] <= tol, f"{where} {what}: rel err {errs[0]:.3g} against f64 > {tol:.3g}")
                        if k_red >= (exact["k"] if exact["where"] else 0):
                            exact.update(kernel=errs[0], plain=errs[1], where=f"{where} {what}", k=k_red, tol=tol)
                        del a64, b64, g64, e64
    paths = dict(mm.PATH_LAUNCHES)
    split_f32 = mm.SPLIT_LAUNCHES["simt_f32"]
    counts = dict(ops.GRAD_GEMMS)
    copies, reads = dict(mm.TRANSPOSE_COPIES), dict(mm.TRANSPOSED_READS)
    require(all(copies_by_case[(name, k, n)] == (2 if name == "f32" else 0) for name in dt for k, n in GRANITE_KN),
            f"transposed operands copied by the training shapes' backward: {copies_by_case}")
    require(all(c == 3 for c in launches_per_case), f"launches per forward + backward {launches_per_case}, want 3")
    require(split_f32 > 0, f"no f32 training GEMM split k: {dict(mm.SPLIT_LAUNCHES)}")
    require(counts == {"forward": 2 * len(cases), "grad_lhs": 2 * len(cases), "grad_rhs": 2 * len(cases)},
            f"gradient GEMMs by phase {counts}")
    require(all(paths.values()), f"a GEMM path saw no training launch: {paths}")
    print(f"  {len(cases)} shapes (granite-8b's {len(GRANITE_KN)} and seamless's {len(SEAMLESS_KN)} at {TRAIN_ROWS} "
          f"rows, {len(cases) - len(GRANITE_KN) - len(SEAMLESS_KN)} edges) x (bf16, f32): forward, grad_lhs and "
          f"grad_rhs through matmul.cu, 3 launches each "
          f"(by phase {counts}; by path {paths}); worst rel err bf16 {worst['bf16']['rel']:.3g} (limits "
          f"{TOL[('bf16', 'bf16')]} bf16 out, {TOL[('bf16', 'f32')]} f32 out), f32 {worst['f32']['rel']:.3g} (limit "
          f"{mm.f32_limit(0)} up to K = {mm.F32_K_ANCHOR}, x sqrt(K / {mm.F32_K_ANCHOR}) above); against an f64 "
          f"product at {exact['where']} (K = {exact.get('k')}): kernel {exact['kernel']:.3g}, torch.matmul f32 "
          f"{exact['plain']:.3g} (limit {exact.get('tol', 0):.3g})); f32 launches that split k: {split_f32} of "
          f"{paths['simt_f32']}; transposed operands copied by path {copies} (the training shapes' bf16 backward: "
          f"{sum(v for (d, _, _), v in copies_by_case.items() if d == 'bf16')}), read in place {reads}")

    rows = []
    for name, dtype in dt.items():
        peak = BF16_FLOPS if name == "bf16" else F32_FLOPS
        size = 2 if name == "bf16" else 4
        n_runs = 20 if name == "bf16" else 5
        for k, n in GRANITE_KN:
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else dtype
            out_size = 4 if out_dtype == torch.float32 else size
            x = torch.randn(TRAIN_ROWS, k, device="cuda", generator=g).to(dtype)
            w = torch.randn(k, n, device="cuda", generator=g).to(dtype)
            gy = torch.randn(TRAIN_ROWS, n, device="cuda", generator=g).to(dtype)
            # The backward's operands as it passes them: bf16 views read in place, f32 copies.
            wt, xt = (w.t(), x.t()) if name == "bf16" else (w.t().contiguous(), x.t().contiguous())
            gemms = {  # (lhs, rhs, out dtype): the forward and the two GEMMs of its backward
                "forward": (x, w, out_dtype), "grad_lhs": (gy, wt, dtype), "grad_rhs": (xt, gy, dtype)}
            row = {"dtype": name, "m": TRAIN_ROWS, "k": k, "n": n, "backward_copies": copies_by_case[(name, k, n)]}
            for what, (lhs, rhs, od) in gemms.items():
                mm_, kk = lhs.shape
                nn = rhs.shape[1]
                flops = 2 * mm_ * kk * nn
                nbytes = (mm_ * kk + kk * nn) * size + mm_ * nn * (4 if od == torch.float32 else size)
                row[what] = {
                    "mkn": (mm_, kk, nn),
                    "ms": _time_ms(lambda i: mm.matmul_cuda(lhs, rhs, out_dtype=od), n_runs=n_runs),
                    "kernel": "persistent" if name == "bf16" and mm.uses_persistent(mm_, nn, kk, mm.DEFAULT_CONFIG)
                    else "ring" if name == "bf16" else "simt_f32",
                    "plain_ms": _time_ms(lambda i: mm.matmul_plain(lhs, rhs, od), n_runs=n_runs),
                    "library_ms": _time_ms(lambda i: torch.matmul(lhs, rhs).to(od), n_runs=n_runs),
                    "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                    "bound_by": "operations" if flops / peak >= nbytes / HBM_BYTES_PER_S else "bytes",
                }
            row["copies_ms"] = {
                "rhs_t": _time_ms(lambda i: w.t().contiguous(), n_runs=n_runs),
                "lhs_t": _time_ms(lambda i: x.t().contiguous(), n_runs=n_runs),
                "bound_ms": {"rhs_t": 2 * k * n * size / HBM_BYTES_PER_S * 1e3,
                             "lhs_t": 2 * TRAIN_ROWS * k * size / HBM_BYTES_PER_S * 1e3},
            }
            rows.append(row)
            print(f"  {name} (1024, {k}) @ ({k}, {n}): " + "; ".join(
                f"{what} {row[what]['ms']:.3f} ms (bound {row[what]['bound_ms']:.3f} {row[what]['bound_by']}, plain "
                f"{row[what]['plain_ms']:.3f}, torch.matmul {row[what]['library_ms']:.3f})" for what in gemms)
                + f"; transposes rhs {row['copies_ms']['rhs_t']:.3f} / lhs {row['copies_ms']['lhs_t']:.3f} ms")
            del x, w, gy, wt, xt
    per_layer = {}
    for name in dt:
        by_kn = {(r["k"], r["n"]): r for r in rows if r["dtype"] == name}
        per_layer[name] = {key: [sum(c * by_kn[kn][what][key] for kn, c in GRANITE_LAYER_GEMMS.items())
                                 for what in ("forward", "grad_lhs", "grad_rhs")]
                           for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
        per_layer[name]["transposes_ms"] = sum(c * (by_kn[kn]["copies_ms"]["rhs_t"] + by_kn[kn]["copies_ms"]["lhs_t"])
                                               * (by_kn[kn]["backward_copies"] > 0)
                                               for kn, c in GRANITE_LAYER_GEMMS.items())
        per_layer[name]["over_library"] = [ms / lib for ms, lib in zip(per_layer[name]["ms"],
                                                                        per_layer[name]["library_ms"])]
        print(f"  {name}, one granite-8b layer's 7 GEMMs at {TRAIN_ROWS} rows (the rows above summed), forward / "
              f"grad_lhs / grad_rhs ms: " + "; ".join(
                  f"{key} " + " / ".join(f"{v:.3f}" for v in per_layer[name][key])
                  for key in ("ms", "bound_ms", "plain_ms", "library_ms", "over_library"))
              + f"; the backward's transposes {per_layer[name]['transposes_ms']:.3f} ms (copies a layer's backward "
                f"makes: {sum(c * by_kn[kn]['backward_copies'] for kn, c in GRANITE_LAYER_GEMMS.items())})")
    parent = None
    base = ROOT / "build" / "parent"
    if (base / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu").is_file():
        sys.path.insert(0, str(ROOT / "scripts"))
        import gemm_ab

        parent = gemm_ab.run_f32_turns(base)
        gemm_ab.report_f32(parent)
        parent["layer_sums"] = gemm_ab.f32_layer_sums(parent)
        parent_bf16 = gemm_ab.run_train_turns(base)
        gemm_ab.report_train(parent_bf16)
    else:
        parent_bf16 = None
        print("  no build/parent: the parent's f32 and bf16 training kernels are not measured in this run")
    return {"worst": worst, "f32_against_f64": exact, "granite_layer": per_layer, "launches": sum(launches_per_case),
            "by_phase": counts, "paths": paths, "split_f32_launches": split_f32, "cases": len(cases), "rows": rows,
            "transpose_copies": copies, "transposed_reads": reads,
            "backward_copies_by_case": {f"{d} {k}x{n}": v for (d, k, n), v in copies_by_case.items()},
            "parent_f32_ab": parent, "parent_bf16_train_ab": parent_bf16}


def _train_cfg(arch: str, **kw):
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get(arch), **kw)


def _grads_nonzero(torch, grads: dict) -> dict:
    from repro_torch.optim import adamw

    out = {}
    for path, g in adamw.trainable(grads):
        require(bool(torch.isfinite(g).all()), f"gradient of {path} is not finite")
        out[path] = g.abs().max().item()
    zero = [p for p, v in out.items() if v == 0.0]
    require(not zero, f"parameters with a zero gradient (dropped through a kernel?): {zero}")
    return out


def _gemms_per_step(model) -> int:
    """GEMM launches a remat-"full" train step makes: each GEMM of the forward, each
    layer GEMM again in its recompute, and two more per GEMM in the backward (the
    gradient of the first GEMM's input included: it flows on to the norms)."""
    c = model.cfg
    if type(model).__name__ == "EncDecLM":
        layers = 7 * c.n_enc_layers + 11 * c.n_layers
    else:
        layers = 7 * c.n_layers
    return (layers + 1) + layers + 2 * (layers + 1)


# GEMMs of a granite-8b layer by (k, n): Q and O, K and V, gate and up, down; the head once a step.
GRANITE_LAYER_GEMMS = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}


def _step_gemm_ms(rows: list, dtype: str, n_layers: int) -> tuple[float, float]:
    """A remat-"full" granite-8b step's GEMM device time from 25a's CUDA-event times
    (each layer GEMM forward twice, the recompute, and both gradients; the head's
    three), and the time of the transpose copies its backward makes."""
    by_kn = {(r["k"], r["n"]): r for r in rows if r["dtype"] == dtype}
    gemm = lambda kn: (2 * by_kn[kn]["forward"]["ms"] + by_kn[kn]["grad_lhs"]["ms"] + by_kn[kn]["grad_rhs"]["ms"]
                       - (by_kn[kn]["forward"]["ms"] if kn == (4096, 49152) else 0.0))
    copies = lambda kn: (by_kn[kn]["copies_ms"]["rhs_t"] + by_kn[kn]["copies_ms"]["lhs_t"]) * (
        by_kn[kn]["backward_copies"] > 0)  # a bf16 backward reads both in place
    counts = {kn: n_layers * c for kn, c in GRANITE_LAYER_GEMMS.items()} | {(4096, 49152): 1}
    return sum(c * gemm(kn) for kn, c in counts.items()), sum(c * copies(kn) for kn, c in counts.items())


def _live_cuda(torch, top: int = 6) -> dict:
    """What is allocated on the card between phases: ``memory_allocated``, the bytes
    of the CUDA storages Python objects reach (each storage once), the kernels'
    cached workspaces among them, and the largest storages by shape and dtype with
    the module global that holds each where one does (else None)."""
    gc.collect()
    storages = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            st = obj.untyped_storage()
            storages.setdefault(st.data_ptr(), (st.nbytes(), obj))
    held = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") or name in ("__main__", "chip_smoke"):
            for attr, val in list(vars(mod).items()):
                for t in (val.values() if isinstance(val, dict) else [val]):
                    for x in (t if isinstance(t, (tuple, list)) else [t]):
                        if isinstance(x, torch.Tensor) and x.is_cuda:
                            held.setdefault(x.untyped_storage().data_ptr(), f"{name}.{attr}")
    workspaces = sum(n for ptr, (n, _) in storages.items() if held.get(ptr, "").endswith("._WORKSPACE"))
    largest = sorted(storages.items(), key=lambda kv: -kv[1][0])[:top]
    return {"allocated": torch.cuda.memory_allocated(), "python_reachable": sum(n for n, _ in storages.values()),
            "storages": len(storages), "workspaces": workspaces,
            "largest": [{"bytes": n, "shape": list(t.shape), "dtype": str(t.dtype), "held_by": held.get(ptr)}
                        for ptr, (n, t) in largest]}


def phase_train_granite(torch, mm, ops, grad_rows: list) -> dict:
    """25b: granite-8b at full width (d 4096, ff 14336, vocab 49152), 2 layers, f32 as
    the launcher trains: the Trainer for 6 steps at batch 8, seq 128, remat "full";
    every parameter's gradient non-zero; GEMM launches per step from the code; step
    ms, peak memory, the GEMM share of a profiled step; then 3 bf16 steps."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = _train_cfg("granite-8b", n_layers=2)
    _free(torch)
    live = _live_cuda(torch)
    print(f"  allocated before the phase {live['allocated'] / 1e9:.3f} GB: {live['storages']} CUDA storages Python "
          f"reaches hold {live['python_reachable'] / 1e9:.3f} GB (the kernels' workspaces {live['workspaces'] / 1e9:.3f});"
          f" largest " + ", ".join(f"{x['bytes'] / 1e9:.3f} GB {x['dtype']} {x['shape']} ({x['held_by']})"
                                   for x in live["largest"]))
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = ROOT / "build" / "train_ckpt_25b"
    import shutil

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rt = _train_runtime("chip_smoke[25b]")
    out = {"live_before": live}
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        trainer = Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                          adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=6),
                          TrainerConfig(total_steps=6, ckpt_every=1000, ckpt_dir=str(ckpt_dir), log_every=1))
        mm.reset_launches()
        ops.GRAD_GEMMS.clear()
        t0 = time.perf_counter()
        step, params, opt, metrics = trainer.train()
        train_s = time.perf_counter() - t0
        n_params = sum(p.numel() for _, p in adamw.trainable(params))
        launches = mm.total_launches()
        per_step = _gemms_per_step(model)
        by_phase = dict(ops.GRAD_GEMMS)
        require(step == 6 and launches == 6 * per_step, f"GEMM launches {launches} over 6 steps, want 6 x {per_step}"
                                                         f" (by phase {by_phase})")
        require(mm.PATH_LAUNCHES["simt_f32"] == launches, f"f32 training off the SIMT path: {dict(mm.PATH_LAUNCHES)}")
        losses = [h["loss"] for h in trainer.history]
        require(all(map(lambda v: v == v and abs(v) < 1e9, losses)), f"losses {losses}")
        require(losses[-1] < losses[0], f"the loss does not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        times = list(trainer.straggler.times)
        warm_ms = statistics.median(times[1:]) * 1e3
        batch = trainer.pipeline.device_batch(6, device="cuda")
        grads = trainer.step_fn.compute_grads(params, batch)[2]
        norms = _grads_nonzero(torch, grads)
        del grads
        _free(torch)
        mm.reset_launches()
        prof = _profile_window(torch, lambda: trainer.step_fn(params, opt, batch), 1)
        step_launches = mm.total_launches()
        # The wrapper's count is the proof; the profiler may drop records (PERF.md §7), so
        # its kernel count is reported and its GEMM share is a lower bound when it drops.
        require(step_launches == per_step, f"a profiled step: {step_launches} GEMM launches, want {per_step}")
        recorded = prof["count"].get(GEMM_KERNELS, 0)
        gemm_ms = prof["ms"].get(GEMM_KERNELS, 0.0)
        print(f"  granite-8b at full width, 2 of 36 layers, f32: {n_params / 1e9:.3f} B params; Trainer 6 steps at "
              f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ} in {train_s:.1f}s (final checkpoint included); losses "
              f"{[round(v, 4) for v in losses]}")
        print(f"  step ms {[round(t * 1e3, 1) for t in times]} (warm median {warm_ms:.1f}); peak memory "
              f"{peak / 1e9:.2f} GB ({(peak - live['allocated']) / 1e9:.2f} above the phase's start); GEMM launches per step {per_step} = forward + recompute + 2 backward per GEMM "
              f"(by phase over 6 steps {by_phase}); every one of {len(norms)} parameters has a non-zero gradient "
              f"(smallest max |g| {min(norms.values()):.3g})")
        events_ms, copies_ms = _step_gemm_ms(grad_rows, "f32", cfg.n_layers)
        print(f"  estimate, not a measurement of the step: its {per_step} GEMMs summed from 25a's CUDA-event times "
              f"{events_ms:.1f} ms, {events_ms / warm_ms:.1%} of the warm median step; its transpose copies "
              f"{copies_ms:.2f} ms")
        print(f"  profiled step: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, GEMM kernels "
              f"{gemm_ms:.1f} ms ({gemm_ms / prof['wall_ms']:.1%} of the step; {recorded} of {per_step} GEMM kernels "
              f"recorded by the profiler), idle share "
              f"{prof['idle_share']:.1%}; top: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:4]))
        out["f32"] = {"n_params": n_params, "losses": losses, "step_s": times, "warm_step_ms": warm_ms,
                      "train_s": train_s, "peak_bytes": peak, "gemm_launches_per_step": per_step,
                      "by_phase": by_phase, "gemm_launches": launches + step_launches, "grad_max_abs": norms,
                      "profile": prof, "gemm_share": gemm_ms / prof["wall_ms"], "gemm_kernels_recorded": recorded,
                      "gemm_ms": gemm_ms, "gemm_ms_estimate_from_25a": events_ms,
                      "gemm_share_estimate_from_25a": events_ms / warm_ms,
                      "transpose_copies_ms_estimate_from_25a": copies_ms}
        del trainer, params, opt, batch, model
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        _free(torch)

        # bf16: the TMA / wgmma path, 3 steps.
        torch.cuda.reset_peak_memory_stats()
        bf16_base = torch.cuda.memory_allocated()
        model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw.init(params)
        step_fn = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3))
        from repro_torch.data.pipeline import TokenPipeline

        pipe = TokenPipeline(cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
        mm.reset_launches()
        losses, times = [], []
        for i in range(3):
            batch = pipe.device_batch(i, dtype=torch.bfloat16, device="cuda")
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        paths, kernels = dict(mm.PATH_LAUNCHES), dict(mm.TMA_KERNEL_LAUNCHES)
        copies, reads = dict(mm.TRANSPOSE_COPIES), dict(mm.TRANSPOSED_READS)
        require(mm.total_launches() == 3 * per_step and paths["simt_f32"] == 0,
                f"bf16 steps: {mm.total_launches()} launches (want {3 * per_step}), by path {paths}")
        require(not any(copies.values()) and all(reads.values()) and kernels["persistent"] > 0,
                f"bf16 steps: transposed operands copied {copies}, read in place {reads}; TMA kernels {kernels}")
        require(all(v == v for v in losses), f"bf16 losses {losses}")
        gemm_ms, copies_ms = _step_gemm_ms(grad_rows, "bf16", cfg.n_layers)
        out["bf16"] = {"losses": losses, "step_s": times, "paths": paths, "peak_bytes": torch.cuda.max_memory_allocated(),
                       "gemm_launches": mm.total_launches(), "gemm_ms_estimate_from_25a": gemm_ms,
                       "transpose_copies_ms_estimate_from_25a": copies_ms, "tma_kernels": kernels,
                       "transpose_copies": copies, "transposed_reads": reads}
        print(f"  bf16: 3 steps, losses {[round(v, 4) for v in losses]}, step ms {[round(t * 1e3, 1) for t in times]}, "
              f"GEMM launches by path {paths} (TMA by kernel {kernels}; transposed operands read in place {reads}, "
              f"copied {copies}), peak memory {out['bf16']['peak_bytes'] / 1e9:.2f} GB "
              f"({(out['bf16']['peak_bytes'] - bf16_base) / 1e9:.2f} above the {bf16_base / 1e9:.3f} allocated before "
              f"the bf16 model); estimate from "
              f"25a's CUDA-event times: the step's GEMMs {gemm_ms:.2f} ms, its transpose copies {copies_ms:.2f} ms")
        del model, params, opt, step_fn
    _free(torch)
    return out


def phase_train_resume(torch, mm) -> dict:
    """25c: reduced granite-8b (f32) on the card: 6 steps of one Trainer against 3, a
    checkpoint, and 3 more from a Trainer that resumes it."""
    import shutil

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get("granite-8b").reduced()
    root = ROOT / "build" / "train_ckpt_25c"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(sub):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        # eps 1e-4: at 1e-8 an element whose gradient is a cancelling sum takes a full +-lr
        # step of its rounding's sign, so any sum in another order each run would show.
        return Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                       adamw.AdamWConfig(lr=1e-3, eps=1e-4, warmup_steps=2, total_steps=6),
                       TrainerConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(root / sub), log_every=1))

    rt = _train_runtime("chip_smoke[25c]")
    mm.reset_launches()
    with rt.activate():
        t_full = trainer("full")
        _, p_full, o_full, _ = t_full.train()
        trainer("cut").train(stop_after=3)
        t_res = trainer("cut")
        resumed_from = t_res.ckpt.latest_step()
        step, p_res, o_res, _ = t_res.train()
    require(resumed_from == 3 and step == 6 and int(o_res.step) == 6, f"resume: from {resumed_from}, ended {step}")
    worst = 0.0
    for (path, a), (_, b) in zip(adamw.trainable(p_full), adamw.trainable(p_res)):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        np.testing.assert_allclose(b, a, **RESUME_TOL, err_msg=path)
        worst = max(worst, float(np.abs(a - b).max()))
    loss_full = [h["loss"] for h in t_full.history][3:]
    loss_res = [h["loss"] for h in t_res.history]
    require(np.allclose(loss_res, loss_full, rtol=1e-5), f"losses after the resume {loss_res} against {loss_full}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  6 steps against 3 + resume (from step {resumed_from}) + 3: params within {RESUME_TOL} (worst abs "
          f"{worst:.3g}), losses of steps 4-6 {[round(v, 5) for v in loss_res]} against "
          f"{[round(v, 5) for v in loss_full]}; GEMM launches {mm.total_launches()}")
    return {"worst_abs": worst, "losses_full": loss_full, "losses_resumed": loss_res,
            "gemm_launches": mm.total_launches()}


def phase_train_seamless(torch, mm, ops) -> dict:
    """25d: seamless-m4t-large-v2 at its full size (24 + 24 layers, d 1024, vocab
    256206), f32: 3 loss_fn + AdamW steps at batch 8, seq 128, then prefill and 4
    decode steps; seconds and peak memory."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = _train_cfg("seamless-m4t-large-v2")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    rt = _train_runtime("chip_smoke[25d]")
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw.init(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for _, p in adamw.trainable(params))
        step_fn = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3))
        pipe = TokenPipeline(cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
        per_step = _gemms_per_step(model)
        mm.reset_launches()
        ops.GRAD_GEMMS.clear()
        losses, times = [], []
        for i in range(3):
            batch = pipe.device_batch(i, device="cuda")
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        train_launches = mm.total_launches()
        require(train_launches == 3 * per_step, f"GEMM launches {train_launches}, want 3 x {per_step} "
                                                f"(by phase {dict(ops.GRAD_GEMMS)})")
        require(all(v == v and abs(v) < 1e9 for v in losses), f"losses {losses}")
        require(losses[-1] < losses[0], f"the loss does not fall: {losses}")
        train_peak = torch.cuda.max_memory_allocated()
        require(not any(p.requires_grad for _, p in adamw.trainable(params)), "the steps left grad on the params")
        with torch.no_grad():
            t0 = time.perf_counter()
            frames = torch.randn(2, 64, cfg.d_model, device="cuda", generator=torch.Generator(device="cuda")
                                 .manual_seed(1))
            toks = batch["tokens"][:2, :16]
            logits, cache = model.prefill(params, {"tokens": toks, "frames": frames}, 32)
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            decoded = [nxt[:, 0].tolist()]
            for i in range(4):
                logits, cache = model.decode_step(params, cache, nxt, torch.full((2,), 16 + i, device="cuda"))
                nxt = logits[:, -1].argmax(-1, keepdim=True)
                decoded.append(nxt[:, 0].tolist())
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        require(bool(torch.isfinite(logits).all()) and logits.shape == (2, 1, cfg.padded_vocab()),
                f"decode logits {tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  seamless-m4t-large-v2 at full size (24 + 24 layers, d {cfg.d_model}, vocab {cfg.vocab}), f32: "
          f"{n_params / 1e9:.3f} B params, init {init_s:.1f}s; 3 steps at batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
          f"losses {[round(v, 4) for v in losses]}, step s {[round(t, 2) for t in times]}, {per_step} GEMM "
          f"launches a step; peak memory {train_peak / 1e9:.2f} GB training, {peak / 1e9:.2f} GB with the prefill; "
          f"prefill (2 x 16 tokens over 64 frames) + 4 decode steps {serve_s:.2f}s, tokens {decoded}")
    out = {"n_params": n_params, "init_s": init_s, "losses": losses, "step_s": times, "peak_train_bytes": train_peak,
           "peak_bytes": peak, "gemm_launches_per_step": per_step, "gemm_launches": mm.total_launches(),
           "serve_s": serve_s, "decoded": decoded}
    del model, params, opt, step_fn, cache, logits
    _free(torch)
    return out


TRAIN_PARITY = ("granite-8b", "qwen3-moe-235b-a22b", "qwen2.5-32b", "llama-3.2-vision-90b", "seamless-m4t-large-v2",
                "rwkv6-7b", "hymba-1.5b")
PARITY_LAYERS = {"rwkv6-7b": 4, "hymba-1.5b": 4}  # 25e: the recurrent models at 4 layers (Hymba's window layer)


def phase_train_cpu_vs_card(torch, mm) -> dict:
    """25e: one train step's loss and every gradient, card (kernels) against CPU
    (plain), on reduced models in f32 from the same weights and pipeline batch (the
    VLM's image embeddings bf16, as the pipeline gives them); granite-8b also under
    remat "dots" on the card, whose recompute launches no GEMM."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    out = {}
    mm.reset_launches()
    wk.reset_launches()
    ss.reset_launches()
    for arch in TRAIN_PARITY:
        cfg = registry.get(arch).reduced()
        if arch in PARITY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS[arch])
        got, dots = {}, {}
        runs = [("cuda", "full"), ("cpu", "full")] + ([("cuda", "dots")] if arch == "granite-8b" else [])
        for dev, policy in runs:
            model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
            params = model.init(torch.Generator(device="cpu").manual_seed(0))
            if cfg.qkv_bias:
                g = torch.Generator().manual_seed(11)
                for key in ("bq", "bk", "bv"):
                    bias = params["blocks"]["attn"][key]
                    bias.copy_(torch.randn(bias.shape, generator=g) * 0.5)
            batch = TokenPipeline(cfg, DataConfig(global_batch=2, seq_len=32)).device_batch(0, device=dev)
            ops.GRAD_GEMMS.clear()
            L.set_remat_policy(policy)
            try:
                with _train_runtime(f"chip_smoke[25e {arch} {dev} {policy}]").activate():
                    loss, _, grads = make_train_step(model, adamw.AdamWConfig()).compute_grads(params, batch)
            finally:
                L.set_remat_policy("full")
            got[dev, policy] = (float(loss), {p: t.detach().cpu() for p, t in adamw.trainable(grads)})
            if policy == "dots":
                dots = dict(ops.GRAD_GEMMS)
                require("recompute" not in dots and dots.get("saved") == 7 * cfg.n_layers,
                        f"{arch} remat dots on the card: GEMMs by phase {dots}")
        l_cpu, g_cpu = got["cpu", "full"]
        worst = {}
        for (dev, policy), (l_card, g_card) in got.items():
            if dev == "cpu":
                continue
            require(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
                    f"{arch} ({policy}): loss {l_card} on the card, {l_cpu} on the CPU")
            for path, ref in g_cpu.items():
                scale = ref.abs().max().item()
                err = (g_card[path] - ref).abs().max().item() / scale
                tol = 1e-2 if path in BF16_FED else TRAIN_PARITY_TOL
                require(err <= tol, f"{arch} ({policy}) {path}: gradient rel err {err:.3g} > {tol}")
                worst[path] = max(worst.get(path, 0.0), err)
        top = max(worst, key=worst.get)
        l_card = got["cuda", "full"][0]
        out[arch] = {"loss_card": l_card, "loss_cpu": l_cpu, "worst": worst[top], "worst_leaf": top}
        if dots:
            out[arch] |= {"loss_card_dots": got["cuda", "dots"][0], "dots_gemms_by_phase": dots}
        print(f"  reduced {arch}: loss {l_card:.6f} (card) / {l_cpu:.6f} (cpu); every gradient within "
              f"{TRAIN_PARITY_TOL} of the CPU's (relative to its max{'; the 3 bf16-fed cross leaves 1e-2' if cfg.family == 'vlm' else ''}), "
              f"worst {worst[top]:.3g} at {top}" + (f"; remat dots on the card too: loss {got['cuda', 'dots'][0]:.6f}, "
                                                    f"GEMMs by phase {dots}" if dots else ""))
    out["gemm_launches"] = mm.total_launches()
    out["backward_kernel_launches"] = {"wkv": sum(wk.BWD_LAUNCHES.values()), "ssm_scan": sum(ss.BWD_LAUNCHES.values())}
    out["forward_kernel_launches"] = {"wkv": wk.total_launches(), "ssm_scan": ss.total_launches()}
    want = {"wkv": PARITY_LAYERS["rwkv6-7b"], "ssm_scan": PARITY_LAYERS["hymba-1.5b"]}
    require(out["backward_kernel_launches"] == want,
            f"backward kernel launches of the card's steps {out['backward_kernel_launches']}, want {want}")
    return out


# 25f: the recurrences' backward kernels and RWKV6 / Hymba training.
# The backward kernels' limits, relative to each gradient's max |autograd of the plain version|:
# f32 leaves 1e-4, the forward's own limit (both sides sum in f32 in other orders; the kernel is
# also held to f64 autograd of the plain version, whose f32 run's own gap to f64 is printed beside
# it); bf16 leaves (dr, dk, dv, du of bf16 operands) 1e-2, phase 3's bf16 limit: each side rounds
# an f32 gradient to bf16 once (2^-8 relative), so two roundings apart.
BWD_TOL = {"f32": 1e-4, "bf16": 1e-2}
RWKV_TRAIN_SHAPE = (8, 128, 64, 64)  # B, S, H, hd: rwkv6-7b at batch 8, seq 128
WKV_BWD_LONG = (1, 2048, 64, 64)  # one long row: few heads, many chunks (the walk cut into segments)
HYMBA_TRAIN_SHAPE = (8, 128, 1600, 16)  # B, S, d, N: hymba-1.5b at batch 8, seq 128


def _grad_errs(torch, got, ref, exact=None) -> list:
    """Per leaf: (rel err against ``ref``, abs err, dtype, rel err against ``exact`` (f64), the
    f32 reference's own rel err against ``exact``); None where a leaf has no gradient."""
    out = []
    for i, (g, w) in enumerate(zip(got, ref)):
        if w is None:
            require(g is None, f"leaf {i}: a gradient where autograd has none")
            out.append(None)
            continue
        require(g.dtype == w.dtype and g.shape == w.shape, f"leaf {i}: {g.dtype} {tuple(g.shape)} against "
                f"{w.dtype} {tuple(w.shape)}")
        require(bool(torch.isfinite(g).all()), f"leaf {i}: not finite")
        scale = w.float().abs().max().item() or 1.0
        err = (g.float() - w.float()).abs().max().item()
        row = [err / scale, err, "bf16" if g.dtype == torch.bfloat16 else "f32", None, None]
        if exact is not None and exact[i] is not None:  # a gradient that is 0 (dlogw at S 1) compares absolute
            s64 = exact[i].abs().max().item() or 1.0
            row[3] = (g.double() - exact[i]).abs().max().item() / s64
            row[4] = (w.double() - exact[i]).abs().max().item() / s64
        out.append(row)
    return out


def _check_grads(errs, names, where, worst) -> None:
    for name, e in zip(names, errs):
        if e is None:
            continue
        tol = BWD_TOL[e[2]]
        require(e[0] <= tol, f"{where} d{name}: rel err {e[0]:.3g} > {tol}")
        if e[3] is not None:
            require(e[3] <= tol, f"{where} d{name}: rel err against f64 {e[3]:.3g} > {tol}")
        w = worst.setdefault(name, {"rel": 0.0, "abs": 0.0, "rel_f64": 0.0, "plain_rel_f64": 0.0})
        w["rel"], w["abs"] = max(w["rel"], e[0]), max(w["abs"], e[1])
        if e[3] is not None:
            w["rel_f64"], w["plain_rel_f64"] = max(w["rel_f64"], e[3]), max(w["plain_rel_f64"], e[4])


def _worst_text(worst: dict) -> str:
    return "; ".join(f"d{k} {v['rel']:.3g}" + (f" / {v['rel_f64']:.3g}" if v["rel_f64"] else "") for k, v in worst.items())


def _autograd(torch, fn, leaves, cots):
    """Autograd of ``fn`` (a plain version) at ``leaves``: the gradients (None for a None leaf)."""
    used = [t.detach().requires_grad_(True) if t is not None else None for t in leaves]
    outs = fn(*used)
    pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
    live = [t for t in used if t is not None]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], live, [c for _, c in pairs]))
    return [next(grads) if t is not None else None for t in used]


def phase_wkv_backward(torch, wk) -> dict:
    """25f-i: the WKV backward kernel (csrc/wkv_bwd.cu) at every compiled (chunk, hd), bf16 and
    f32 r/k/v, a ragged S and an S below the chunk, with and without an initial state and a
    final-state cotangent, each at the segments the wrapper picks and in one segment: against
    autograd of ``wkv_plain`` on the card (TF32 off) and, for f32, f64 autograd of it; two calls
    bitwise equal; then checked and timed at rwkv6-7b's training shape (one kernel a call, no
    state-gradient workspace) and at the long (1, 2048, 64, 64) call, with the walk's residency;
    where ``build/parent`` exists, the parent's backward in turns (``scripts/wkv_ab.py --bwd``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(27)
    names = ("r", "k", "v", "logw", "u", "state")
    worst, checks = {}, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    for cfg in wk.config_space():
        for hd in (16, 64):
            for dtype in (torch.float32, torch.bfloat16):
                for s, with_state, with_ds in ((2 * cfg.chunk + 3, True, True), (2 * cfg.chunk + 3, False, False),
                                               (max(1, cfg.chunk // 2 - 3), True, False),
                                               (max(1, cfg.chunk // 2 - 3), False, True)):
                    args = list(_wkv_inputs(torch, g, 2, s, 3, hd, dtype, "dist", with_state))
                    do = torch.randn((2, s, 3, hd), device="cuda", generator=g)
                    ds = torch.randn((2, 3, hd, hd), device="cuda", generator=g) if with_ds else None
                    ref = _autograd(torch, wk.wkv_plain, args, (do, ds))
                    exact = None
                    if dtype == torch.float32:
                        exact = _autograd(torch, wk.wkv_plain, [None if t is None else t.double() for t in args],
                                          (do.double(), None if ds is None else ds.double()))
                    n = -(-s // wk.launch_chunk(cfg, s))
                    # The wrapper's segments (a chunk a segment here: 6 heads leave the slots empty),
                    # then all of a head's chunks in one.
                    for seg_len in (None, n):
                        got = wk._backward(*args, do, ds, cfg, None, seg_len)
                        again = wk._backward(*args, do, ds, cfg, None, seg_len)
                        where = (f"{cfg.name()} hd {hd} {dtype} S {s} state={with_state} ds_out={with_ds} "
                                 f"segment length {seg_len or 'by the wrapper'}")
                        require(all(x is None or torch.equal(x, y) for x, y in zip(got, again)),
                                f"{where}: two calls differ")
                        _check_grads(_grad_errs(torch, got, ref, exact), names, where, worst)
                        checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks in {time.perf_counter() - t0:.1f}s ({len(wk.config_space())} chunks x hd 16, 64 x f32, "
          f"bf16 x 4 cases: ragged S with a "
          f"state and a final-state cotangent, ragged S without, S below the chunk with a state, S below with a "
          f"cotangent; each at the wrapper's segments and in one segment), each called twice, bitwise equal; worst "
          f"rel err by leaf against autograd of wkv_plain "
          f"(limits f32 {BWD_TOL['f32']}, bf16 leaves {BWD_TOL['bf16']}) and against f64 (the f32 plain's own "
          f"beside it): " + "; ".join(f"d{k} {v['rel']:.3g} / f64 {v['rel_f64']:.3g} (plain {v['plain_rel_f64']:.3g})"
                                      for k, v in worst.items()))
    out = {"checks": checks, "worst": worst, "timing": []}
    for shape, dtype in ((RWKV_TRAIN_SHAPE, torch.float32), (RWKV_TRAIN_SHAPE, torch.bfloat16),
                         (WKV_BWD_LONG, torch.float32)):
        b, s, h, hd = shape
        args = list(_wkv_inputs(torch, g, b, s, h, hd, dtype, "dist", False))
        do = torch.randn((b, s, h, hd), device="cuda", generator=g)
        _, s_fin, hs = wk.wkv_cuda(*args, config=wk.DEFAULT_WKV_CONFIG, keep_states=True)
        call = lambda: wk.wkv_backward_cuda(*args, do, None, wk.DEFAULT_WKV_CONFIG, (hs, s_fin))
        # Checked as above at the shape the main path gives the kernel, then timed there. Memory
        # beyond the gradients during a call: du's partials, and dS at the segments' ends where
        # the call is cut (the parent's kernel allocated a state-gradient workspace the size of hs).
        where = f"the backward at {shape} {dtype}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before - sum(x.numel() * x.element_size() for x in got
                                                                 if x is not None)
        require(all(x is None or torch.equal(x, y) for x, y in zip(got, call())), f"{where}: two calls differ")
        exact = None
        if dtype == torch.float32:
            exact = _autograd(torch, wk.wkv_plain, [None if t is None else t.double() for t in args],
                              (do.double(), None))
        at_shape: dict = {}
        errs = _grad_errs(torch, got, _autograd(torch, wk.wkv_plain, args, (do, None)), exact)
        _check_grads(errs, names, where, at_shape)
        _check_grads(errs, names, where, worst)
        del got, exact, errs
        size = 2 if dtype == torch.bfloat16 else 4
        n = b * s * h * hd
        # Each input read once (r, k, v, u in their type; logw, do f32), each output written
        # once (dr, dk, dv in r's type, dlogw f32); du is (H, hd). The forward's chunk start
        # states hs are this design's input beside the function's, not counted.
        nbytes = 3 * n * size * 2 + 2 * n * 4 + n * 4 + h * hd * size * 2
        # The recurrent VJP's count, the fewest for this function: per token and head, the state's
        # gradient dS = w (.) dS + r^T do (3 hd^2), dr = S do (2 hd^2), dk = dS v (2 hd^2),
        # dv = dS^T k (2 hd^2), dlogw = sum_j S dS (2 hd^2), the u-bonus's (8 hd).
        ops_n = b * s * h * (11 * hd * hd + 8 * hd)
        bound = max(nbytes / HBM_BYTES_PER_S, ops_n / F32_FLOPS) * 1e3
        ms = _time_ms(lambda i: call())
        leaves = [t.detach().requires_grad_(True) for t in args[:5]]
        o, _ = wk.wkv_plain(*leaves)
        plain = _time_ms(lambda i: torch.autograd.grad(o, leaves, do, retain_graph=True), n_runs=5)
        launches = _kernel_launches(call, ("wkv_bwd_walk_kernel", "wkv_bwd_state_kernel"))
        # The walk's residency and segments at this shape.
        chunk = wk.launch_chunk(wk.DEFAULT_WKV_CONFIG, s)
        res = wk.bwd_residency(wk.WkvConfig(chunk), hd, 0, dtype == torch.bfloat16, args[4].dtype == torch.float32)
        n_chunks = -(-s // chunk)
        seg_len = wk.bwd_segment_len(b * h, n_chunks, sms, res["ctas"])
        n_seg = -(-n_chunks // seg_len)
        grid = b * h * n_seg
        if shape == RWKV_TRAIN_SHAPE:
            require(n_seg == 1 and (launches is None or launches == {"wkv_bwd_walk_kernel": 1.0,
                                                                      "wkv_bwd_state_kernel": 0.0}),
                    f"{where}: want one walk kernel a call, got {n_seg} segments, kernels {launches}")
            require(extra < 1 << 20, f"{where}: {extra} bytes beyond the gradients (a workspace?)")
        row = {"dtype": str(dtype).split(".")[-1], "shape": [b, s, h, hd], "config": wk.DEFAULT_WKV_CONFIG.name(),
               "ms": ms, "plain_autograd_ms": plain, "bound_ms": bound, "bytes": nbytes, "ops": ops_n,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops_n / F32_FLOPS else "operations",
               "kernel_launches_per_call": launches, "worst": at_shape, **res, "threads": 256,
               "smem_bytes": wk.WkvConfig(chunk).bwd_smem_bytes(hd), "grid": grid,
               "waves": grid / (sms * res["ctas"]), "segments": n_seg, "extra_bytes": extra}
        out["timing"].append(row)
        print(f"  at {shape} {row['dtype']}, {row['config']}: two calls bitwise "
              f"equal; worst rel err by leaf against autograd of wkv_plain (/ f64): {_worst_text(at_shape)}; "
              f"backward {ms:.4f} ms, bound {bound:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
              f"{ops_n / 1e9:.2f} Gop f32); autograd of wkv_plain {plain:.3f} ms; kernels per call {launches}; "
              f"library: none; {res['registers']} registers and {res['local_bytes']} spilled bytes a thread, 256 "
              f"threads and {row['smem_bytes']} bytes of shared memory a CTA, {res['ctas']} CTAs an SM, grid {grid} "
              f"= {row['waves']:.2f} waves, {n_seg} segment(s); {extra} bytes allocated beyond the gradients")
        del args, do, hs, s_fin, leaves, o
    out["parent_ab"] = phase_bwd_parent_ab("wkv_ab", "wkv_bwd.cu")
    return out


def phase_bwd_parent_ab(script: str, source: str) -> dict | None:
    """The parent's backward kernel against this one, in turns (``scripts/<script>.py --bwd``:
    parent, this, this, parent), where build/parent holds the parent's tree with ``source``."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / source).is_file():
        print("  no build/parent: the parent's backward kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    ab = importlib.import_module(script)

    print(f"  the parent's backward against this one, in turns (parent, this, this, parent; scripts/{script}.py --bwd):")
    result = ab.run_bwd_turns(base)
    ab.report_bwd(result)
    return result


def phase_ssm_backward(torch, ss) -> dict:
    """25f-ii: the scan's backward kernel (csrc/ssm.cu ssm_bwd_kernel), both entries, at every
    compiled (block_d, chunk) and N 8 and 16, a ragged S and an S below the chunk, with and
    without a state and a final-state cotangent, and a long (1, 2048, 1600, 16) call (the
    backward walks its own forward, so the forward's segments do not arise): against autograd
    of the plain versions on the card and f64 autograd; two calls bitwise equal; then both
    entries checked as that and timed at hymba-1.5b's training shape."""
    g = torch.Generator(device="cuda").manual_seed(28)
    entries = {"fused": (_ssm_fused_inputs, ss.ssm_fused_plain, ss.ssm_fused_backward_cuda,
                         ("x", "dt", "a", "b", "c", "state")),
               "dta": (_ssm_inputs, ss.ssm_plain, ss.ssm_backward_cuda, ("dtx", "dta", "b", "c", "state"))}
    worst, checks = {}, 0
    cases = [(cfg, n, s, with_state, with_ds) for cfg in ss.config_space() for n in (8, 16)
             for s, with_state, with_ds in ((3 * cfg.chunk + 5, True, True), (3 * cfg.chunk + 5, False, False),
                                            (cfg.chunk // 2 + 1, True, False), (cfg.chunk // 2 + 1, False, True))]
    cases.append((ss.DEFAULT_SSM_CONFIG, 16, SSM_LONG, True, True))
    t0 = time.perf_counter()

    def check(entry, cfg, args, dy, ds, where, into) -> None:
        """The kernel's gradients at ``args``, called twice (bitwise equal), held against autograd
        of the plain version and its f64 autograd; the worst errors go into each dict of ``into``."""
        _, plain, kernel, names = entries[entry]
        got = kernel(*args, dy, ds, cfg)
        require(all(x is None or torch.equal(x, y) for x, y in zip(got, kernel(*args, dy, ds, cfg))),
                f"{where}: two calls differ")
        ref = _autograd(torch, plain, args, (dy, ds))
        exact = _autograd(torch, plain, [None if t is None else t.double() for t in args],
                          (dy.double(), None if ds is None else ds.double()))
        errs = _grad_errs(torch, got, ref, exact)
        for w in into:
            _check_grads(errs, [f"{entry}:{x}" for x in names], where, w)

    for cfg, n, s, with_state, with_ds in cases:
        b, d = (1, 1600) if s == SSM_LONG else (2, 100)
        for entry, (inputs, *_) in entries.items():
            if s == SSM_LONG and entry == "dta":
                continue  # the long call through the fused entry, the one a Hymba layer runs
            args = list(inputs(torch, g, b, s, d, n, with_state))
            dy = torch.randn((b, s, d), device="cuda", generator=g)
            ds = torch.randn((b, d, n), device="cuda", generator=g) if with_ds else None
            check(entry, cfg, args, dy, ds, f"{entry} {cfg.name()} N {n} S {s} state={with_state} ds_out={with_ds}",
                  (worst,))
            checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks in {time.perf_counter() - t0:.1f}s (both entries x {len(ss.config_space())} configs x "
          f"N 8, 16 x 4 cases, and the fused entry at (1, {SSM_LONG}, 1600, 16) under "
          f"{ss.DEFAULT_SSM_CONFIG.name()}), each called twice, bitwise equal; worst rel err by leaf against "
          f"autograd of the plain version (limit {BWD_TOL['f32']}) and against f64 (the f32 plain's own beside it): "
          + "; ".join(f"d{k} {v['rel']:.3g} / f64 {v['rel_f64']:.3g} ({v['plain_rel_f64']:.3g})"
                      for k, v in worst.items()))
    b, s, d, n = HYMBA_TRAIN_SHAPE
    out = {"checks": checks, "worst": worst, "timing": []}
    for entry, (inputs, plain, kernel, _) in entries.items():
        args = list(inputs(torch, g, b, s, d, n, False))
        dy = torch.randn((b, s, d), device="cuda", generator=g)
        call = lambda: kernel(*args, dy, None, ss.DEFAULT_SSM_CONFIG)
        # Checked as above at the shape the main path gives the kernel, then timed there.
        at_shape: dict = {}
        check(entry, ss.DEFAULT_SSM_CONFIG, args, dy, None, f"{entry} at hymba-1.5b's training shape "
              f"{HYMBA_TRAIN_SHAPE}", (at_shape, worst))
        rows = b * s
        if entry == "fused":  # x, dt, dy in; dx, d(dt) out; a, da; b, c, db, dc
            nbytes = (3 * rows * d + 2 * rows * d + 2 * d * n + 4 * rows * n) * 4
        else:  # dtx, dy, dta in; d(dtx), d(dta) out; b, c, db, dc
            nbytes = (2 * rows * d + rows * d * n + rows * d + rows * d * n + 4 * rows * n) * 4
        # Per (t, channel, state): the forward recomputed (exp, 2 ops), dh (2), d(dta) (2 + exp),
        # d(dtx) (2), db (2), dc (2), and the fused entry's da and d(dt) (4): ~20.
        ops_n = rows * d * n * 20
        bound = max(nbytes / HBM_BYTES_PER_S, ops_n / F32_FLOPS) * 1e3
        ms = _time_ms(lambda i: call())
        leaves = [t.detach().requires_grad_(True) for t in args[:-1]]
        y, _ = plain(*leaves)
        plain_ms = _time_ms(lambda i: torch.autograd.grad(y, leaves, dy, retain_graph=True), n_warm=1, n_runs=3)
        launches = _kernel_launches(call, ("ssm_bwd_kernel",))
        # The compiled kernel's residency at this shape: registers, CTAs an SM, waves of its grid.
        res = ss.bwd_residency(ss.DEFAULT_SSM_CONFIG, n, entry == "fused", 0)
        grid = b * -(-d // ss.DEFAULT_SSM_CONFIG.block_d)
        waves = grid / (torch.cuda.get_device_properties(0).multi_processor_count * res["ctas"])
        row = {"entry": entry, "shape": [b, s, d, n], "config": ss.DEFAULT_SSM_CONFIG.name(), "ms": ms,
               "plain_autograd_ms": plain_ms, "bound_ms": bound, "bytes": nbytes, "ops": ops_n,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops_n / F32_FLOPS else "operations",
               "kernel_launches_per_call": launches, "worst": at_shape, **res, "grid": grid, "waves": waves,
               "threads": ss.DEFAULT_SSM_CONFIG.bwd_threads(n),
               "smem_bytes": ss.DEFAULT_SSM_CONFIG.bwd_smem_bytes(n, entry == "fused")}
        out["timing"].append(row)
        print(f"  {entry} entry at hymba-1.5b's training shape {HYMBA_TRAIN_SHAPE}, {row['config']}: two calls "
              f"bitwise equal; worst rel err by leaf against autograd of the plain version (/ f64): "
              f"{_worst_text(at_shape)}; backward {ms:.4f} ms, bound {bound:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB); autograd of the plain version {plain_ms:.2f} ms; kernels per call {launches}; "
              f"library: none; {res['registers']} registers and {res['local_bytes']} spilled bytes a thread, "
              f"{row['threads']} threads and {row['smem_bytes']} bytes of shared memory a CTA, {res['ctas']} CTAs an "
              f"SM, grid {grid} = {waves:.2f} waves")
        del args, dy, leaves, y
    out["parent_ab"] = phase_bwd_parent_ab("ssm_ab", "ssm.cu")
    return out


# GEMMs a layer of the recurrent models' training forward (as their serving forward: rwkv6-7b
# r, k, v, g, wd1, wd2, o, ck, cv, cr; hymba-1.5b q, k, v, o, in, dt1, dt2, b, c, out, gate, up, down).
LAYER_GEMMS = {"rwkv6-7b": 10, "hymba-1.5b": 13, "qwen3-moe-235b-a22b": 5}  # an MoE layer: Q, K, V, O, router
RECURRENCE = {"rwkv6-7b": ("wkv", ("wkv_bwd_walk_kernel", "wkv_bwd_state_kernel")),
              "hymba-1.5b": ("ssm_scan_fused", ("ssm_bwd_kernel",))}


def _bwd_launches(wk, ss) -> int:
    return sum(wk.BWD_LAUNCHES.values()) + sum(ss.BWD_LAUNCHES.values())


def phase_train_recurrent(torch, mm, wk, ss, ops, arch: str, n_layers: int, bf16_steps: int) -> dict:
    """25f-iii / iv: ``arch`` at full width (``n_layers`` deep), f32 as the launcher trains: the
    Trainer for 6 steps at batch 8, seq 128, remat "full"; the loss falls, every parameter's
    gradient is non-zero; per step each layer's recurrence runs forward, recompute and backward
    (its forward kernel twice, its backward kernel once) and never refuses; GEMM launches per
    step from the code; warm step ms, peak memory, one profiled step's share of the backward
    kernels; then ``bf16_steps`` bf16 steps."""
    import shutil

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    op, bwd_kernels = RECURRENCE[arch]
    cfg = _train_cfg(arch, n_layers=n_layers)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = ROOT / "build" / f"train_ckpt_25f_{arch}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rt = _train_runtime(f"chip_smoke[25f {arch}]")
    gemms = (LAYER_GEMMS[arch] * n_layers + 1) * 4 - 1  # forward, recompute (not the head), 2 backward each
    out = {"n_layers": n_layers}
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        trainer = Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                          adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=6),
                          TrainerConfig(total_steps=6, ckpt_every=1000, ckpt_dir=str(ckpt_dir), log_every=1))
        mm.reset_launches()
        wk.reset_launches()
        ss.reset_launches()
        ops.GRAD_SCANS.clear()
        ops.GRAD_GEMMS.clear()
        t0 = time.perf_counter()
        step, params, opt, _ = trainer.train()
        train_s = time.perf_counter() - t0
        fwd = wk.total_launches() + ss.total_launches()
        bwd = _bwd_launches(wk, ss)
        by_phase = ops.grad_scans(op)
        n_params = sum(p.numel() for _, p in adamw.trainable(params))
        require(step == 6 and by_phase == {"forward": 6 * n_layers, "recompute": 6 * n_layers,
                                           "backward": 6 * n_layers}, f"{op} calls by phase over 6 steps {by_phase}")
        require(fwd == 12 * n_layers and bwd == 6 * n_layers,
                f"{arch}: forward kernel launches {fwd} (want {12 * n_layers}), backward {bwd} (want {6 * n_layers})")
        require(mm.total_launches() == 6 * gemms, f"GEMM launches {mm.total_launches()}, want 6 x {gemms} "
                                                  f"(by phase {dict(ops.GRAD_GEMMS)})")
        losses = [h["loss"] for h in trainer.history]
        require(all(v == v and abs(v) < 1e9 for v in losses) and losses[-1] < losses[0], f"losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        times = list(trainer.straggler.times)
        warm_ms = statistics.median(times[1:]) * 1e3
        batch = trainer.pipeline.device_batch(6, device="cuda")
        grads = trainer.step_fn.compute_grads(params, batch)[2]
        norms = _grads_nonzero(torch, grads)
        del grads
        _free(torch)
        wk.reset_launches()
        ss.reset_launches()
        prof = _profile_window(torch, lambda: trainer.step_fn(params, opt, batch), 1)
        prof_bwd = _bwd_launches(wk, ss)
        require(prof_bwd == n_layers, f"a profiled step: {prof_bwd} backward kernel launches, want {n_layers}")
        names = {_kernel_name(k) for k in bwd_kernels}
        bwd_ms = sum(prof["ms"].get(k, 0.0) for k in names)
        fwd_ms = sum(v for k, v in prof["ms"].items() if k.startswith(("wkv (", "ssm_scan (")))
        recorded = sum(prof["count"].get(k, 0) for k in names)
        print(f"  {arch} at full width (d {cfg.d_model}), {n_layers} of {_train_cfg(arch).n_layers} layers, f32: "
              f"{n_params / 1e9:.3f} B params; Trainer 6 steps at batch {TRAIN_BATCH} x seq {TRAIN_SEQ} in "
              f"{train_s:.1f}s; losses {[round(v, 4) for v in losses]}")
        print(f"  step ms {[round(t * 1e3, 1) for t in times]} (warm median {warm_ms:.1f}); peak memory "
              f"{peak / 1e9:.2f} GB; {op} calls by phase over 6 steps {by_phase} (forward kernel {fwd}, backward "
              f"kernel {bwd} launches); GEMM launches per step {gemms}; every one of {len(norms)} parameters has a "
              f"non-zero gradient (smallest max |g| {min(norms.values()):.3g}); no NoBackwardKernelError")
        print(f"  profiled step: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms; backward "
              f"kernels {bwd_ms:.2f} ms ({bwd_ms / prof['wall_ms']:.2%} of the step; {recorded} kernels recorded), "
              f"forward kernels {fwd_ms:.2f} ms, GEMM kernels {prof['ms'].get(GEMM_KERNELS, 0.0):.1f} ms; top: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:4]))
        out["f32"] = {"n_params": n_params, "losses": losses, "step_s": times, "warm_step_ms": warm_ms,
                      "train_s": train_s, "peak_bytes": peak, "by_phase": by_phase, "forward_kernel_launches": fwd,
                      "backward_kernel_launches": bwd + prof_bwd, "gemm_launches_per_step": gemms,
                      "grad_max_abs": norms, "profile": prof, "backward_kernels_ms": bwd_ms,
                      "backward_share": bwd_ms / prof["wall_ms"], "forward_kernels_ms": fwd_ms}
        del trainer, params, opt, batch, model
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        _free(torch)
        if bf16_steps:
            torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
            opt = adamw.init(params)
            step_fn = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=bf16_steps))
            pipe = TokenPipeline(cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
            wk.reset_launches()
            ss.reset_launches()
            losses, times = [], []
            for i in range(bf16_steps):
                batch = pipe.device_batch(i, dtype=torch.bfloat16, device="cuda")
                t0 = time.perf_counter()
                params, opt, met = step_fn(params, opt, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
            bwd = _bwd_launches(wk, ss)
            fwd = wk.total_launches() + ss.total_launches()
            require(bwd == bf16_steps * n_layers and fwd == 2 * bwd and all(v == v for v in losses),
                    f"bf16 steps: {fwd} forward and {bwd} backward kernel launches, losses {losses}")
            out["bf16"] = {"losses": losses, "step_s": times, "backward_kernel_launches": bwd,
                           "forward_kernel_launches": fwd, "peak_bytes": torch.cuda.max_memory_allocated()}
            print(f"  bf16: {bf16_steps} steps, losses {[round(v, 4) for v in losses]}, step ms "
                  f"{[round(t * 1e3, 1) for t in times]}, backward kernel launches {bwd}, peak memory "
                  f"{out['bf16']['peak_bytes'] / 1e9:.2f} GB")
            del model, params, opt, step_fn
    _free(torch)
    return out


def phase_train_cli(torch) -> dict:
    """25g: ``python -m repro_torch.launch.train`` on the card with phase 17's deployment:
    reduced granite-8b, then reduced rwkv6-7b (its WKV forward and backward kernels at the
    deployment's configs)."""
    import os
    import shutil

    out = {}
    for arch in ("granite-8b", "rwkv6-7b"):
        ckpt = ROOT / "build" / f"train_ckpt_25g_{arch}"
        shutil.rmtree(ckpt, ignore_errors=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--reduced", "--steps", "4",
               "--batch", "2", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", str(ckpt),
               "--deployment", str(DEPLOY_PATH)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        require(proc.returncode == 0, f"launch.train --arch {arch} exited {proc.returncode}: {proc.stderr[-2000:]}")
        require(any("installed kernel deployment" in ln for ln in lines) and "finished at step 4" in lines[-1],
                f"launch.train --arch {arch} output: {lines}")
        steps = sorted(int(p.name.split("_")[1]) for p in ckpt.iterdir() if p.name.startswith("step_"))
        require(steps == [2, 4], f"{arch}: checkpoints {steps}")
        shutil.rmtree(ckpt, ignore_errors=True)
        print(f"  {' '.join(cmd[2:])}: exit 0 in {seconds:.1f}s; checkpoints at steps {steps}; last lines {lines[-2:]}")
        out[arch] = {"seconds": seconds, "stdout": lines, "checkpoints": steps}
    return out


HYMBA_TRAIN_LAYERS = 32  # 25f-iv: hymba-1.5b whole


def phase_training(torch, mm, ops, phase) -> dict:
    """Phase 25 (25a-25g), every plain version refused on a CUDA tensor throughout."""
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    t0 = time.perf_counter()
    restore = _no_plain_on_card(ops)
    out = {}
    try:
        phase("[25a] the GEMM's gradient through matmul.cu: checks against autograd of the plain GEMM, timings")
        out["grad_gemms"] = phase_grad_gemms(torch, mm, ops)
        phase("[25b] granite-8b training at full width (2 of 36 layers), f32 then bf16")
        out["granite"] = phase_train_granite(torch, mm, ops, out["grad_gemms"]["rows"])
        phase("[25c] resume on the card: 6 steps against 3 + resume + 3")
        out["resume"] = phase_train_resume(torch, mm)
        phase("[25d] seamless-m4t-large-v2 at full size: 3 train steps, prefill, 4 decode steps")
        out["seamless"] = phase_train_seamless(torch, mm, ops)
        phase("[25e] one train step, card against CPU: reduced granite-8b (remat full and dots), qwen3-moe, "
              "qwen2.5-32b, llama-vision, seamless")
        out["cpu_vs_card"] = phase_train_cpu_vs_card(torch, mm)
        t25f = time.perf_counter()
        phase("[25f-i] the WKV backward kernel (wkv_bwd.cu) against autograd of wkv_plain, every (chunk, hd); timing")
        out["wkv_backward"] = phase_wkv_backward(torch, wk)
        phase("[25f-ii] the scan backward kernel (ssm.cu ssm_bwd_kernel), both entries, every config; timing")
        out["ssm_backward"] = phase_ssm_backward(torch, ss)
        phase("[25f-iii] rwkv6-7b training at full width (2 of 32 layers), f32 then bf16")
        out["rwkv"] = phase_train_recurrent(torch, mm, wk, ss, ops, "rwkv6-7b", 2, 3)
        phase(f"[25f-iv] hymba-1.5b training, whole ({HYMBA_TRAIN_LAYERS} layers), f32")
        out["hymba"] = phase_train_recurrent(torch, mm, wk, ss, ops, "hymba-1.5b", HYMBA_TRAIN_LAYERS, 0)
        out["seconds_25f"] = time.perf_counter() - t25f
        print(f"  phase 25f in {out['seconds_25f']:.1f}s")
    finally:
        restore()
    phase("[25g] the launcher: python -m repro_torch.launch.train on the card with phase 17's deployment")
    out["cli"] = phase_train_cli(torch)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 25 in {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 26: distribution on the card
# ---------------------------------------------------------------------------
DIST_STEPS = 3
# 26a: the sharded step on a (1, 1) mesh against the unsharded one, relative to each leaf's max
# (and each metric): every rank holds the whole problem, so the same kernels sum in the same order.
DIST_TOL_WORLD1 = 1e-6
# 26b, 26c: two processes against one on the global batch: the data shards' gradients are summed
# by the all-reduce / reduce-scatter in another order than one backward sums them.
DIST_TOL = 1e-5
DIST_LAYERS = {"granite-8b": 2, "rwkv6-7b": 2}
# AdamW's eps at 1e-4, as the CPU tests compare params (tests/test_torch_train.py): at 1e-8 an element
# whose gradient is summation noise takes a full +-lr step of the noise's sign (the embedding's
# scatter-add sums in another order on two processes), so the comparison would hold the noise.
DIST_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=DIST_STEPS, eps=1e-4)
# 26d, 26e: the MoE model at full width, cut to one layer: 3.73 G params, 14.9 GB in f32; with its
# gradients and AdamW moments about 60 GB in one process, 30 GB a process of two on (1, 2).
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 1


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rel(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def _step_gemms(arch: str, model) -> int:
    """GEMM launches of one remat-"full" train step of ``model`` (25b's and 25f's counts)."""
    if arch in LAYER_GEMMS:
        return (LAYER_GEMMS[arch] * model.cfg.n_layers + 1) * 4 - 1
    return _gemms_per_step(model)


def _global_batches(torch, cfg, hosts: int, steps: int) -> list[dict]:
    """Each step's global batch on ``hosts`` data shards (every shard's batch in order), on the card."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import global_batch

    data = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    return [{k: v.to("cuda") for k, v in global_batch(cfg, data, step, hosts).items()} for step in range(steps)]


def _unsharded_steps(torch, cfg, batches: list[dict], *, last_on_host: bool = False):
    """The unsharded train step from the seed-0 init over ``batches``: per step the metrics,
    every trained leaf (a clone on the card; with ``last_on_host`` only after the last step,
    copied to host memory) and the synchronized step seconds."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init(params)
    step_fn = make_train_step(model, adamw.AdamWConfig(**DIST_OPT))
    metrics, leaves, times = [], [], []
    for step, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in met.items()})
        if not last_on_host:
            leaves.append({p: t.detach().clone() for p, t in adamw.trainable(params)})
        elif step == len(batches) - 1:
            leaves.append({p: t.detach().cpu() for p, t in adamw.trainable(params)})
    del params, opt
    return metrics, leaves, times


@contextlib.contextmanager
def _recorded_routes(torch, sharded: bool):
    """Every MoE routing while the context is open, on the host: per call an int64 (3, T k) of
    each assignment's expert, slot and kept flag (a sharded call: this rank's tokens)."""
    from repro_torch.models import moe

    name = "_sharded_route" if sharded else "route"
    original, calls = getattr(moe, name), []

    def record(*args, **kwargs):
        out = original(*args, **kwargs)
        r = out[0] if sharded else out
        calls.append(torch.stack([r.flat_e, r.slot.to(r.flat_e.dtype), r.keep.to(r.flat_e.dtype)]).cpu())
        return out

    setattr(moe, name, record)
    try:
        yield calls
    finally:
        setattr(moe, name, original)


def _routes_differing(got: list, want: list) -> int:
    """Assignments (token, slot) routed to another expert or slot, or kept otherwise, over every call."""
    require(len(got) == len(want) and all(a.shape == b.shape for a, b in zip(got, want)),
            f"routings differ in number or shape: {[tuple(a.shape) for a in got]} against "
            f"{[tuple(b.shape) for b in want]}")
    return sum(int((a != b).any(dim=0).sum()) for a, b in zip(got, want))


def _local_slice(torch, full, t):
    """The part of ``full`` that DTensor ``t``'s local shard holds (each mesh dim's Shard
    splits as ``torch.chunk`` does, in mesh order)."""
    from torch.distributed.tensor import Shard

    coord = t.device_mesh.get_coordinate()
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            full = torch.chunk(full, t.device_mesh.size(i), dim=pl.dim)[coord[i]]
    return full


def phase_moe_reference(torch) -> dict:
    """26d/26e's reference: MOE_ARCH at full width, MOE_LAYERS deep, f32, DIST_STEPS unsharded
    steps on the one data shard's batches, the final leaves in host memory, every routing kept."""
    cfg = _train_cfg(MOE_ARCH, n_layers=MOE_LAYERS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    rt = _train_runtime("chip_smoke[26d reference]")
    with rt.activate(), _recorded_routes(torch, sharded=False) as routes:
        metrics, leaves, times = _unsharded_steps(torch, cfg, _global_batches(torch, cfg, 1, DIST_STEPS),
                                                  last_on_host=True)
    peak = torch.cuda.max_memory_allocated()
    _free(torch)
    cap = max(1, int(TRAIN_BATCH * TRAIN_SEQ * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor))
    kept = [int(r[2].sum()) for r in routes]
    print(f"  {MOE_ARCH}, {cfg.n_layers} of {_train_cfg(MOE_ARCH).n_layers} layers, f32, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, unsharded: losses {[round(m['loss'], 6) for m in metrics]}; step ms "
          f"{[round(t * 1e3, 1) for t in times]}; peak {peak / 1e9:.2f} GB; capacity {cap} an expert; "
          f"{len(routes)} routings (forward and recompute a step), assignments kept {kept} of "
          f"{TRAIN_BATCH * TRAIN_SEQ * cfg.moe.top_k}")
    return {"metrics": metrics, "leaves": leaves[-1], "step_s": times, "peak_bytes": peak, "routes": routes,
            "capacity": cap, "kept": kept}


def phase_dist_moe_world1(torch, mm, mesh, ref: dict) -> dict:
    """26d: MOE_ARCH's Trainer sharded steps on the world-1 NCCL group's (1, 1) mesh against
    ``ref``'s unsharded steps: every metric after each step and every final leaf within
    DIST_TOL_WORLD1 (bitwise equality printed), as 26a; every routing equal."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.commanalysis import CollectiveCounter
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = _train_cfg(MOE_ARCH, n_layers=MOE_LAYERS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    rt = _train_runtime("chip_smoke[26d]")
    counter = CollectiveCounter()
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        trainer = Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                          adamw.AdamWConfig(**DIST_OPT), TrainerConfig(total_steps=DIST_STEPS), mesh=mesh)
        params, opt = trainer.init_state(0)
        mm.reset_launches()
        worst, bitwise, times, metrics = {}, True, [], []
        with _recorded_routes(torch, sharded=True) as routes:
            for step in range(DIST_STEPS):
                t0 = time.perf_counter()
                with counter if step == DIST_STEPS - 1 else contextlib.nullcontext():
                    params, opt, met = trainer.step_fn(params, opt, trainer._batch(step))
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in met.items()})
                for key, want in ref["metrics"][step].items():
                    worst[f"step {step + 1} {key}"] = abs(metrics[-1][key] - want) / max(abs(want), 1e-30)
                    bitwise &= metrics[-1][key] == want
        gemms = mm.total_launches()
        for path, t in adamw.trainable(params):
            want = ref["leaves"][path].to("cuda")
            full = t.full_tensor()
            worst[path] = _rel(torch, full, want)
            bitwise &= bool(torch.equal(full, want))
            del want, full
        per_step = _step_gemms(MOE_ARCH, model)
        peak = torch.cuda.max_memory_allocated()
        del trainer, params, opt, model
    _free(torch)
    differing = _routes_differing(routes, ref["routes"])
    top = max(worst.items(), key=lambda kv: kv[1])
    require(top[1] <= DIST_TOL_WORLD1, f"26d: sharded against unsharded {top[0]} {top[1]:.3g} "
                                       f"(limit {DIST_TOL_WORLD1})")
    require(differing == 0, f"26d: {differing} assignments routed otherwise on (1, 1)")
    require(gemms == DIST_STEPS * per_step, f"26d: {gemms} GEMM launches, want {DIST_STEPS} x {per_step}")
    print(f"  {MOE_ARCH}, {cfg.n_layers} layer, f32, world-1 NCCL group, mesh (1, 1): {DIST_STEPS} sharded steps, "
          f"losses {[round(m['loss'], 6) for m in metrics]}; worst against unsharded {top[0]} {top[1]:.3g} (limit "
          f"{DIST_TOL_WORLD1}); bitwise equal to the unsharded steps: {bitwise}; assignments routed otherwise: "
          f"{differing}")
    print(f"  step ms sharded {[round(t * 1e3, 1) for t in times]}, unsharded "
          f"{[round(t * 1e3, 1) for t in ref['step_s']]}; GEMM launches {gemms} ({per_step} a step); peak "
          f"{peak / 1e9:.2f} GB (unsharded {ref['peak_bytes'] / 1e9:.2f}); the last step's collectives "
          f"{counter.summary()}")
    return {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "metrics": metrics, "ref_metrics": ref["metrics"],
            "worst": worst, "bitwise": bitwise, "step_s": times, "ref_step_s": ref["step_s"], "gemm_launches": gemms,
            "gemm_launches_per_step": per_step, "peak_bytes": peak, "ref_peak_bytes": ref["peak_bytes"],
            "routes_differing": differing, "collectives_last_step": counter.summary()}


def phase_dist_world1(torch, mm, wk, arch: str, mesh) -> dict:
    """26a: ``arch`` at full width (DIST_LAYERS deep), f32, batch 8 x seq 128: DIST_STEPS unsharded
    steps, then DIST_STEPS steps of the Trainer's sharded state on a world-1 NCCL group's (1, 1)
    mesh (params, moments and batch DTensors, every GEMM / WKV through its op's sharding rule onto
    the hand-written kernel); every metric and leaf after each step against the unsharded step."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = _train_cfg(arch, n_layers=DIST_LAYERS[arch])
    _free(torch)
    rt = _train_runtime(f"chip_smoke[26a {arch}]")
    with rt.activate():
        ref_metrics, ref_leaves, ref_times = _unsharded_steps(torch, cfg, _global_batches(torch, cfg, 1, DIST_STEPS))
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        trainer = Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                          adamw.AdamWConfig(**DIST_OPT), TrainerConfig(total_steps=DIST_STEPS), mesh=mesh)
        params, opt = trainer.init_state(0)
        mm.reset_launches()
        wk.reset_launches()
        worst, bitwise, times, metrics = {}, True, [], []
        for step in range(DIST_STEPS):
            t0 = time.perf_counter()
            params, opt, met = trainer.step_fn(params, opt, trainer._batch(step))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in met.items()})
            for key, want in ref_metrics[step].items():
                err = abs(metrics[-1][key] - want) / max(abs(want), 1e-30)
                worst[f"metric {key}"] = max(worst.get(f"metric {key}", 0.0), err)
                bitwise &= metrics[-1][key] == want
            for path, t in adamw.trainable(params):
                full = t.full_tensor()
                worst[path] = max(worst.get(path, 0.0), _rel(torch, full, ref_leaves[step][path]))
                bitwise &= bool(torch.equal(full, ref_leaves[step][path]))
        gemms, fwd, bwd = mm.total_launches(), wk.total_launches(), sum(wk.BWD_LAUNCHES.values())
        per_step = _step_gemms(arch, model)
        placements = sorted({str(t.placements) for _, t in adamw.trainable(params)})
        peak = torch.cuda.max_memory_allocated()
        del trainer, params, opt, model, ref_leaves
    _free(torch)
    top = max(worst.items(), key=lambda kv: kv[1])
    require(top[1] <= DIST_TOL_WORLD1, f"26a {arch}: sharded against unsharded {top[0]} {top[1]:.3g} "
                                       f"(limit {DIST_TOL_WORLD1})")
    require(gemms == DIST_STEPS * per_step, f"26a {arch}: {gemms} GEMM launches, want {DIST_STEPS} x {per_step}")
    if arch == "rwkv6-7b":
        n = cfg.n_layers
        require(fwd == 2 * n * DIST_STEPS and bwd == n * DIST_STEPS,
                f"26a {arch}: WKV forward kernel launches {fwd}, backward {bwd}")
    print(f"  {arch}, {cfg.n_layers} of {_train_cfg(arch).n_layers} layers, f32, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"world-1 NCCL group, mesh (1, 1): {DIST_STEPS} sharded steps, losses "
          f"{[round(m['loss'], 6) for m in metrics]}; worst against unsharded {top[0]} {top[1]:.3g} (limit "
          f"{DIST_TOL_WORLD1}); bitwise equal to the unsharded steps: {bitwise}")
    print(f"  step ms sharded {[round(t * 1e3, 1) for t in times]}, unsharded {[round(t * 1e3, 1) for t in ref_times]};"
          f" GEMM launches {gemms} ({per_step} a step), WKV forward kernel {fwd}, backward kernel {bwd}; peak "
          f"{peak / 1e9:.2f} GB; param placements {placements}")
    return {"arch": arch, "n_layers": cfg.n_layers, "metrics": metrics, "ref_metrics": ref_metrics,
            "worst": worst, "bitwise": bitwise, "step_s": times, "ref_step_s": ref_times, "gemm_launches": gemms,
            "gemm_launches_per_step": per_step, "wkv_launches": fwd, "wkv_backward_launches": bwd,
            "peak_bytes": peak}


def dist_child(rank: int, port: int, work: Path) -> None:
    """Process ``rank`` of two on the one card (26b, 26e): a gloo group (NCCL refuses two
    ranks on one device), the mesh of ``work/job.json`` over ("data", "model"), its arch's
    state sharded as ``param_pspecs`` gives it, its host shard of each batch; DIST_STEPS
    Trainer steps.  Each leaf's local shard against the same part of the parent's unsharded
    steps on the global batch (``work/ref.pt``, mapped, not read whole); an MoE arch's
    routings to ``work/routes<rank>.pt``."""
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mm
    from repro_torch.launch import fleet
    from repro_torch.launch.commanalysis import CollectiveCounter
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    job = json.loads((work / "job.json").read_text())
    _build.load_all(["matmul"])  # the parent's build, loaded
    topo = fleet.initialize(fleet.FleetTopology(f"127.0.0.1:{port}", 2, rank), backend="gloo")
    torch.cuda.set_device(fleet.local_device_index(topo))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", tuple(job["mesh"]), mesh_dim_names=("data", "model"))
    cfg = _train_cfg(job["arch"], n_layers=job["n_layers"])
    rt = _train_runtime(f"chip_smoke[{job['phase']} rank {rank}]")
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        trainer = Trainer(model, cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                          adamw.AdamWConfig(**DIST_OPT), TrainerConfig(total_steps=DIST_STEPS), mesh=mesh)
        params, opt = trainer.init_state(0)
        torch.cuda.reset_peak_memory_stats()
        local = lambda tree: sum(t.to_local().numel() * t.to_local().element_size() for _, t in adamw.trainable(tree))
        held = {"params": local(params), "moments": local(opt.m) + local(opt.v),
                "full_params": sum(t.numel() * t.element_size() for _, t in adamw.trainable(params))}
        mm.reset_launches()
        metrics, times = [], []
        counter = CollectiveCounter()  # the last step's collectives, by kind: count and result bytes
        routing = _recorded_routes(torch, sharded=True) if cfg.moe is not None else contextlib.nullcontext([])
        with routing as routes:
            for step in range(DIST_STEPS):
                t0 = time.perf_counter()
                with counter if step == DIST_STEPS - 1 else contextlib.nullcontext():
                    params, opt, met = trainer.step_fn(params, opt, trainer._batch(step))
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in met.items()})
        launches = mm.total_launches()
        peak = torch.cuda.max_memory_allocated()
        ref = torch.load(work / "ref.pt", mmap=True)
        diffs = {}  # path -> (max |got - want| over this rank's shard, max |want| over it)
        for path, t in adamw.trainable(params):
            want = _local_slice(torch, ref["leaves"][path], t).to("cuda")
            diffs[path] = (float((t.to_local() - want).abs().max()), float(want.abs().max()))
            del want
        worst = {f"step {step + 1} {key}": abs(got[key] - want[key]) / max(abs(want[key]), 1e-30)
                 for step, (got, want) in enumerate(zip(metrics, ref["metrics"])) for key in want}
        if routes:
            torch.save(routes, work / f"routes{rank}.pt")
    (work / f"child{rank}.json").write_text(json.dumps({
        "rank": rank, "backend": dist.get_backend(), "mesh": list(mesh.shape), "data_shard": [
            trainer.pipeline.data.host_index, trainer.pipeline.data.host_count], "metrics": metrics,
        "step_s": times, "gemm_launches": launches, "gemm_launches_per_step": _step_gemms(job["arch"], model),
        "held_bytes": held, "peak_bytes": peak, "worst": worst, "leaf_diffs": diffs,
        "collectives_last_step": counter.summary()}))
    dist.destroy_process_group()


def _run_children(torch, phase: str, arch: str, n_layers: int, mesh: tuple, ref: dict) -> tuple[list[dict], float]:
    """``ref`` (metrics and final leaves of one process on the global batch) to ``build/dist_<phase>/ref.pt``,
    then the two ``dist_child`` processes on ``mesh``; each process's record, the seconds they took."""
    import shutil

    work = ROOT / "build" / f"dist_{phase}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "job.json").write_text(json.dumps({"phase": phase, "arch": arch, "n_layers": n_layers,
                                               "mesh": list(mesh)}))
    torch.save({"metrics": ref["metrics"], "leaves": ref["leaves"]}, work / "ref.pt")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child", str(r), str(port), str(work)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              # two processes share the card: segments that grow keep what one frees usable
                              env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
                                   "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{phase} rank {r} exited {p.returncode}:\n{out[-3000:]}")
    kids = [json.loads((work / f"child{r}.json").read_text()) for r in range(2)]
    for kid in kids:
        kid["routes"] = torch.load(work / f"routes{kid['rank']}.pt") if (work / f"routes{kid['rank']}.pt").exists() else []
    # every leaf: the largest difference over both processes' shards, over the largest value
    worst = dict(kids[0]["worst"])
    for path in kids[0]["leaf_diffs"]:
        diff = max(kid["leaf_diffs"][path][0] for kid in kids)
        worst[path] = diff / max(max(kid["leaf_diffs"][path][1] for kid in kids), 1e-30)
    for kid in kids:
        kid.pop("leaf_diffs")
        kid["worst_all"] = worst
    shutil.rmtree(work, ignore_errors=True)
    return kids, seconds


def _print_children(kids: list[dict]) -> None:
    for kid in kids:
        print(f"  rank {kid['rank']}: holds {kid['held_bytes']['params'] / 1e9:.3f} GB of params (of "
              f"{kid['held_bytes']['full_params'] / 1e9:.3f}) and {kid['held_bytes']['moments'] / 1e9:.3f} GB of "
              f"moments; step ms {[round(t * 1e3, 1) for t in kid['step_s']]}; peak {kid['peak_bytes'] / 1e9:.2f} GB; "
              f"GEMM launches {kid['gemm_launches']}; the last step's collectives {kid['collectives_last_step']}")


def phase_dist_two(torch) -> dict:
    """26b: the reference (unsharded steps on the two data shards' global batch), then two
    processes on the one card (``dist_child``), mesh (2, 1)."""
    cfg = _train_cfg("granite-8b", n_layers=DIST_LAYERS["granite-8b"])
    rt = _train_runtime("chip_smoke[26b reference]")
    with rt.activate():
        metrics, leaves, _ = _unsharded_steps(torch, cfg, _global_batches(torch, cfg, 2, DIST_STEPS),
                                              last_on_host=True)
    _free(torch)
    kids, seconds = _run_children(torch, "26b", "granite-8b", cfg.n_layers, (2, 1),
                                  {"metrics": metrics, "leaves": leaves[-1]})
    del leaves
    top = max(kids[0]["worst_all"].items(), key=lambda kv: kv[1])
    print(f"  worst against one process: " + ", ".join(
        f"{k} {v:.3g}" for k, v in sorted(kids[0]["worst_all"].items(), key=lambda kv: -kv[1])[:6]))
    require(top[1] <= DIST_TOL, f"26b: two processes against the global batch: {top[0]} {top[1]:.3g} (limit {DIST_TOL})")
    for kid in kids:
        require(kid["backend"] == "gloo" and kid["mesh"] == [2, 1] and kid["data_shard"] == [kid["rank"], 2],
                f"26b rank {kid['rank']}: {kid['backend']}, mesh {kid['mesh']}, data shard {kid['data_shard']}")
        require(kid["gemm_launches"] == DIST_STEPS * kid["gemm_launches_per_step"],
                f"26b rank {kid['rank']}: {kid['gemm_launches']} GEMM launches, want {DIST_STEPS} x "
                f"{kid['gemm_launches_per_step']}")
        held = kid["held_bytes"]
        require(held["params"] < 0.51 * held["full_params"], f"26b rank {kid['rank']} holds {held}")
        colls = kid["collectives_last_step"]
        require(colls.get("all-gather_count", 0) > 0 and colls.get("reduce-scatter_count", 0) > 0,
                f"26b rank {kid['rank']}: a step's collectives {colls}")
    print(f"  two processes on the one card, gloo (NCCL refuses two ranks on one device; its collectives move the "
          f"card's tensors through host memory), mesh (2, 1), granite-8b {cfg.n_layers} layers f32, FSDP over data: "
          f"{DIST_STEPS} steps in {seconds:.1f}s with start-up; losses {[round(m['loss'], 6) for m in kids[0]['metrics']]}"
          f" against one process on the global batch {[round(m['loss'], 6) for m in metrics]}; worst {top[0]} "
          f"{top[1]:.3g} (limit {DIST_TOL})")
    _print_children(kids)
    return {"children": kids, "ref_metrics": metrics, "seconds": seconds, "worst": top,
            "gemm_launches": sum(k["gemm_launches"] for k in kids)}


def phase_dist_moe_two(torch, ref: dict) -> dict:
    """26e: MOE_ARCH on two processes of the one card (gloo), mesh (1, 2): each holds half the
    experts; the losses and every leaf against ``ref`` (one process on the same global batch)
    within DIST_TOL; the assignments routed otherwise than in ``ref`` counted."""
    kids, seconds = _run_children(torch, "26e", MOE_ARCH, MOE_LAYERS, (1, 2), ref)
    worst = kids[0]["worst_all"]
    top = max(worst.items(), key=lambda kv: kv[1])
    differing = [_routes_differing(kid["routes"], ref["routes"]) for kid in kids]
    n_assign = sum(int(r.shape[1]) for r in ref["routes"])
    for kid in kids:
        kid.pop("routes")
    print(f"  worst against one process: " + ", ".join(
        f"{k} {v:.3g}" for k, v in sorted(worst.items(), key=lambda kv: -kv[1])[:6]))
    print(f"  (token, slot) assignments routed otherwise than one process on the global batch: {differing} (ranks "
          f"0, 1) of {n_assign} over {len(ref['routes'])} routings")
    require(top[1] <= DIST_TOL, f"26e: two processes against the global batch: {top[0]} {top[1]:.3g} (limit "
                                f"{DIST_TOL}; assignments routed otherwise: {differing})")
    experts = _train_cfg(MOE_ARCH).moe.n_experts
    for kid in kids:
        require(kid["backend"] == "gloo" and kid["mesh"] == [1, 2] and kid["data_shard"] == [0, 1],
                f"26e rank {kid['rank']}: {kid['backend']}, mesh {kid['mesh']}, data shard {kid['data_shard']}")
        require(kid["gemm_launches"] == DIST_STEPS * kid["gemm_launches_per_step"],
                f"26e rank {kid['rank']}: {kid['gemm_launches']} GEMM launches, want {DIST_STEPS} x "
                f"{kid['gemm_launches_per_step']}")
        held = kid["held_bytes"]
        require(held["params"] < 0.6 * held["full_params"], f"26e rank {kid['rank']} holds {held}")
        colls = kid["collectives_last_step"]
        require(colls.get("all-reduce_count", 0) > 0, f"26e rank {kid['rank']}: a step's collectives {colls}")
    print(f"  two processes on the one card, gloo, mesh (1, 2), {MOE_ARCH} {MOE_LAYERS} layer f32, {experts // 2} of "
          f"{experts} experts a process: {DIST_STEPS} steps in {seconds:.1f}s with start-up; losses "
          f"{[round(m['loss'], 6) for m in kids[0]['metrics']]} against one process on the global batch "
          f"{[round(m['loss'], 6) for m in ref['metrics']]}; worst {top[0]} {top[1]:.3g} (limit {DIST_TOL})")
    _print_children(kids)
    return {"children": kids, "ref_metrics": ref["metrics"], "seconds": seconds, "worst": top,
            "routes_differing": differing, "assignments": n_assign,
            "gemm_launches": sum(k["gemm_launches"] for k in kids)}


def phase_dist_cli(torch) -> dict:
    """26c: ``launch.train --fleet`` on two processes of the one card (gloo): both exit 0,
    checkpoints written once at steps 2 and 4, a resume on two processes to step 6; the loss at
    step 4 against one process's unsharded steps on the global batch, under the same deployment."""
    import os
    import shutil

    from repro_torch.configs import registry
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import global_batch

    ckpt = ROOT / "build" / "train_ckpt_26c"
    shutil.rmtree(ckpt, ignore_errors=True)

    def run(steps: int) -> tuple[list[list[str]], float]:
        port = _free_port()
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--fleet", "--dist-backend", "gloo", "--arch",
               "granite-8b", "--reduced", "--steps", str(steps), "--ckpt-every", "2", "--ckpt-dir", str(ckpt),
               "--deployment", str(DEPLOY_PATH)]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_NUM_PROCESSES": "2",
               "REPRO_COORDINATOR": f"127.0.0.1:{port}"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, "REPRO_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"26c --steps {steps} process {r} exited {p.returncode}:\n{out[-3000:]}")
        return [out.strip().splitlines() for out in outs], time.perf_counter() - t0

    lines, seconds = run(4)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt.iterdir() if p.name.startswith("step_"))
    require(steps == [2, 4], f"26c: checkpoints {steps}")
    for r, out in enumerate(lines):
        require("finished at step 4" in out[-1] and any("backend gloo" in ln for ln in out),
                f"26c process {r}: {out[-6:]}")
    got = json.loads(next(ln for ln in lines[0] if ln.startswith("final metrics "))[len("final metrics "):])
    lines6, seconds6 = run(6)
    steps6 = sorted(int(p.name.split("_")[1]) for p in ckpt.iterdir() if p.name.startswith("step_"))
    require(steps6 == [2, 4, 6] and all("finished at step 6" in out[-1] for out in lines6),
            f"26c resume: checkpoints {steps6}, last lines {[out[-1] for out in lines6]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    # One process on the global batch: the launcher's reduced granite-8b, seed-0 init on the card,
    # its AdamW (lr 3e-4, total steps 4), batch 8 x seq 128 over two data shards, the deployment.
    cfg = registry.get("granite-8b").reduced()
    rt = KernelRuntime(name="chip_smoke[26c reference]")
    rt.install(Deployment.load(str(DEPLOY_PATH)))
    with rt.activate():
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw.init(params)
        step_fn = make_train_step(model, adamw.AdamWConfig(lr=3e-4, total_steps=4))
        for step in range(4):
            batch = {k: v.to("cuda") for k, v in global_batch(cfg, DataConfig(), step, 2).items()}
            params, opt, met = step_fn(params, opt, batch)
        want = float(met["loss"])
    err = abs(got["loss"] - want) / abs(want)
    require(err <= DIST_TOL, f"26c: step-4 loss {got['loss']!r} against one process {want!r}: {err:.3g}")
    print(f"  {' '.join(['REPRO_NUM_PROCESSES=2', 'python -m repro_torch.launch.train', '--fleet --dist-backend gloo'])}"
          f" --arch granite-8b --reduced --steps 4 --ckpt-every 2 --deployment {DEPLOY_PATH.relative_to(ROOT)}: both "
          f"processes exit 0 in {seconds:.1f}s; checkpoints {steps}; resumed to 6 in {seconds6:.1f}s ({steps6}); step-4 "
          f"loss {got['loss']!r} against one process on the global batch {want!r} (rel {err:.3g}, limit {DIST_TOL})")
    return {"seconds": seconds, "resume_seconds": seconds6, "checkpoints": steps, "resumed": steps6,
            "loss": got["loss"], "ref_loss": want, "rel_err": err, "stdout": lines[0][-4:]}


def phase_distribution(torch, mm, wk, phase) -> dict:
    """Phase 26a-e."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    out = {}
    phase("[26a] a world-1 NCCL group, mesh (1, 1): granite-8b and rwkv6-7b sharded steps against unsharded")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh("cuda")
        out["world1"] = {arch: phase_dist_world1(torch, mm, wk, arch, mesh) for arch in DIST_LAYERS}
        phase(f"[26d] {MOE_ARCH} at full width, {MOE_LAYERS} layer: unsharded steps, then sharded on the (1, 1) mesh")
        moe_ref = phase_moe_reference(torch)
        out["moe_world1"] = phase_dist_moe_world1(torch, mm, mesh, moe_ref)
    finally:
        dist.destroy_process_group()
    phase("[26b] two processes on the one card (gloo), mesh (2, 1): granite-8b FSDP over data against the global batch")
    out["two"] = phase_dist_two(torch)
    phase(f"[26e] two processes on the one card (gloo), mesh (1, 2): {MOE_ARCH}, half the experts a process, "
          f"against 26d's unsharded steps")
    out["moe_two"] = phase_dist_moe_two(torch, moe_ref)
    del moe_ref
    phase("[26c] the launcher: launch.train --fleet on two processes, checkpoints, resume")
    out["cli"] = phase_dist_cli(torch)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 26a-e in {out['seconds']:.1f}s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dist-child"]:  # one of 26b's or 26e's two processes
        dist_child(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        return 0
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as at
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"{title} (at {time.perf_counter() - t_start:.1f}s)")

    # Python's cyclic collector must never run during a capture: it may free a dead
    # engine's graphs, which invalidates the capture (the engine holds it off).
    collected_in_capture: list[int] = []

    def watch_gc(stage: str, info: dict) -> None:
        if stage == "start" and torch.cuda.is_current_stream_capturing():
            collected_in_capture.append(info["generation"])

    gc.callbacks.append(watch_gc)

    phase("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("[2] build")
    t0 = time.perf_counter()
    _build.load_all(["matmul", "wkv", "wkv_bwd", "ssm", "attention"])
    tiles, wkv_cfgs, ssm_cfgs = mm.compiled_tiles(), wk.compiled_configs(), ss.compiled_configs()
    attn_cfgs = at.compiled_configs()
    wkv_bwd_cfgs = wk.compiled_bwd_configs()
    print(f"  matmul.cu, wkv.cu, wkv_bwd.cu, ssm.cu and attention.cu -> sm_90a in {time.perf_counter() - t0:.1f}s "
          f"(nvcc in parallel: {', '.join(f'{k} {v:.1f}s' for k, v in _build.build_seconds.items())})")
    print(f"  matmul tiles (bm, bn, bk, TMA ring stages, smem TMA, cp.async, f32): {tiles}; persistent kernel "
          f"(bm, bn, bk, stages, smem, threads): {mm.compiled_persistent_tiles()}, on this card (registers at launch, "
          f"local bytes, clusters of 2): {[mm.persistent_residency(mm.MatmulConfig(*t)) for t in mm.PERSISTENT_TILES]}")
    print(f"  wkv instantiations (chunk, hd, smem): {wkv_cfgs}; backward (chunk, hd, smem): {wkv_bwd_cfgs}")
    print(f"  ssm instantiations (block_d, chunk, N, threads): {ssm_cfgs}")
    print(f"  attention instantiations (block_q, block_kv, hd, bf16 threads, stages, smem, f32 threads, smem): "
          f"{attn_cfgs}")
    resident = {c.name(): [at.resident_ctas(c, hd, 0) for hd in (64, 128)] for c in at.config_space()}
    print(f"  attention bf16 CTAs an SM holds (hd 64, 128): {resident}")
    for name in ("matmul", "wkv", "wkv_bwd", "ssm", "attention"):
        log = _build.build_log(name).splitlines()
        regs = [line.split(":", 1)[1].strip() for line in log if "registers" in line]
        spills = sorted({line.strip() for line in log if "spill" in line and "0 bytes spill" not in line})
        print(f"  ptxas {name}: {len(regs)} kernels; {sorted(set(regs))}; spills {spills or 'none'}")
    if "--only-distribution" in sys.argv[1:]:  # phase 26a-e alone (needs build/deploy_h100.json for 26c)
        distribution = phase_distribution(torch, mm, wk, phase)
        (ROOT / "build" / "chip_smoke_distribution.json").write_text(json.dumps(distribution, indent=1, default=str))
        print(f"[26] distribution phase done in {time.perf_counter() - t_start:.1f}s")
        return 0
    if "--only-wkv-backward" in sys.argv[1:]:  # phase 25f-i alone
        restore = _no_plain_on_card(ops)
        try:
            phase("[25f-i] the WKV backward kernel (wkv_bwd.cu) against autograd of wkv_plain, every (chunk, hd); "
                  "timing")
            wkv_bwd = phase_wkv_backward(torch, wk)
        finally:
            restore()
        (ROOT / "build" / "chip_smoke_wkv_backward.json").write_text(json.dumps(wkv_bwd, indent=1, default=str))
        print(f"[25f-i] WKV backward phase done in {time.perf_counter() - t_start:.1f}s")
        return 0
    if "--only-scan-backward" in sys.argv[1:]:  # phase 25f-ii alone
        restore = _no_plain_on_card(ops)
        try:
            phase("[25f-ii] the scan backward kernel (ssm.cu ssm_bwd_kernel), both entries, every config; timing")
            scan_bwd = phase_ssm_backward(torch, ss)
        finally:
            restore()
        (ROOT / "build" / "chip_smoke_scan_backward.json").write_text(json.dumps(scan_bwd, indent=1, default=str))
        print(f"[25f-ii] scan backward phase done in {time.perf_counter() - t_start:.1f}s")
        return 0
    if "--only-gemm" in sys.argv[1:]:  # phases 3, 7's tall GEMM and 25a alone
        phase("[3] GEMM against plain")
        gemm = {"vs_plain": phase_kernel_vs_plain(torch, mm)}
        phase("[7] the tall GEMM")
        gemm["tall"] = phase_tall(torch, mm)
        gemm["persistent_residency"] = {c.name(): mm.persistent_residency(c) for c in mm.config_space()
                                        if c.tile() in mm.PERSISTENT_TILES and c.order == "mnk"}
        print(f"  persistent kernel on this card (registers at launch, local bytes, clusters): "
              f"{gemm['persistent_residency']}")
        restore = _no_plain_on_card(ops)
        try:
            phase("[25a] gradient GEMMs against autograd of matmul_plain; timing")
            gemm["grad_gemms"] = phase_grad_gemms(torch, mm, ops)
        finally:
            restore()
        (ROOT / "build" / "chip_smoke_gemm.json").write_text(json.dumps(gemm, indent=1, default=str))
        print(f"[3/7/25a] GEMM phases done in {time.perf_counter() - t_start:.1f}s")
        return 0
    if "--only-training" in sys.argv[1:]:  # phase 25 alone (needs build/deploy_h100.json for 25g)
        training = phase_training(torch, mm, ops, phase)
        (ROOT / "build" / "chip_smoke_training.json").write_text(json.dumps(training, indent=1, default=str))
        print(f"[25] training phase done in {time.perf_counter() - t_start:.1f}s")
        return 0

    phase("[3] GEMM against plain")
    errors = phase_kernel_vs_plain(torch, mm)
    phase("[3b] WKV against plain")
    wkv_errors = phase_wkv_vs_plain(torch, wk)
    phase("[3c] SSM against plain")
    ssm_errors = phase_ssm_vs_plain(torch, ss)
    seq = {"wkv": wk, "ssm": ss}

    phase("[4] full-width granite-8b serving")
    serve = phase_serve(torch, mm, seq, "granite-8b")
    phase("[5] selection reaches the kernel")
    policy = phase_policy(mm, serve)
    phase("[5b] where a granite-8b decode step's and prefill's time goes (warm replays)")
    profile = phase_profile(torch, serve)
    phase("[5c] granite-8b: the eager engine against the graphed one")
    eager = {"granite-8b": phase_eager(torch, mm, seq, serve, profile)}
    _release(torch, serve)  # granite's weights go before rwkv6-7b's load

    phase("[6] cpu against card, granite-8b")
    parity = phase_cpu_vs_card("granite-8b")

    phase("[7] GEMM timing, granite-8b shapes (bf16, DEFAULT_CONFIG = the config served)")
    rows = phase_timing(torch, mm, serve["per_decode_step"], GRANITE_KN)
    tall = phase_tall(torch, mm)

    phase("[8] full-width rwkv6-7b serving")
    rwkv = phase_serve(torch, mm, seq, "rwkv6-7b")
    phase("[9] selection reaches the WKV kernel")
    wkv_policy = phase_seq_policy(wk, "wkv", wk.WkvConfig(64), rwkv)
    phase("[9b] where an rwkv6-7b decode step's and prefill's time goes (warm replays)")
    rwkv_profile = phase_profile(torch, rwkv)
    phase("[9c] rwkv6-7b: the eager engine against the graphed one")
    eager["rwkv6-7b"] = phase_eager(torch, mm, seq, rwkv, rwkv_profile)
    _release(torch, rwkv)

    phase("[10] cpu against card, rwkv6-7b")
    rwkv_parity = phase_cpu_vs_card("rwkv6-7b")

    phase("[11] WKV timing (DEFAULT_WKV_CONFIG = the config served), GEMM timing at rwkv6-7b decode shapes")
    wkv_rows = phase_wkv_timing(torch, wk)
    rwkv_rows = phase_timing(torch, mm, rwkv["per_decode_step"], RWKV_KN, ms=(4,))

    phase("[12] full-width hymba-1.5b serving")
    hymba = phase_serve(torch, mm, seq, "hymba-1.5b")
    want = {"fused": sum(hymba["ssm_launches"].values()), "dta": 0}
    require(hymba["ssm_entry_launches"] == want and want["fused"] > 0,
            f"hymba-1.5b prefills should reach the SSM only through ssm_cuda_fused: {hymba['ssm_entry_launches']}")
    print(f"  SSM launches by entry: {hymba['ssm_entry_launches']} (ssm_cuda_fused only)")
    phase("[13] selection reaches the SSM kernel")
    ssm_policy = phase_seq_policy(ss, "ssm", ss.SsmConfig(8, 16), hymba)
    phase("[13b] where a hymba-1.5b decode step's and prefill's time goes (warm replays)")
    hymba_profile = phase_profile(torch, hymba)
    phase("[13c] hymba-1.5b: the eager engine against the graphed one; the SSM workspace under capture")
    eager["hymba-1.5b"] = phase_eager(torch, mm, seq, hymba, hymba_profile)
    ssm_guard = phase_ssm_capture_guard(torch, ss)
    _release(torch, hymba)

    phase("[14] cpu against card, hymba-1.5b at 4 layers")
    hymba_parity = phase_hymba_cpu_vs_card(torch)

    phase("[15] SSM timing (DEFAULT_SSM_CONFIG = the config served), GEMM timing at hymba-1.5b decode shapes")
    ssm_rows = phase_ssm_timing(torch, ss)
    hymba_rows = phase_timing(torch, mm, hymba["per_decode_step"], HYMBA_KN, ms=(4,))

    phase("[16] attention against plain")
    attn_errors = phase_attention_vs_plain(torch, at)
    phase("[17] tune on the card, every family: measured tables -> cluster-select -> decision trees -> Deployment")
    tuning = phase_tune(torch, mm, at, wk, ss)
    mods = {"matmul": mm, "attention": at, "wkv": wk, "ssm_scan": ss}
    phase("[17b] the staged bring-up: phase 17's deployment as donor, pruned, measured within the auto budget")
    staged = phase_staged(torch, mods, tuning)
    phase("[17c] the fleet bundle (card + host_cpu), installed and served: rwkv6-7b and hymba-1.5b from the bundle")
    fleet = phase_fleet_serve(torch, mods, tuning)
    phase("[18] the quickstart's path: the tuned Deployment in a fresh runtime, ops.attention and ops.matmul")
    quick = phase_quickstart(torch, mm, at, ops)
    phase("[19] full-width granite-8b served under the tuned Deployment")
    from repro_torch.core.dispatch import Deployment

    tuned = phase_serve(torch, mm, seq, "granite-8b", policy=Deployment.load(DEPLOY_PATH))
    phase("[19b] where a tuned granite-8b decode step's and prefill's time goes (warm replays)")
    tuned_profile = phase_profile(torch, tuned)
    phase("[19c] another policy installed mid-run: the programs are captured again")
    reinstall = phase_reinstall(torch, mm, tuned)
    phase("[21a] guarded dispatch on the card: redirect, quarantine, re-probe, absolve; NaN; unrecoverable; cost")
    guard = phase_guard(torch, mods)
    phase(f"[21b] engine chaos: phase 19's batch under {CHAOS} and {CHAOS_DISPATCH}")
    chaos = phase_engine_chaos(torch, mm, seq, tuned)
    phase("[21c] retune on the card: drift -> measured retune -> canary -> hot swap; rejection; rollback; adoption")
    retuned = phase_retune_on_card(torch, mm, at, seq, tuned)
    phase("[21d] OnlinePolicy on the card: CUDA-event arms at granite-8b's decode shapes")
    online = phase_online(torch, mm, rows)
    _release(torch, tuned)
    # One granite decode step's GEMMs at m=4: sum of count x time over the shapes it launches,
    # under the default config, each shape's best compiled config, and the tree's choices.
    step = [r for r in rows if r["m"] == 4]
    total = lambda key: sum(r[key] * r["launches_per_decode_step"] for r in step)
    tree_cfg = dict(tuned["decode_configs"])
    require(len(tree_cfg) == len(tuned["decode_configs"]), f"one (k, n) decode GEMM selected two configs: "
                                                            f"{tuned['decode_configs']}")
    tuned_step_ms = sum(r["per_config_ms"][tree_cfg[f"{r['k']}x{r['n']}"]] * r["launches_per_decode_step"]
                        for r in step)
    tuned["gemm_step_ms"] = {"default": total("ms"), "best_per_shape": total("best_ms"), "tree": tuned_step_ms,
                             "bound": total("bound_ms")}
    tuned["streams_equal_phase_4"] = tuned["outputs"] == serve["outputs"]
    split = {name: n for name, n in tuned["launches"].items() if n}
    print(f"  GEMM launches by config: {split}; decode-step GEMM configs {tree_cfg}")
    print(f"  one decode step's GEMMs (CUDA-event device time from phase 7, summed over shapes): tree "
          f"{tuned_step_ms:.2f} ms, default {total('ms'):.2f}, best per shape {total('best_ms'):.2f}, "
          f"bound {total('bound_ms'):.2f}; greedy streams equal phase 4's: {tuned['streams_equal_phase_4']}")
    phase("[20] attention timing at the served shapes")
    attn_rows = phase_attention_timing(torch, at)
    phase("[20b] GEMM: the parent's kernel against this one, in turns")
    parent_ab = phase_parent_ab({"granite-8b": serve, "rwkv6-7b": rwkv, "hymba-1.5b": hymba})
    phase("[20c] attention: the parent's kernel against this one, in turns")
    attn_parent_ab = phase_attention_parent_ab()
    phase("[20d] selective scan: the parent's kernel against this one, in turns")
    ssm_parent_ab = phase_ssm_parent_ab()

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    gmodel = build_model(registry.get("granite-8b"), dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    gparams = gmodel.init(torch.Generator(device="cuda").manual_seed(0))
    tuned_dep = Deployment.load(DEPLOY_PATH)
    paged_launches = {}
    phase("[22a] the paged tier: full-width granite-8b, paged, prefix-shared, chunked prefill, CUDA graphs")
    paged = phase_paged(torch, mm, gmodel, gparams, tuned_dep)
    paged_launches["granite-8b paged, prefix-shared, chunked (22a)"] = paged["gemm_launches"]
    phase("[22b] chunk invariance and CPU against card: 8-layer full-width granite-8b in f32")
    mm.reset_launches()
    paged_cpu = phase_paged_cpu_vs_card(torch)
    paged_launches["granite-8b 8 layers f32, chunk widths and capture (22b)"] = mm.total_launches()
    phase("[22c] SLO mode on 22a's engine")
    mm.reset_launches()
    slo = phase_slo(torch, paged)
    paged_launches["SLO mode (22c)"] = mm.total_launches()
    phase("[22d] int8 KV cache: full-width granite-8b, paged")
    mm.reset_launches()
    int8 = phase_int8(torch, paged, gmodel, gparams, tuned_dep)
    paged_launches["int8 KV (22d)"] = mm.total_launches()
    phase("[22e] the Router: two engines on the card, and the fleet bundle's router")
    mm.reset_launches()
    routed = phase_router(torch, paged, gmodel, gparams, tuned_dep, tuning["device"])
    paged_launches["Router (22e)"] = mm.total_launches()
    for key in ("engine", "prompts", "dense_outputs"):
        paged.pop(key)
    torch.cuda.empty_cache()
    phase("[22f] hymba-1.5b under a paged pool (legacy admission)")
    paged_hymba = phase_paged_hymba(torch, mm, ss)
    paged_launches["hymba-1.5b paged (22f)"] = paged_hymba["paged"]["gemm_launches"]
    require(all(paged_launches.values()), f"a phase-22 path launched no GEMM: {paged_launches}")
    phase("[23] the tuning control plane: a tune job, serving from registry://, federation, a retune on the card, "
          "the push, capture beside measurement, the ctl CLI")
    t23 = time.perf_counter()
    control = phase_control_plane(torch, mods, seq, ops, tuning, staged, gmodel, gparams, tuning["device"])
    control["seconds"] = time.perf_counter() - t23
    print(f"  phase 23 in {control['seconds']:.1f}s")
    del gmodel, gparams
    torch.cuda.empty_cache()
    arch_runs = {}
    for letter, (arch, depth) in zip("abcde", ARCH_RUNS):
        phase(f"[24{letter}] {arch} served at full width in bf16"
              + (f", cut in depth to {depth} layers" if depth else ""))
        arch_runs[arch] = phase_arch_serve(torch, mm, arch, depth)
    _free(torch)
    phase("[24f] cpu against card: reduced qwen3-moe-235b-a22b, llama-3.2-vision-90b, qwen2.5-32b (f32)")
    arch_parity = phase_arch_cpu_vs_card(torch, mm)
    _free(torch)
    training = phase_training(torch, mm, ops, phase)
    _free(torch)
    distribution = phase_distribution(torch, mm, wk, phase)
    # Phase 23's paths, each counted from 0 just before it and read just after.
    control_launches = {fam: {"control plane: tune job tables (23a)": control["job"]["launches"][fam]}
                        for fam in mods}
    control_launches["matmul"].update(control["served"]["launches"])
    control_launches["matmul"].update({
        "control plane: runtime subscriber's ops.matmul (23c)": control["runtime"]["launches"],
        "control plane: retune table beside a recapture, two drains (23d)": control["concurrent"]["launches"],
        "control plane: the eager engine's drain (23d)": control["concurrent"]["eager_launches"]})
    require(all(v for paths in control_launches.values() for v in paths.values()),
            f"a phase-23 path launched nothing: {control_launches}")
    # The rwkv6-7b run's WKV launches: n_layers per prefill, at each prefill's bucket.
    by_s = {r["s"]: r for r in wkv_rows}
    wkv_total = lambda key: rwkv["wkv_per_prefill"] * sum(by_s[s][key] for s in rwkv["prefill_buckets"])
    # The hymba-1.5b run's SSM launches: n_layers per prefill, at each prefill's bucket, through the
    # fused entry (the dta entry's time over the same launches beside it).
    ssm_by = {(r["s"], r["entry"]): r for r in ssm_rows}
    ssm_total = lambda key, entry="fused": hymba["ssm_per_prefill"] * sum(ssm_by[s, entry][key]
                                                                         for s in hymba["prefill_buckets"])
    gemm_launches = {run["arch"]: sum(run["launches"].values()) for run in (serve, rwkv, hymba)}
    gemm_launches["granite-8b (tuned)"] = sum(tuned["launches"].values())
    gemm_launches["quickstart"] = sum(quick["launches"]["matmul"].values())
    # Every family's launches on the tuning paths: the tables measured in phases 17 and 17b,
    # and the bundle's serving of rwkv6-7b and hymba-1.5b in 17c.
    tune_launches = {fam: {"tables, phase 17": tuning["launches_while_measuring"][fam],
                           "tables, phase 17b (staged)": staged["families"][fam]["launches_while_measuring"]} | {
        f"{arch} from the bundle (17c)": run["launches"]["bundle"][fam] for arch, run in fleet["served"].items()}
        for fam in ("matmul", "attention", "wkv", "ssm_scan")}
    # Phase 21's paths: the guard's direct calls, the chaos drain's builds, the retune's
    # gpubench tables and on-card canary probes, the OnlinePolicy's measured arms.
    resilience = {"guard (21a)": guard["launches"], "engine chaos (21b)": chaos["launches"],
                  "retune: tables, canary probes, captures (21c)": retuned["launches"],
                  "OnlinePolicy arms and calls (21d)": online["launches"]}
    for fam, paths in tune_launches.items():
        paths.update({path: counts[fam] for path, counts in resilience.items() if counts.get(fam)})
        paths.update(control_launches[fam])
    gemm_launches.update(tune_launches["matmul"])
    gemm_launches.update(paged_launches)
    for arch, run in arch_runs.items():
        gemm_launches[f"{arch}, {run['cut']} (24)"] = run["gemm_launches"]
        gemm_launches[f"{arch}, eager engine (24)"] = run["eager_gemm_launches"]
    gemm_launches["reduced qwen3-moe, llama-vision, qwen2.5 on the card, f32 (24f)"] = arch_parity["gemm_launches"]
    # Phase 25's paths: forward, recompute and both gradient GEMMs of every training step, each
    # path counted from 0 just before it and read just after.
    gemm_launches.update({
        "training: gradient GEMM checks (25a)": training["grad_gemms"]["launches"],
        "training: granite-8b full width, f32 Trainer + profiled step (25b)": training["granite"]["f32"][
            "gemm_launches"],
        "training: granite-8b full width, bf16 steps (25b)": training["granite"]["bf16"]["gemm_launches"],
        "training: resume, reduced granite-8b (25c)": training["resume"]["gemm_launches"],
        "training: seamless-m4t-large-v2 full size, steps + prefill + decode (25d)": training["seamless"][
            "gemm_launches"],
        "training: one step, reduced models on the card (25e)": training["cpu_vs_card"]["gemm_launches"]})
    require(all(v for k, v in gemm_launches.items() if k.startswith("training")),
            f"a training path launched no GEMM: {gemm_launches}")
    # Phase 26's paths: every GEMM of the sharded steps (each process's own counts in 26b).
    gemm_launches.update({
        f"distribution: {arch} sharded steps, world-1 NCCL, mesh (1, 1) (26a)": run["gemm_launches"]
        for arch, run in distribution["world1"].items()})
    gemm_launches["distribution: granite-8b, two processes (gloo), mesh (2, 1) (26b)"] = distribution["two"][
        "gemm_launches"]
    gemm_launches[f"distribution: {MOE_ARCH} sharded steps, world-1 NCCL, mesh (1, 1) (26d)"] = distribution[
        "moe_world1"]["gemm_launches"]
    gemm_launches[f"distribution: {MOE_ARCH}, two processes (gloo), mesh (1, 2) (26e)"] = distribution["moe_two"][
        "gemm_launches"]
    require(all(v for k, v in gemm_launches.items() if k.startswith("distribution")),
            f"a distribution path launched no GEMM: {gemm_launches}")
    # Phase 25's recurrent paths: the WKV / scan forward kernel (forward and remat recompute) and
    # backward kernel launches of the training runs, each counted from 0 just before and read just after.
    rec_paths = {
        "wkv": {"training: rwkv6-7b full width, f32 Trainer + profiled step (25f-iii)": training["rwkv"]["f32"],
                "training: rwkv6-7b full width, bf16 steps (25f-iii)": training["rwkv"]["bf16"]},
        "ssm_scan": {"training: hymba-1.5b whole, f32 Trainer + profiled step (25f-iv)": training["hymba"]["f32"]}}
    for fam, label in (("wkv", "rwkv6-7b"), ("ssm_scan", "hymba-1.5b")):
        rec_paths[fam][f"training: one step, reduced {label} on the card (25e)"] = {
            "forward_kernel_launches": training["cpu_vs_card"]["forward_kernel_launches"][fam],
            "backward_kernel_launches": training["cpu_vs_card"]["backward_kernel_launches"][fam]}
    rec_paths["wkv"]["distribution: rwkv6-7b sharded steps, world-1 NCCL, mesh (1, 1) (26a)"] = {
        "forward_kernel_launches": distribution["world1"]["rwkv6-7b"]["wkv_launches"],
        "backward_kernel_launches": distribution["world1"]["rwkv6-7b"]["wkv_backward_launches"]}
    train_fwd = {fam: {k: v["forward_kernel_launches"] for k, v in paths.items()} for fam, paths in rec_paths.items()}
    train_bwd = {fam: {k: v["backward_kernel_launches"] for k, v in paths.items()} for fam, paths in rec_paths.items()}
    require(all(v for paths in (*train_fwd.values(), *train_bwd.values()) for v in paths.values()),
            f"a training path launched no WKV / scan kernel: {train_fwd} {train_bwd}")
    wkv_bwd_row = next(r for r in training["wkv_backward"]["timing"] if r["dtype"] == "float32")
    ssm_bwd_row = next(r for r in training["ssm_backward"]["timing"] if r["entry"] == "fused")
    gemm_routes = {path: sum(run["path_launches"][path] for run in (serve, rwkv, hymba, tuned, *arch_runs.values()))
                   + quick["paths"][path] for path in ("tma", "cp_async")}
    kernels = {"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:120",
        "launches": sum(gemm_launches.values()),
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {run["arch"] + (" (tuned)" if run is tuned else ""): {
            "2 decode replays": prof["decode"]["count"].get(GEMM_KERNELS, 0),
            "1 prefill replay": prof["prefill"]["count"].get(GEMM_KERNELS, 0)}
            for run, prof in ((serve, profile), (rwkv, rwkv_profile), (hymba, hymba_profile), (tuned, tuned_profile))},
        "program_replays": {run["arch"] + (" (tuned)" if run is tuned else ""): run["program_replays"]
                            for run in (serve, rwkv, hymba, tuned)},
        "launches_by_path": gemm_launches,
        "launches_by_route": gemm_routes,
        "max_abs_err": max(errors[pair]["abs"] for pair in GEMM_PAIRS),
        "max_rel_err": max(errors[pair]["rel"] for pair in GEMM_PAIRS),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes",
        "library_ms": total("library_ms"),
        "timed_as": "all GEMMs of one granite-8b decode step (batch 4), summed over shapes, DEFAULT_CONFIG",
        "tuned_ms": tuned_step_ms,
        "best_per_shape_ms": total("best_ms"),
        "tall_tflops": tall["tflops"][mm.DEFAULT_CONFIG.name()],
        "tall_best": {"config": tall["best"], "tflops": tall["best_tflops"], "library_tflops": tall["library_tflops"]},
        "tma_kernel_launches": {"phase 3": errors["tma_kernels"],
                                "training: granite-8b full width, bf16 steps (25b)": training["granite"]["bf16"][
                                    "tma_kernels"]},
        "training": {
            "gradient_gemms": "grad_lhs = grad_out . rhs^T and grad_rhs = lhs^T . grad_out through ops.matmul "
                              "(selected, guarded, this kernel); the TMA path reads rhs^T and lhs^T in place "
                              "(.t() views), the cp.async and f32 paths copy them",
            "transpose_copies": {"25a": training["grad_gemms"]["transpose_copies"],
                                 "25b bf16": training["granite"]["bf16"]["transpose_copies"]},
            "transposed_reads": {"25a": training["grad_gemms"]["transposed_reads"],
                                 "25b bf16": training["granite"]["bf16"]["transposed_reads"]},
            "max_abs_err_grad": max(w["abs"] for w in training["grad_gemms"]["worst"].values()),
            "max_rel_err_grad": max(w["rel"] for w in training["grad_gemms"]["worst"].values()),
            "granite_step_gemms": {f"{r['dtype']} {r['k']}x{r['n']}": {
                what: {key: r[what][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for what in ("forward", "grad_lhs", "grad_rhs")} for r in training["grad_gemms"]["rows"]},
            "granite_f32_launches_per_step": training["granite"]["f32"]["gemm_launches_per_step"],
            "granite_f32_warm_step_ms": training["granite"]["f32"]["warm_step_ms"],
            "granite_f32_profiled_step": {key: training["granite"]["f32"][key] for key in (
                "gemm_ms", "gemm_share", "gemm_kernels_recorded")} | {
                "wall_ms": training["granite"]["f32"]["profile"]["wall_ms"],
                "measured_as": "torch.profiler, one warm step: the GEMM kernels it recorded, of the step's wall"},
            "granite_f32_gemm_share_estimate_from_25a":
                training["granite"]["f32"]["gemm_share_estimate_from_25a"],
            "granite_layer_f32_ms": {key: training["grad_gemms"]["granite_layer"]["f32"][key] for key in (
                "ms", "bound_ms", "library_ms")} | {"as": "forward / grad_lhs / grad_rhs: a layer's 7 GEMMs, 1024 rows"},
            "f32_head_grad_against_f64": training["grad_gemms"]["f32_against_f64"],
            "split_f32_launches_25a": training["grad_gemms"]["split_f32_launches"],
        },
    }, {
        "name": "wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:114",
        "launches": sum(rwkv["wkv_launches"].values()) + sum(tune_launches["wkv"].values())
        + sum(train_fwd["wkv"].values()),
        "launches_by_path": {"rwkv6-7b (phase 8)": sum(rwkv["wkv_launches"].values())} | tune_launches["wkv"]
        | train_fwd["wkv"],
        "served_configs_from_bundle": fleet["served"]["rwkv6-7b"]["wkv_configs_by_bucket"],
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {f"1 prefill replay, {k}": rwkv_profile["prefill"]["count"].get(
            _kernel_name(k), 0) for k in ("wkv_state_kernel", "wkv_output_kernel")},
        "program_replays": rwkv["program_replays"],
        "max_abs_err": wkv_errors["abs"],
        "max_rel_err": wkv_errors["rel"],
        "ms": wkv_total("ms"),
        "plain_ms": wkv_total("plain_ms"),
        "bound_ms": wkv_total("bound_ms"),
        "bound_by": ("bytes" if all(by_s[s]["bound_by"] == "bytes" for s in rwkv["prefill_buckets"])
                     else "operations"),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunked WKV recurrence",
        "design": "a chunk-parallel pair per call: wkv_state_kernel carries the state over the chunk boundaries "
                  "into a workspace (producer warps load and prepare k^, consumer warps update), then "
                  "wkv_output_kernel computes every chunk's output at once",
        "kernel_launches_per_call": by_s[min(by_s)]["kernel_launches_per_call"],
        "timed_as": f"all WKV launches of the rwkv6-7b run's prefills (buckets {rwkv['prefill_buckets']}, "
                    f"{rwkv['wkv_per_prefill']} each), summed from per-length medians",
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm.cu",
        "replaces": "src/repro/kernels/ssm.py:90",
        "launches": sum(hymba["ssm_launches"].values()) + sum(tune_launches["ssm_scan"].values())
        + paged_hymba["paged"]["ssm_launches"] + sum(train_fwd["ssm_scan"].values()),
        "launches_by_path": {"hymba-1.5b (phase 12)": sum(hymba["ssm_launches"].values())} | tune_launches["ssm_scan"]
        | {"hymba-1.5b paged (22f)": paged_hymba["paged"]["ssm_launches"]} | train_fwd["ssm_scan"],
        "served_configs_from_bundle": fleet["served"]["hymba-1.5b"]["ssm_scan_configs_by_bucket"],
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {f"1 prefill replay, {k}": hymba_profile["prefill"]["count"].get(
            _kernel_name(k), 0) for k in ("ssm_state_kernel", "ssm_output_kernel")},
        "program_replays": hymba["program_replays"],
        "launches_by_entry": hymba["ssm_entry_launches"],
        "max_abs_err": ssm_errors["abs"],
        "max_rel_err": ssm_errors["rel"],
        "ms": ssm_total("ms"),
        "plain_ms": ssm_total("plain_ms"),
        "bound_ms": ssm_total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in ssm_rows) else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the selective scan",
        "dta_entry_ms": ssm_total("ms", "dta"),
        "dta_entry_bound_ms": ssm_total("bound_ms", "dta"),
        "dta_entry_plain_ms": ssm_total("plain_ms", "dta"),
        "design": "per CTA block_d channels of 4 threads (N / 4 states each), a ring of cp.async stages on "
                  "mbarriers, dt * x and dt * a formed in registers (fused entry); where the grid is under one "
                  "wave the sequence is cut into segments: ssm_state_kernel (each segment's end state and decay "
                  "product) then ssm_output_kernel (the earlier segments folded in order, then y)",
        "timed_as": f"all SSM launches of the hymba-1.5b run's prefills (buckets {hymba['prefill_buckets']}, "
                    f"{hymba['ssm_per_prefill']} each, all through the fused entry), summed from per-length "
                    f"medians; dta_entry_*: the dta entry over the same launches",
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention.py:98",
        "launches": sum(quick["launches"]["attention"].values()) + sum(tune_launches["attention"].values()),
        "launches_by_path": {"quickstart (phase 18)": sum(quick["launches"]["attention"].values())} | tune_launches[
            "attention"],
        "launches_by_kernel_path": quick["attention_paths"],
        "kv_splits_launched": quick["attention_splits"],
        "max_abs_err": max([w["abs"] for w in attn_errors["worst"].values()] + [quick["worst"]["abs"]]),
        "max_rel_err": max([w["rel"] for w in attn_errors["worst"].values()] + [quick["worst"]["rel"]]),
        "ms": sum(r["ms"] for r in quick["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in quick["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in quick["rows"]),
        "bound_by": max(("operations", "bytes"), key=lambda b: sum(r["bound_ms"] for r in quick["rows"]
                                                                    if r["bound_by"] == b)),
        "library_ms": sum(r["library_ms"] for r in quick["rows"]),
        "library_note": "scaled_dot_product_attention with causal_lower_right (a yardstick only)",
        "timed_as": f"phase 18's ops.attention calls: one per harvested attention problem of {', '.join(TUNED_ARCHS)} "
                    f"({len(quick['rows'])}) at (1, 32) heads, bf16, causal, under the tree's config, summed "
                    f"(the run made each call twice, the second a shape-cache hit)",
    }, {
        "name": "wkv_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_bwd.cu",
        "replaces": "src/repro/models/rwkv.py:92",
        "replaces_note": "no TPU kernel: wkv_pallas (src/repro/kernels/wkv.py:114) has no backward; the JAX package "
                         "trains through XLA's gradient of wkv_chunked (src/repro/kernels/ops.py:426)",
        "launches": sum(train_bwd["wkv"].values()),
        "launches_by_path": train_bwd["wkv"],
        "max_abs_err": max(w["abs"] for w in training["wkv_backward"]["worst"].values()),
        "max_rel_err": max(w["rel"] for w in training["wkv_backward"]["worst"].values()),
        "ms": wkv_bwd_row["ms"],
        "plain_ms": wkv_bwd_row["plain_autograd_ms"],
        "bound_ms": wkv_bwd_row["bound_ms"],
        "bound_by": wkv_bwd_row["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the WKV recurrence's gradient",
        "design": "one reverse walk a head (wkv_bwd_walk_kernel): blocks of up to 16 rows from the last, the "
                  "state's gradient carried in registers, the forward's chunk start states read through a 2-stage "
                  "cp.async ring on mbarriers, one exponential a (t, tau, channel), the (rows, hd) x (hd, hd) "
                  "products as register tiles of float4 reads; few heads cut into segments, the reverse pass "
                  "(wkv_bwd_state_kernel) writing the state's gradient at their ends",
        "kernel_launches_per_call": wkv_bwd_row["kernel_launches_per_call"],
        "timed_as": f"one call at rwkv6-7b's training shape {RWKV_TRAIN_SHAPE} (B, S, H, hd), f32, "
                    f"{wkv_bwd_row['config']}; plain_ms: autograd's backward of wkv_plain there",
    }, {
        "name": "ssm_scan_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm.cu",
        "replaces": "src/repro/kernels/ref.py:24",
        "replaces_note": "no TPU kernel: ssm_scan_pallas (src/repro/kernels/ssm.py:90) has no backward; the JAX "
                         "package trains through XLA's gradient of ssm_scan_ref (src/repro/kernels/ops.py:461)",
        "launches": sum(train_bwd["ssm_scan"].values()),
        "launches_by_path": train_bwd["ssm_scan"],
        "max_abs_err": max(w["abs"] for w in training["ssm_backward"]["worst"].values()),
        "max_rel_err": max(w["rel"] for w in training["ssm_backward"]["worst"].values()),
        "ms": ssm_bwd_row["ms"],
        "plain_ms": ssm_bwd_row["plain_autograd_ms"],
        "bound_ms": ssm_bwd_row["bound_ms"],
        "bound_by": ssm_bwd_row["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the selective scan's gradient",
        "design": "ssm_bwd_kernel: the forward's layout (4 threads a channel, time groups of "
                  "8 steps); each chunk's inputs staged by a cp.async ring on mbarriers; a time-grouped forward walk "
                  "to the chunk starts; each chunk in reverse in time groups, the state and the gradient "
                  "recurrences folded over the groups' pairs; outputs staged and stored 16 bytes at a time; sums in "
                  "fixed trees, per-CTA partials (fused entry: dt * x, dt * a in registers)",
        "registers": ssm_bwd_row["registers"], "ctas_an_sm": ssm_bwd_row["ctas"], "waves": ssm_bwd_row["waves"],
        "kernel_launches_per_call": ssm_bwd_row["kernel_launches_per_call"],
        "timed_as": f"one fused-entry call at hymba-1.5b's training shape {HYMBA_TRAIN_SHAPE} (B, S, d, N), "
                    f"{ssm_bwd_row['config']}; plain_ms: autograd's backward of ssm_fused_plain there",
    }]}
    gc.callbacks.remove(watch_gc)
    require(not collected_in_capture, f"Python collections ran during a capture: generations {collected_in_capture}")
    print("  no Python collection ran during a CUDA graph capture")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": _build.build_seconds, "errors": errors, "wkv_errors": wkv_errors,
        "serve": serve, "policy": policy, "profile": profile, "cpu_vs_card": parity, "timing": rows, "tall": tall,
        "parent_ab": parent_ab, "attention_parent_ab": attn_parent_ab, "ssm_parent_ab": ssm_parent_ab,
        "rwkv_serve": rwkv, "wkv_policy": wkv_policy, "rwkv_profile": rwkv_profile,
        "rwkv_cpu_vs_card": rwkv_parity, "wkv_timing": wkv_rows, "rwkv_timing": rwkv_rows,
        "ssm_errors": ssm_errors, "hymba_serve": hymba, "ssm_policy": ssm_policy, "hymba_profile": hymba_profile,
        "hymba_cpu_vs_card": hymba_parity, "ssm_timing": ssm_rows, "hymba_timing": hymba_rows,
        "attention_errors": attn_errors, "tuning": {k: v for k, v in tuning.items() if k != "full"},
        "staged": staged, "fleet": fleet, "quickstart": quick, "tuned_serve": tuned,
        "tuned_profile": tuned_profile, "eager_vs_graphed": eager, "ssm_capture_guard": ssm_guard,
        "reinstall": reinstall,
        "guard": guard, "engine_chaos": chaos, "retune_on_card": retuned, "online": online,
        "attention_timing": attn_rows, "paged": paged, "paged_cpu_vs_card": paged_cpu, "slo": slo, "int8": int8,
        "router": routed, "paged_hymba": paged_hymba, "paged_launches": paged_launches, "control_plane": control,
        "arch_serve": arch_runs, "arch_cpu_vs_card": arch_parity, "training": training, "distribution": distribution,
        "kernels": kernels["kernels"], "seconds": time.perf_counter() - t_start,
    }, indent=1, default=str))
    print(f"[27] done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
