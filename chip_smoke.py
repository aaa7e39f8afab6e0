"""Drive the PyTorch + CUDA port's main paths on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  device      the card (nvidia-smi name and power limit), torch and CUDA
  build       nvcc for every kernel source (in parallel, libraries left
              by an earlier process removed first), with ptxas's register /
              shared-memory / spill report
  database    PIR_1G (2^25 records x 32 B = 1 GiB) made from a seed and
              placed on the card once; PIR_1G_ADD and PIR_1G_K3 serve the
              same records from it (the int8 byte view aliases the words)
  check       each kernel against its plain PyTorch version on the same
              inputs at main-path shapes (xor-dpf-k's 96 and 64 flattened
              pseudo-queries included); integer-exact, tolerance 0
  quickstart  the quickstart twin at PIR_SMOKE
  serve       TwoServerPIR at PIR_1G (xor-dpf-2) on its default plans:
              batches of 32, 5 (padded to 8) and 1 through query(), then a
              session; every record is checked against the database, and
              the kernel counters (zeroed just before) must show the path's
              kernels launched and no plain call
  serve_add   the same at PIR_1G_ADD (additive-dpf-2): int8 GEMM and fused
              expand + select-add kernels; records are the DB's bytes
  serve_k3    MultiServerPIR at PIR_1G_K3 (xor-dpf-k, three servers) on the
              XOR kernels: batches of 32 and 1
  timing      kernels with CUDA events beside their bounds (and a PyTorch
              library call where one computes the same function);
              end-to-end latency and records/s for batches of 1 and 32 with
              keygen, root descent and kernel time apart; peak device
              memory; B2 at Q = 32 also by torch.profiler beside the CUDA
              events (kernel_device_ms keeps a profiler mean only where
              one record matches each counted launch)
  timing_add  the same for the additive scheme, and k = 3 end to end
  reference_api  the reference's single-shard functions on the resident
              PIR_1G views and seeded keys: answer_xor (Q = 1) and
              answer_xor_batch (Q = 4) for both parties of xor-dpf-2 keys
              and answer_additive_batch (Q = 4) of additive-dpf-2 keys on
              the bytes view, the records exact; the paper's Table 1 split,
              phase_eval_bits and phase_dpxor at Q = 1 and 4 by CUDA events
              (eval ms, dpXOR ms, dpXOR's share) beside timing's descent and
              B1 times; leaf_bits(eval_all(key)) at log_n 25 equal to that
              key's phase_eval_bits row; leaf_words of a payload pair (W =
              8, log_n 20) summing to beta at alpha and 0 elsewhere mod 2^32;
              the packing round trips on the resident views; DatabaseSpec's
              device views against the database's (bytes the words'
              storage). B1 and B3 advance by exactly the calls made, every
              other kernel by none, no plain call
  check_ggm   the GGM level kernel against its plain version (full-range
              seeds at n = 2^24 and at n = 1000 with 256-thread blocks
              requested, rounds 12 and 2), then ops.ggm_eval_leaves over one
              PIR_1G key (25 launches) against the plain leaf expansion
  engine_smoke  python -m repro_torch.engine --smoke on the card
  tune        the tuner: tune_standalone("ggm-expand", 2^24) beside the
              bound, then autotune at PIR_1G and PIR_1G_ADD, buckets 1 and
              32, into a plan cache under a temporary directory: per bucket
              the heuristic's and the tuned plan's ms per batch (every
              party's answer step back to back), every timed candidate,
              what the memory model pruned, the heuristic's predicted and
              measured peak memory
  serve_tuned TwoServerPIR at PIR_1G and PIR_1G_ADD with path=None on that
              cache: batches of 32 and 1 and a session, records exact, plans
              "tuned", the tuned plans' kernels launched; then end-to-end
              latency of batches of 1 and 32 on the tuned and a heuristic
              deployment, interleaved (fails if the tuned median is slower by
              more than the heuristic's spread), beside the card's clocks and
              the heuristic's latency from timing / timing_add
The plan cache is off (REPRO_TORCH_PLAN_CACHE=off) in every other phase, so
their plans are plan_for's. Then every record width and verified
reconstruction:
  database_widths  PIR_1G's records stored with their checksum word (36
              bytes, W = 9, 1,207,959,552 B) and 2^23 records of 128 bytes
              (W = 32, 1 GiB) from their own seed, both on the card
  check_widths  B1-B4 on those operands exact against their plain versions
              at Q = 1 and Q = 32 (the fused add at 128 bytes for both
              parties, and at 256, 512, 1056 and 2048 bytes on 2^16 rows:
              its split instance at 4 to 32 lanes per subtree, past 1024
              bytes in passes), dpXOR on a row slice only 4-byte aligned,
              the fused XOR's wide instance at 1,028-byte records and on a
              row slice of 5,120-byte records (2^16 rows, Q = 1, 4, 32,
              33), ptxas's registers and spills of each instance the widths
              select, then each kernel at 32, 36 and 128 bytes timed in turns
              beside its bound
  serve_chk   TwoServerPIR with checksum=True at PIR_1G, xor-dpf-2 and
              additive-dpf-2: one word of one party's share flipped for one
              query of a batch of 32 must raise IntegrityError naming that
              query; batches of 32 and 1 and a session exact at the logical
              width on the path's kernels
  serve_w128  TwoServerPIR over the 128-byte records, XOR and additive:
              batches of 32 and 1 and a session exact
  updates     online updates on the resident PIR_1G database: for 1, 64 and
              4096 fresh rows, stage and publish (seconds, bytes host to
              device, device bytes cloned), then XOR and additive batches of
              32 and 1 exact and tagged with the new epoch; a snapshot read
              before the publish serves the old rows with the old tag;
              batches of 32 right after a publish and without one, in turns;
              the dispatch wait (snapshot() on the scheduler thread) while a
              session serves and another thread publishes 20 times
The XOR/additive databases are then freed.
  batch       BatchPIR at PIR_1G_BATCH (2^25 records, m = 256, B = 512
              buckets, xor-dpf-2) alone on the card: the cuckoo layout and
              the BucketedDatabase built and timed, two rounds (256
              distinct indices, then one with duplicates) exact and 512
              wide, a second facade with n_clusters=2 over the same buckets
              (two rounds of 256 distinct indices submitted before either
              is waited on: exact, each lane carrying a batch, every
              dispatch 512 wide), then 64 global rows published into every
              candidate bucket and a round serving them with the new epoch
Then the single-server LWE scheme runs at PIR_128M_LWE (2^22 records x
32 B; A is 2^22 x 1024 int32 = 16 GiB):
  database_lwe  its own records from a seed, the int32 byte view, and A
              drawn on the host threads and placed on the card (timed)
  check_lwe   the int32 GEMM kernel against its plain version with full-
              range int32 operands (every sum wraps): the answer at 1, 8 and
              32 queries, the hint and the client's A.S at 1, 32 and 40
              queries
  serve_lwe   SingleServerPIR: batches of 32 and 1, then a session;
              records exact, the GEMM kernel launched, no plain call, and
              one hint fetch
  encrypt_lwe the one-query lwe.encrypt while A is resident: one B5
              launch, equal to row 0 of encrypt_batch under the same seed
              and to host numpy A.s + e + Delta * onehot mod 2^32 on 4,096
              sampled rows; DatabaseSpec's device views equal to the
              database's resident bytes and bytes32
  timing_lwe  the kernel at 1 and 32 queries beside its bound and the plain
              version, the hint build, and batches of 1 and 32 end to end
              with host keygen, A.S on the card, the answer and host decode
              apart; peak device memory; the client's A.S at 33, 36 and 40
              queries beside 32 and beside two 32-wide tiles, in turns
  updates_lwe  publishes of 1, 3, 64 and 4096 rows: each delta-updated hint
              equal to a full rebuild, B5 at each delta shape ([32, R4] x
              [R4, 1024]) exact and timed; SingleServerPIR serves the
              updated records, and a batch answered from a snapshot read
              before a publish decodes with the retired epoch's hint
  serve_chk (LWE)  the same records with checksum=True (36 bytes): B5 exact
              against its plain version at the answer shapes (1 and 32
              queries x 36) and the hint shape ([36, N] x A), timed at 36
              and 32 columns in turns; an answer word's top byte flipped
              and an answer shifted by Delta, which the noise check passes,
              must each raise IntegrityError naming the query; batches of
              32 and 1 and a session exact at the logical width; a publish
              of 64 rows whose hint delta ([36, 64] x [64, 1024], B5's
              40-row tile) equals a rebuild, and the updated records served
  twins       python -m repro_torch.db_updates and .batch_query on the card
  serve_runtime  the serving runtime at PIR_1G on the 1 GiB and checksum
              databases (kept resident for it): PIRServeLoop per party
              (n_clusters 2; 8 batches of 32, one of 5, one of 1 from
              pir.batch_queries) drained serially and pipelined in turns,
              equal shares that XOR to the rows; TwoServerPIR sessions with
              256 queries from 4 client threads at n_clusters 2 and 1 in
              turns, exact, queue_depth 0; the same sessions on the plain
              and the checksum database in turns (plain, chk, chk, plain,
              twice): 1 - plain/chk of the median per-batch latency, its
              spread over the turns, and whether that spread lies within
              the reference's 15 % budget, reported, not held; a seeded
              StragglerMonitor that
              sheds cluster1's queued batches onto cluster0; kill() and
              drain_handoff() under load (every future resolves, none is
              lost); a flipped share with checksum=True killing a session
              (every outstanding future fails with the IntegrityError naming
              the query) and failing a pump (launched batches fail, the rest
              stays queued); the multi_server, single_server,
              serving_session, replicas and private_inference twins (the
              last at the example's 2-layer model: B1) and the chaos smoke
              (python -m repro_torch.chaos --smoke: a seeded kill and a
              seeded share corruption through a two-replica LWE fleet) as
              subprocesses, started together. B1 and B2 (and B5 in the
              single_server, replicas and chaos twins) launched, no plain
              call
  replicas    the replica plane at PIR_1G, last (its warm plan-cache entries
              reach no other phase), once the resident databases are freed:
              two ServeReplicas on carve_submeshes(2, model_axis=1) ((1, 1)
              meshes, both on cuda:0), each placing its own 1 GiB Database,
              behind a seeded Router; join (build and attach seconds, the
              first exact answer), a 64-row publish fanned out to epoch 1,
              128 queries from 4 client threads through the fleet and
              through r1 alone (sessions pinned), four turns (records/s,
              the split, each replica's batches and pad fraction, the
              metrics snapshot), the same four turns with the keys made
              before the window (serving alone), 32 single-query keygens
              one after another and over 4 threads, r0 killed under 64 pinned
              queries (every future exact at epoch 1; seconds from the kill
              to the last future), a corrupt at replica.serve_step through
              a ChaosInjector held by c0 (buckets of one, so no padding row
              can absorb the flip) and the router, on one of two checksum
              replicas (the one corrupt logged, every pinned query exact
              from the peer, c0 the one suspect), two fresh replicas k0 and
              k1 with a kill at k0's scheduler.dispatch seam under 64
              pinned queries (the one kill logged, every future exact from
              k1, k0's dead session rejecting new work, the seconds from the
              first submit to the last future), a warm rejoin (epoch 1 from
              the delta log, no heuristic plan), a detach under 128 queries
              (handed off, all exact); peak device memory. B1 and B2
              launched, no plain call
  sharded     A6b's serving path, once the fleets are freed: four ranks of
              torch.distributed (processes started with
              torch.multiprocessing, one FileStore under a temporary
              directory) share this card under gloo, their collectives
              through the host; each loads the parent's kernels (no nvcc)
              and memory-maps the parent's PIR_1G and PIR_128M_LWE words.
              On the (1, 4) and (2, 2) meshes each rank holds its row block
              and serves xor-dpf-2 through TwoServerPIR(mesh=) at 32 and 1
              queries under both collectives (keys drawn on rank 0 only and
              broadcast), additive-dpf-2 and xor-dpf-k at 32, then 8 rows
              updated over all four blocks and served; one lwe-simple-1
              answer of 32 seeded ciphertexts (B5 on each block, the int32
              all-reduce) equal to one unsharded B5 answer on rank 0;
              then SingleServerPIR(mesh=) at PIR_128M_LWE: 8 indices
              encrypted on rank 0 (the whole A there, one block of A on
              each other rank), the hint built per block and summed, equal
              to an unsharded B5 build on rank 0, an update of rows in
              every block (one hint delta on every rank, the hint again
              equal to a rebuild) and those rows served. On (1, 4),
              BatchPIR(mesh=) at PIR_1G_BATCH from the batch phase's
              layout (saved once, memory-mapped by the ranks), each rank's
              block of the 512 buckets read from the mapped records: a
              round of 256 distinct indices, a publish of 64 rows whose
              slots land in every block, a round with them. Records exact;
              each rank's counters advance by exactly one launch of its
              plan's kernel a party and batch (B1: 512 a party and round;
              B5: A.s on rank 0, one block build, one delta), one reduce a
              party and batch dispatch, no plain call; one epoch on every
              rank; start_block 0-3 on (1, 4). Per rank: device, rows,
              launches, the answer step's and the collective's CUDA-event
              ms, the block hint build, B5 at the block's shape, the delta
              and the hint's all-reduce, B1 on a bucket's block, each
              part's seconds, max_memory_allocated (time-sliced ranks:
              not a scaling figure); which gloo collectives take a CUDA
              tensor. Then sessions through the controller (rank 0: it
              cuts the batches, the others follow its commands): xor at
              PIR_1G on (1, 4) (64 queries from 4 client threads, a
              publish of rows in every block between its batches of 32),
              the same on (2, 2) with two lanes, a corrupt at
              replica.serve_step (exactly one word of one record) and a
              kill at scheduler.dispatch (every rank out of its loop
              within SHARDED_KILL_BOUND_S) on (1, 4), an LWE session (one
              hint build and one delta on every rank) and a BatchPIR round
              of 256 in a session; records exact at their epochs, each
              follower's dispatches the controller's batches, launches
              exact; each part's seconds, the median batch latency,
              records/s, the channel's host time a dispatch and the kill
              to the last rank's exit. Last, a fleet (sharded_fleet, its
              own line): two PIR_1G replicas on the (1, 2) sub-meshes of
              carve_submeshes(2, model_axis=2), each rank half of its
              replica's database, rank 0 the fleet's controller (inside
              r0's grid, outside r1's, whose first rank sends each answer
              back) and the others following the fleet; a 64-row publish
              through the router, 64 queries from 4 client threads, r0
              killed under 32 pinned queries, a warm rejoin of r0 with a
              whole bucket pinned to it, a graceful leave with 8 queued
              (handed off to r1); then the chaos smoke's scenario B on
              (1, 2) sub-meshes (one word of one record's answer flipped
              and caught). Records exact at epoch 1, each rank's launches
              those its replicas' dispatched batches call for, no plain
              call, followers' dispatches the controller's; records/s,
              the median batch latency, a reply's send-to-arrival time,
              the kill to the last exit, the rejoin's seconds, each rank's
              peak
  private_lm  the dense LM, once the fleets are released: qwen3-4b at full
              width and depth (36 layers, d_model 2,560, vocab 151,936,
              bf16, 8.8 GB of weights drawn from a seeded generator on the
              card). make_serve_step's prefill on 4 streams x 2,048 tokens
              (two attention chunks) and 32 decode steps with write=True
              (prefill s, decode ms per token, tokens/s); the last decode's
              logits against a forward over the same 2,080 tokens (within
              LM_LOGIT_TOL, greedy tokens equal but for near-ties). Then the
              private_inference twin on that model: 4 streams, a 16-token
              prompt, 16 new tokens, every embedding retrieved through
              TwoServerPIR (xor-dpf-2) over the table padded to 2^18 rows x
              5,120 B = 1.25 GiB (the prompt in buckets of 32 and each step
              in a bucket of 4: B2; one step for a stream alone: B1), rows
              bit-exact, tokens equal to the loop on plain lookups; PIR s
              per batch and its share of each token's time. B1 and B2
              launched, no plain call. Then B1 (Q = 1) and B2 (Q = 4, 32)
              at 1,280 words exact against their plain versions, timed
              beside their bounds
Then the MoE family's serving path, each arch at full width with its depth
cut (dataclasses.replace of FULL, PERF.md section 4):
  moe_serve   grok-1-314b, 64 -> 4 layers (all MoE; 21.29 B parameters,
              42.6 GB in bf16, drawn from a seeded generator on the card):
              make_serve_step's prefill on 4 streams x 2,048 tokens (twice)
              and 32 decode steps, which take the batch-global dispatch (4
              streams x top-2 >= 8 experts); the prefill's last logits
              against a forward over the same tokens (within
              LM_LOGIT_TOL: an identity in the reference); at the first MoE
              layer of one decode step the branch that ran against the
              other on the same hidden states (MOE_BRANCH_TOL, no slot
              dropped); the last decode against a forward over all 2,080
              tokens and the slots the forwards' dispatch dropped,
              reported, not held (a decode never drops a slot, the
              forward's capacity may). No kernel of the six launched
  private_moe  deepseek-v3-671b, 61 -> 5 layers (the 3 dense ones and 2
              MoE; MLA with its latent cache, 26.62 B parameters and 0.69
              B in the MTP head, 54.6 GB): the same serve checks (its
              decode takes the per-token gather, 4 x 8 < 256), then the
              private_inference twin over its table padded to 2^17 rows x
              14,336 B = 1.75 GiB (B2 for the streams' batches, B1 alone;
              rows bit-exact, tokens those of plain lookups), then B1 (Q =
              1) and B2 (Q = 4, 32) at 3,584 words exact against their
              plain versions, timed beside their bounds
Then the VLM family's serving path:
  vlm_serve   llava-next-34b at full width, 60 -> 16 layers (9.84 B
              parameters, 19.7 GB in bf16, drawn from a seeded generator on
              the card): make_serve_step at 4 streams x 4,096 positions
              (each 2,880 prefix rows of seeded patch embeddings + 1,216
              text tokens) and 32 decode steps with write=True; the
              prefill's last logits against a forward over the same prefix
              and tokens, the last decode against a forward over all 4,128
              positions (within LM_LOGIT_TOL, greedy tokens equal but for
              near-ties); no kernel of the six launched. Then the
              private_inference twin with each stream's image prefix kept
              on the client: 4 streams, a 16-token text prompt, 16 new
              tokens, the text tokens' rows through TwoServerPIR over the
              table padded to 2^16 rows x 14,336 B (B2 for the streams'
              batches, B1 alone; rows bit-exact, tokens those of plain
              lookups, no plain call), then B1 (Q = 1) and B2 (Q = 4, 32) at
              3,584 words over the 2^16 rows exact against their plain
              versions, timed beside their bounds
Then the audio family's serving path:
  audio_serve whisper-small uncut (12 encoder + 12 decoder layers, d_model
              768, 0.263 B parameters with its 32,768 learned decoder
              positions, drawn from a seeded generator on the card):
              make_serve_step at 4 streams x (1,500 seeded frames through
              the encoder + 2,048 decoder tokens), the cross K/V cached
              once, and 32 decode steps with write=True; the prefill's last
              logits against a forward over the same frames and tokens, the
              last decode against a forward over all 2,080 tokens (within
              LM_LOGIT_TOL, greedy tokens equal but for near-ties); no
              kernel of the six launched. Then the private_inference twin
              with each stream's frames kept on the client: 4 streams, a
              16-token prompt, 16 new tokens, the decoder tokens' rows
              through TwoServerPIR over the tied table padded to 2^16 rows
              x 1,536 B (384 words, 96 MiB; B2 for the streams' batches, B1
              alone), then B1 (Q = 1) and B2 (Q = 4, 32) at 384 words exact
              against their plain versions, timed beside their bounds
Then the SSM family's serving path:
  ssm_serve   xlstm-350m uncut (24 blocks: 21 mLSTM and 3 sLSTM, d_model
              1,024, chunk 256; 0.529 B parameters, 1.08 GB, drawn from a
              seeded generator on the card): make_serve_step at 4 streams x
              2,048 tokens and 32 decode steps (the recurrent state, 88.6 MB
              a stream, advances; capacity and write are ignored); the
              prefill's last logits against a forward over the same tokens,
              the last decode against a forward over all 2,080 tokens at
              chunk 32 (2,080 is no multiple of 256: ssd_scan raises there,
              as the reference's), within LM_LOGIT_TOL, greedy tokens equal
              but for near-ties; no kernel of the six launched. Then the
              private_inference twin (text only): 4 streams, a 16-token
              prompt, 16 new tokens, every row through TwoServerPIR over the
              table padded to 2^16 rows x 2,048 B (512 words, 128 MiB; B2 for
              the streams' batches, B1 alone), rows bit-exact, tokens those
              of plain lookups; then B1 (Q = 1) and B2 (Q = 4, 32) at 512
              words exact against their plain versions, timed beside their
              bounds (ssm_serve_kernels). About 15 s
  ssm_long    the long_500k cell, which only the SSM and hybrid archs run
              (cell_is_skipped false for the archs of LONG_CONTEXT_ARCHS,
              xlstm-350m and zamba2-7b, true for every other): xlstm's
              serve step at batch 1, init_cache(1, 524,288) holding the
              bytes of init_cache(1, 2,048), a 256-token prompt prefilled,
              then 8 decodes from the prompt's state and 8 from the long
              cache (ms a token), the long cache's first decode bit-equal to
              the short one's, the prompt's last decode against a forward.
              About 2 s
Then the hybrid family's serving path:
  hybrid_serve  zamba2-7b uncut (81 Mamba2 layers, d_model 3,584, chunk
              256, and one weight-shared attention + MLP block applied
              after every 6th layer: 13 invocations, each its own KV cache;
              6.75 B parameters, 13.5 GB in bf16, drawn from a seeded
              generator on the card): make_serve_step at 4 streams x 2,048
              tokens, capacity 2,080, and 32 decode steps with write=True
              (prefill s, decode ms per token, the decode state's bytes a
              stream: the Mamba states and the KV caches apart); the
              prefill's last logits against a forward over the same
              tokens (within LM_LOGIT_TOL); the last decode's difference
              from a forward over all 2,080 tokens at chunk 32
              (ssm_chunk_for) reported beside two bf16 forwards' own
              (chunks 16 and 32), the decode's identity held by a float32
              twin at full size, one stream, 27 GB (within
              HYBRID_F32_TOL), greedy tokens equal but for near-ties; no
              kernel of the six launched. Then the private_inference twin
              (text only): 4
              streams, a 16-token prompt, 16 new tokens, every row of the
              input table embed through TwoServerPIR over it padded to 2^15
              rows x 7,168 B (1,792 words, 224 MiB; B2 for the streams'
              batches, B1 alone), rows bit-exact, tokens those of plain
              lookups; then B1 (Q = 1) and B2 (Q = 4, 32) at 1,792 words
              exact against their plain versions, timed beside their bounds
              (hybrid_serve_kernels)
  hybrid_long the long_500k cell of zamba2-7b at batch 1, its depth cut 81
              -> 36 layers (6 shared invocations: 13 KV caches of 524,288
              rows would be 97.7 GB): a 256-token prompt prefilled into KV
              caches of 524,288 rows (45.1 GB) and 8 timed decodes with
              write=True; the Mamba states' bytes equal at capacity
              524,288 and 2,048, the KV caches' 2 g C KV hd 2 B; the last
              decode against a forward over the 264 tokens (within
              LM_LOGIT_TOL), the first decode against the one from a
              prefill at capacity 2,048 (the difference reported, whether
              bit-equal said); peak device memory (decode_attention_append
              copies one 7.5 GB K or V cache to float32 at a time)
Then the LM's training half, which launches none of the six kernels (its
counters must stay 0):
  train_step  granite-3-2b at full width and depth (40 layers, d_model
              2,048, vocab 49,155, 2.63 B parameters in bf16 drawn from a
              seeded generator on the card) through make_train_step at
              train_4k's 4,096 tokens, the global batch of 256 cut to
              TRAIN_BATCH sequences (one per microbatch), AdamW, remat
              "block": one warm-up step, one timed one and one under
              torch.profiler, all on the pipeline's batch 0; every loss
              finite, the first within 0.5 of ln(vocab), the last below the
              first; seconds per step, tokens/s, the model-FLOPs share (6 N
              tokens / step s / the bf16 dense peak,
              analysis/roofline.PEAK_BF16_FLOPS_PER_S), peak device memory,
              the traced step's device events and idle share
  dryrun      the six custom ops' fakes opchecked against their kernels at
              the check phase's shapes (schema and fake tensors; all must
              pass); then train_step's RunConfig and timing's PIR_1G
              xor-dpf-2 batch of 32 run on the meta device under the
              op-level cost counter (python -m repro_torch.launch.dryrun's
              lower_cell / lower_pir_cell, in a child process started after
              the build, so the card's phases do not wait for its host
              seconds): the predicted resident bytes within 1 % of the
              card's after init (plus the batch), the predicted peak within
              10 % of max_memory_allocated; op_cost's FLOPs beside the
              model FLOPs, the roofline step time and the measured step's
              share of it; the PIR step's counted bytes beside the engine's
              modeled bytes, its roofline memory term beside the measured
              B2 launch and end-to-end batch
  moe_train   the same for the MoE family: grok-1-314b, 64 -> 1 layer
              (6.53 B parameters, 2.91 B active, 13.06 GB in bf16), 2
              sequences of 4,096 tokens in one microbatch, Adafactor over
              the moe_layers leaves (one expert slice at a time); the first
              loss within 0.5 of ln V + s^2 / 2, s the logits' std on a
              forward over the first sequence (whose dropped slots are
              reported); the model-FLOPs share over the active parameters
  vlm_train   the same for the VLM family: llava-next-34b, 60 -> 4 layers
              (3.15 B parameters, 6.3 GB in bf16), 2 sequences of 2,880
              prefix rows + 1,216 text tokens in 2 microbatches of 1 (each
              its slice of prefix_embeds), Adafactor; the first loss within
              0.5 of ln V + s^2 / 2; the model-FLOPs share counts all 4,096
              positions, since the trunk runs the prefix too
  audio_train the same for the audio family: whisper-small uncut, train_4k's
              4,096 decoder tokens behind 1,500 frames a sequence, the
              global batch of 256 cut to 8 in 2 microbatches of 4 (each its
              slice of frame_embeds), AdamW (the reference's policy for the
              arch); the first loss within 0.5 of ln V + s^2 / 2; the
              model-FLOPs share counts the encoder's parameters over the
              frames and the decoder's and the tied unembedding's over the
              tokens (6 N tokens does not describe an encoder-decoder)
  ssm_train   the same for the SSM family: xlstm-350m at full width, its
              depth cut 24 -> 16 blocks (14 mLSTM, 2 sLSTM), at chunk 256,
              train_4k's 4,096 tokens, the global batch of 256 cut to 8 in
              one microbatch (the reference's policy has 4: the sLSTM's loop
              over time makes a step's launches follow the microbatches),
              AdamW; one warm-up step, one timed, one traced; the
              model-FLOPs share counts every parameter at its block's own
              size. About 40 s
  hybrid_train  the same for the hybrid family: zamba2-7b at full width, 81
              -> 12 layers (2 shared invocations, 1.37 B parameters: at full
              depth the weights and AdamW state alone are 94.5 GB and the
              step's peak 234.7 GB, python -m repro_torch.launch.dryrun
              --arch zamba2-7b --shape train_4k --batch 8) at chunk
              256, train_4k's 4,096 tokens, the global batch of 256 cut to 8
              in the reference's policy of 8 microbatches, AdamW; one
              warm-up step, one timed, one traced; the model-FLOPs share
              counts the shared block once per invocation
  train_parity  granite-3-2b, qwen3-4b, deepseek-v3-671b, grok-1-314b,
              llava-next-34b, whisper-small, xlstm-350m and zamba2-7b SMOKE
              in float32
              (llava with its prefix, whisper with its frames), the
              same weights and batches on the card
              and on the CPU: three AdamW steps, and three Adafactor steps
              with compress_grads and two microbatches; losses and
              parameters within the PARITY_* tolerances; for the MoE archs
              the top-k routes that part at step 0, counted and reported
  train_loop  the train_lm twin's recipe (model_100m, 16 x 512, two
              microbatches) through TrainLoop and CheckpointManager under a
              temporary directory: run A, 9 steps with a checkpoint every
              3; run B, 3 steps, then a fresh loop resumed to 9. A's last
              loss below its first, three checkpoints kept, B's resumed
              losses A's within LOOP_RESUME_TOL; checkpoint copy, write and
              restore seconds, steps/s
Then the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line. Without a CUDA card the script exits 1 at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20251016

# The kernels' bounds and the card's constants (NVIDIA H100 SXM data
# sheet) are the package's (analysis/roofline.py); the training phases'
# optimizers and microbatches follow the dry run's per-arch policy
from repro_torch.analysis.roofline import (  # noqa: E402
    INT32_OPS_PER_S, dpxor_bound_ms, fused_add_bound_ms, fused_bound_ms,
    fused_xor_bound, gemm_bound_ms, ggm_bound, lwe_gemm_bound,
    model_flops_for)
from repro_torch.launch.dryrun import ARCH_POLICY  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
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


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> dict:
    """Mean device time a call of ``fn()`` spends in the kernels whose
    symbol holds ``kernel``, over ``reps`` calls under torch.profiler
    (device activity only): the kernel alone. CUDA events around
    back-to-back calls (:func:`cuda_time_ms`) also hold the card's waits
    for the wrapper's host work, once a launch is shorter than that.

    ``kernel`` names the wrapper's launch counter too (``ops.counts()``),
    read before and after the timed calls: the mean is kept only where
    exactly one matching profiler record exists for each launch, and is
    None otherwise (records lost or split would make an impossible
    time). Returns ``{"ms", "records", "launches"}``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.serve_trace import device_intervals
    from repro_torch.kernels import ops
    fn()
    torch.cuda.synchronize()
    before = ops.counts()[kernel]["launches"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = ops.counts()[kernel]["launches"] - before
    spans = [b - a for a, b, name in device_intervals(prof) if kernel in name]
    ok = launches > 0 and len(spans) == launches
    return {"ms": sum(spans) / 1e3 / reps if ok else None,
            "records": len(spans), "launches": launches}


def host_time_s(fn, *, sync: bool):
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 words carried in int32."""
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item()) if a.numel() else 0


def fused_inputs(keys, start_block: int, log_local: int, clog: int):
    """Chunk roots and correction-word levels for the fused kernel."""
    from repro_torch.core import dpf
    roots, t_roots = dpf.eval_roots_batch(keys, start_block, log_local, clog)
    lvl0 = keys.log_n - clog
    return (roots, t_roots, keys.cw_seed[:, lvl0:, :].contiguous(),
            keys.cw_t[:, lvl0:, :].contiguous())


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    info = {"phase": "device", "card": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": props.multi_processor_count,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    # compile every source in this run, even where an earlier process of
    # this checkout left a library: check_widths_ptxas reads this build's
    # ptxas report
    for name in build.LIBRARIES:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    records = build.build(list(build.LIBRARIES))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "builds": [{"name": r.name, "cmd": " ".join(r.cmd),
                      "seconds": r.seconds, "cached": r.cached,
                      "ptxas": r.ptxas} for r in records.values()]})


def phase_check(db, cfg, cfg_k3, device) -> dict:
    """Each kernel against its plain version, at the shapes of xor-dpf-2
    and of xor-dpf-k (``cfg_k3``); returns each kernel's largest error."""
    from repro_torch.core import dpf
    from repro_torch.core.protocol import _flatten_components, get, plan_for
    from repro_torch.kernels import dpxor as kd, fused_scan as kf, ops
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows, words = db.shape
    worst = {"dpxor": 0, "fused_scan_xor": 0}

    def record(kernel, got, want, **shape):
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        emit({"phase": "check", "kernel": kernel, **shape,
              "equal": bool(torch.equal(got, want)), "max_abs_err": err})
        if err:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"at {shape}: max_abs_err {err}")

    for q in (1, 4):
        bits = torch.randint(0, 2, (q, rows), generator=gen, device=device,
                             dtype=torch.int32)
        got = kd.dpxor(db, bits)
        torch.cuda.synchronize()
        record("dpxor", got, kd.dpxor_plain(db, bits), q=q, rows=rows,
               words=words)

    def check_fused(keys, clog, log_local, start_block, **extra):
        shard = db[start_block << log_local:(start_block + 1) << log_local]
        inputs = fused_inputs(keys, start_block, log_local, clog)
        got = kf.fused_scan_xor(shard, *inputs, rounds=keys.rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kf.fused_scan_xor_plain(shard, *inputs, rounds=keys.rounds)
        torch.cuda.synchronize()
        record("fused_scan_xor", got, want, q=dpf.n_queries_of(keys),
               rows=shard.shape[0], words=words, clog=clog,
               start_block=start_block, plain_s=time.perf_counter() - t0,
               **extra)

    log_n = cfg.log_n
    plan = plan_for(cfg, 32, backend="cuda")
    _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log, log_n))
    sub = min(20, log_n - 3)          # a shard of 2^20 rows at PIR_1G
    cases = [  # (queries, clog, log_local, start_block)
        (1, clog, log_n, 0), (8, clog, log_n, 0), (32, clog, log_n, 0),
        (8, 0, sub, 5), (8, min(clog, sub), sub, 5)]
    for q, cl, log_local, start_block in cases:
        keys = dpf.gen_keys_batch(
            rng, rng.integers(0, cfg.n_items, size=q), log_n)[q % 2]
        check_fused(keys.to(device), cl, log_local, start_block)

    # xor-dpf-k at its largest bucket: the path flattens 32 queries x C
    # components into 96 pseudo-queries for parties 0 and 1 and 64 for
    # party 2, so the launch spans 3 or 2 query groups (grid.y)
    proto_k = get(cfg_k3.protocol)
    keys_k = proto_k.query_gen_batch(
        rng, rng.integers(0, cfg_k3.n_items, size=32), cfg_k3)
    for party in (0, 2):
        check_fused(_flatten_components(keys_k[party]).to(device), clog,
                    log_n, 0, scheme=cfg_k3.protocol, party=party)
    return worst


def phase_check_add(db_bytes, cfg, device) -> tuple:
    """The additive scheme's kernels against their plain versions at
    PIR_1G_ADD shapes. Returns each kernel's largest error and what the
    timing phase reuses: the fused kernel's Q = 32 inputs, its plain
    output and the plain version's time."""
    from repro_torch.core import dpf
    from repro_torch.core.protocol import GEMM_TILE_R_DEFAULT, PAYLOAD_ONE
    from repro_torch.kernels import fused_scan as kf, ops, pir_matmul as km
    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    rows, cols = db_bytes.shape
    worst = {"pir_gemm": 0, "fused_scan_add": 0}
    kept = {}

    def record(kernel, got, want, **shape):
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        emit({"phase": "check", "kernel": kernel, **shape,
              "equal": bool(torch.equal(got, want)), "max_abs_err": err})
        if err:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"at {shape}: max_abs_err {err}")

    for q in (1, 4, 32):
        shares = torch.randint(-128, 128, (q, rows), generator=gen,
                               device=device, dtype=torch.int8)
        got = km.pir_gemm(shares, db_bytes)
        torch.cuda.synchronize()
        record("pir_gemm", got, km.pir_gemm_plain(shares, db_bytes), q=q,
               rows=rows, cols=cols)

    log_n = cfg.log_n
    _, clog = ops.fused_tile(rows, GEMM_TILE_R_DEFAULT, log_n)
    sub = min(20, log_n - 3)          # a shard of 2^20 rows at PIR_1G_ADD
    cases = [  # (queries, clog, log_local, start_block, party)
        (1, clog, log_n, 0, 0), (8, clog, log_n, 0, 0),
        (32, clog, log_n, 0, 0), (1, clog, log_n, 0, 1),
        (8, clog, log_n, 0, 1), (32, clog, log_n, 0, 1),
        (8, 0, sub, 5, 1), (8, min(clog, sub), sub, 5, 0)]
    for q, cl, log_local, start_block, party in cases:
        keys = dpf.gen_keys_batch(
            rng, rng.integers(0, cfg.n_items, size=q), log_n,
            payload=PAYLOAD_ONE)[party].to(device)
        shard = db_bytes[start_block << log_local:
                         (start_block + 1) << log_local]
        inputs = fused_inputs(keys, start_block, log_local, cl) + (
            keys.cw_final[:, 0].contiguous(),)
        got = kf.fused_scan_add(shard, *inputs, party=party,
                                rounds=keys.rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kf.fused_scan_add_plain(shard, *inputs, party=party,
                                       rounds=keys.rounds)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        record("fused_scan_add", got, want, q=q, rows=shard.shape[0],
               cols=cols, clog=cl, start_block=start_block, party=party,
               plain_s=plain_s)
        if (q, start_block, party) == (32, 0, 0):
            kept = {"inputs": inputs, "want": want, "clog": cl,
                    "rounds": keys.rounds, "plain_ms": plain_s * 1e3}
    return worst, kept


def check_records(got: np.ndarray, want: np.ndarray) -> bool:
    return bool(got.dtype == want.dtype and np.array_equal(got, want))


def expected_records(system, host_db: np.ndarray, idx) -> np.ndarray:
    """What the deployment must return: the DB's words, or its bytes for
    a scheme whose records are bytes."""
    from repro_torch.crypto.packing import np_words_to_bytes
    rows = host_db[np.asarray(idx)]
    _, dtype = system.protocol.record_struct(system.cfg)
    return np_words_to_bytes(rows) if dtype == np.uint8 else rows


def serve_phase(phase: str, config: str, system, host_db, *, sizes, kernels,
                rng, provenance: str = "heuristic") -> dict:
    """Serve batches of ``sizes`` through ``query()`` and then a 3-query
    session; every record must equal the database's, every party's plans
    must have ``provenance``, and the counters, zeroed just before, must
    show each of ``kernels`` launched and no plain call. Returns the
    launches of this run."""
    from repro_torch.kernels import ops
    cfg = system.cfg
    plans = {b: r["plan"]
             for b, r in system.servers[0].plan_report().items()}
    origin = {b: s.bucketed.plan_for_bucket(b).provenance
              for s in system.servers for b in s.buckets}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ops.reset_counts()
    batches = []
    for n in sizes:
        idx = rng.integers(0, cfg.n_items, size=n)
        t0 = time.perf_counter()
        recs = system.query(idx)
        batches.append({"n": n, "bucket": system.scheduler.bucket_for(n),
                        "seconds": time.perf_counter() - t0,
                        "exact": check_records(
                            recs, expected_records(system, host_db, idx))})
    idx = rng.integers(0, cfg.n_items, size=3)
    t0 = time.perf_counter()
    with system:
        futs = [system.submit(int(i)) for i in idx]
        recs = np.stack([f.result(timeout=600) for f in futs])
    batches.append({"n": len(idx), "session": True,
                    "seconds": time.perf_counter() - t0,
                    "exact": check_records(
                        recs, expected_records(system, host_db, idx))})
    counts = ops.counts()
    plain = {k: v["plain_calls"] for k, v in counts.items()}
    info = {"phase": phase, "config": config, "protocol": cfg.protocol,
            "parties": system.n_parties, "plans": plans,
            "provenance": origin, "batches": batches,
            "launches": {k: v["launches"] for k, v in counts.items()},
            "plain_calls": plain,
            "db_resident_bytes": system.db.resident_bytes,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t_phase}
    emit(info)
    if not all(b["exact"] for b in batches):
        raise AssertionError(f"{phase}: a served record differs from the "
                             f"database")
    launches = main_path_launches(phase, kernels)
    if set(origin.values()) != {provenance}:
        raise AssertionError(f"{phase}: plan provenance {origin}, expected "
                             f"{provenance!r} for every bucket")
    return launches


def phase_serve(host_db, cfg, database, device):
    from repro_torch.runtime.serve_loop import TwoServerPIR
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 4))
    return serve_phase("serve", "pir-1g", system, host_db, sizes=(32, 5, 1),
                       kernels=("dpxor", "fused_scan_xor"),
                       rng=np.random.default_rng(SEED + 3))


def phase_serve_add(host_db, cfg, database, device):
    from repro_torch.runtime.serve_loop import TwoServerPIR
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 14))
    return serve_phase("serve_add", "pir-1g-add", system, host_db, sizes=(32, 5, 1),
                       kernels=("pir_gemm", "fused_scan_add"),
                       rng=np.random.default_rng(SEED + 13))


def phase_serve_k3(host_db, cfg, database, device):
    from repro_torch.runtime.serve_loop import MultiServerPIR
    system = MultiServerPIR(database, cfg, device=device, n_queries=32,
                            client_rng=np.random.default_rng(SEED + 16))
    return serve_phase("serve_k3", "pir-1g-k3", system, host_db, sizes=(32, 1),
                       kernels=("dpxor", "fused_scan_xor"),
                       rng=np.random.default_rng(SEED + 15))


def phase_timing(database, cfg, card, device):
    from repro_torch.core import dpf
    from repro_torch.core.protocol import PATH_PLANS, plan_for
    from repro_torch.kernels import dpxor as kd, fused_scan as kf, ops
    from repro_torch.runtime.serve_loop import TwoServerPIR
    rng = np.random.default_rng(SEED + 5)
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 6))
    db = database.view("words")
    rows, words = db.shape
    log_n = cfg.log_n
    proto = system.protocol
    out = {"phase": "timing", "card": card, "config": "pir-1g"}

    # dpXOR at the main path's shape: one query's selection bits
    k1 = proto.query_gen_batch(rng, [int(rng.integers(cfg.n_items))], cfg)[0]
    k1 = k1.to(device)
    bits = dpf.eval_bits_batch(k1, 0, log_n)
    d_ms = cuda_time_ms(lambda: kd.dpxor(db, bits), reps=20)
    d_plain = cuda_time_ms(lambda: kd.dpxor_plain(db, bits), reps=2)
    out["dpxor"] = {"q": 1, "rows": rows, "ms": d_ms, "plain_ms": d_plain,
                    "bound_ms": dpxor_bound_ms(rows, words, 1),
                    "bound_by": "bytes"}

    # fused scan at the main path's largest bucket (32 queries, clog 11)
    plan = plan_for(cfg, 32, backend="cuda")
    _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log, log_n))
    k32 = proto.query_gen_batch(
        rng, rng.integers(0, cfg.n_items, size=32), cfg)[0].to(device)
    inputs = fused_inputs(k32, 0, log_n, clog)
    f_ms = cuda_time_ms(lambda: kf.fused_scan_xor(db, *inputs,
                                                  rounds=k32.rounds), reps=3)
    f_plain = cuda_time_ms(lambda: kf.fused_scan_xor_plain(
        db, *inputs, rounds=k32.rounds), reps=1, warmup=0)
    # the profiler's mean beside the CUDA events', on a launch (32 ms) long
    # enough to hide the wrapper's host time
    f_dev = kernel_device_ms(lambda: kf.fused_scan_xor(
        db, *inputs, rounds=k32.rounds), "fused_scan_xor", reps=3)
    out["fused_scan_xor"] = {"q": 32, "rows": rows, "clog": clog,
                             "ms": f_ms, "plain_ms": f_plain,
                             "bound_ms": fused_bound_ms(rows, 32, clog,
                                                        k32.rounds),
                             "bound_by": "operations",
                             "kernel_device_ms": f_dev["ms"],
                             "kernel_records": f_dev["records"],
                             "kernel_launches": f_dev["launches"]}
    for name in ("dpxor", "fused_scan_xor"):
        r = out[name]
        r["beats_bound"] = r["ms"] < r["bound_ms"]
        if r["beats_bound"]:
            print(f"NOTE: {name} ran in {r['ms']:.4f} ms, under its bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)

    # pieces of one batch: client keygen, root descent / bit expansion
    for q in (1, 32):
        idx = rng.integers(0, cfg.n_items, size=q)
        kg_s, keys = host_time_s(
            lambda: proto.query_gen_batch(rng, idx, cfg), sync=False)
        keys = keys[0].to(device)
        if q == 1:
            desc_ms = cuda_time_ms(lambda: dpf.eval_bits_batch(keys, 0, log_n),
                                   reps=3)
            kernel_ms = d_ms
        else:
            desc_ms = cuda_time_ms(
                lambda: fused_inputs(keys, 0, log_n, clog), reps=3)
            kernel_ms = f_ms
        out[f"batch_{q}_parts"] = {
            "keygen_s": kg_s, "descent_ms_per_party": desc_ms,
            "kernel_ms_per_party": kernel_ms,
            "plan": plan_for(cfg, q, backend="cuda").name}

    # end to end through TwoServerPIR.query (host clock, result on host)
    out["card_state"] = card_state()
    out.update(e2e(system, cfg, rng, ((1, 5), (32, 3))))

    # one party's answer step at a batch of 1, under each CUDA plan
    out["answer_1_ms_by_plan"] = {
        PATH_PLANS[path].name: cuda_time_ms(
            lambda: proto.answer_local(db, k1, 0, log_n, PATH_PLANS[path]),
            reps=3)
        for path in ("cuda", "fused-cuda")}
    out["peak_device_bytes_run"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def e2e(system, cfg, rng, reps_by_q) -> dict:
    """Median host-clock latency of ``query()`` (records on the host)."""
    out = {}
    for q, reps in reps_by_q:
        lat = []
        for _ in range(reps):
            idx = rng.integers(0, cfg.n_items, size=q)
            lat.append(host_time_s(lambda: system.query(idx), sync=False)[0])
        med = float(np.median(lat))
        out[f"e2e_{q}"] = {"latency_s": lat, "median_s": med,
                           "records_per_s": q / med}
    return out


def phase_timing_add(database, cfg, cfg_k3, card, device, kept):
    from repro_torch.core import dpf
    from repro_torch.core.protocol import plan_for, resolve_plan
    from repro_torch.kernels import fused_scan as kf, pir_matmul as km
    from repro_torch.runtime.serve_loop import MultiServerPIR, TwoServerPIR
    rng = np.random.default_rng(SEED + 17)
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 18))
    db = database.view("bytes")
    rows, cols = db.shape
    log_n = cfg.log_n
    proto = system.protocol
    out = {"phase": "timing_add", "card": card, "config": "pir-1g-add"}

    # int8 GEMM at the main path's shape: one query's shares
    k1 = proto.query_gen_batch(rng, [int(rng.integers(cfg.n_items))], cfg)[0]
    k1 = k1.to(device)
    shares = dpf.eval_bytes_batch(k1, 0, log_n).view(torch.int8)
    g_ms = cuda_time_ms(lambda: km.pir_gemm(shares, db), reps=20)
    g_plain = cuda_time_ms(lambda: km.pir_gemm_plain(shares, db), reps=2)
    # library yardstick: torch._int_mm refuses a first operand of <= 16
    # rows, so it runs with the query padded to 32 rows (zero shares): a
    # 32 x 32 output over K = R, a degenerate GEMM shape. It is timed with
    # the DB as stored (both operands row-major, "NN" to cuBLAS) and with a
    # column-major copy of the DB (both operands K-contiguous, "TN", the
    # int8 tensor-core layout); library_ms is the faster form that agrees
    # with the kernel. The stored form at R/16 rows shows how its time
    # grows with K.
    want = km.pir_gemm(shares, db)
    padded = torch.zeros((32, rows), dtype=torch.int8, device=device)
    padded[:1] = shares
    db_kmajor = db.t().contiguous().t()               # [R, L], strides (1, R)
    part = rows // 16
    padded_part = padded[:, :part].contiguous()
    forms = {"nn": lambda: torch._int_mm(padded, db),
             "tn": lambda: torch._int_mm(padded, db_kmajor)}
    library = {}
    for form, fn in forms.items():
        library[form] = {"ms": cuda_time_ms(fn, reps=3),
                         "equal": bool(torch.equal(fn()[:1], want))}
    library["nn_rows_div_16"] = {
        "rows": part, "ms": cuda_time_ms(
            lambda: torch._int_mm(padded_part, db[:part]), reps=3)}
    del db_kmajor, padded_part
    agree = [library[f]["ms"] for f in forms if library[f]["equal"]]
    out["pir_gemm"] = {
        "q": 1, "rows": rows, "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": gemm_bound_ms(rows, cols, 1), "bound_by": "bytes",
        "library_ms": min(agree) if agree else None,
        "library_call": "torch._int_mm, Q padded to 32", "library": library}

    # fused select-add at the main path's largest bucket, on the check
    # phase's inputs (its plain output and time are reused, not rerun)
    inputs, clog = kept["inputs"], kept["clog"]
    f_ms = cuda_time_ms(lambda: kf.fused_scan_add(
        db, *inputs, party=0, rounds=kept["rounds"]), reps=3)
    again = kf.fused_scan_add(db, *inputs, party=0, rounds=kept["rounds"])
    if not torch.equal(again, kept["want"]):
        raise AssertionError("fused_scan_add differs from its plain version "
                             "in the timing run")
    out["fused_scan_add"] = {
        "q": 32, "rows": rows, "clog": clog, "ms": f_ms,
        "plain_ms": kept["plain_ms"],
        "bound_ms": fused_add_bound_ms(rows, 32, clog, kept["rounds"]),
        "bound_by": "operations", "library_ms": None}
    for name in ("pir_gemm", "fused_scan_add"):
        r = out[name]
        r["beats_bound"] = r["ms"] < r["bound_ms"]
        if r["beats_bound"]:
            print(f"NOTE: {name} ran in {r['ms']:.4f} ms, under its bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)

    # pieces of one batch: client keygen, leaf shares / root descent
    for q in (1, 32):
        idx = rng.integers(0, cfg.n_items, size=q)
        kg_s, keys = host_time_s(
            lambda: proto.query_gen_batch(rng, idx, cfg), sync=False)
        keys = keys[0].to(device)
        if q == 1:
            desc_ms = cuda_time_ms(
                lambda: dpf.eval_bytes_batch(keys, 0, log_n), reps=3)
            kernel_ms = g_ms
        else:
            desc_ms = cuda_time_ms(
                lambda: fused_inputs(keys, 0, log_n, clog), reps=3)
            kernel_ms = f_ms
        out[f"batch_{q}_parts"] = {
            "keygen_s": kg_s, "descent_ms_per_party": desc_ms,
            "kernel_ms_per_party": kernel_ms,
            "plan": plan_for(cfg, q, backend="cuda").name}

    out["card_state"] = card_state()
    out.update(e2e(system, cfg, rng, ((1, 5), (32, 3))))

    # one party's answer step at a batch of 1, under each CUDA plan
    out["answer_1_ms_by_plan"] = {
        resolve_plan(path, cfg, 1, backend="cuda").name: cuda_time_ms(
            lambda: proto.answer_local(
                db, k1, 0, log_n, resolve_plan(path, cfg, 1,
                                               backend="cuda")), reps=3)
        for path in ("cuda", "fused-cuda")}

    # xor-dpf-k (k = 3) end to end on the XOR kernels
    k3 = MultiServerPIR(database, cfg_k3, device=device, n_queries=32,
                        client_rng=np.random.default_rng(SEED + 19))
    out["k3"] = {"config": "pir-1g-k3", "parties": k3.n_parties,
                 "plans": {b: r["plan"] for b, r in
                           k3.servers[0].plan_report().items()},
                 **e2e(k3, cfg_k3, rng, ((1, 2), (32, 3)))}
    out["peak_device_bytes_run"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


#: the reference answer paths' batches and the Table 1 split's batches
API_QS = (1, 4)
API_REPS = 3
#: leaf_words' check: a payload of W words over a 2^API_WORDS_LOG_N domain
API_WORDS = 8
API_WORDS_LOG_N = 20


def phase_reference_api(host_db, database, cfg, cfg_add, timing, card,
                        device) -> dict:
    """The reference's single-shard functions on the resident PIR_1G
    database (its words and bytes views) and seeded keys: answer_xor (Q =
    1) and answer_xor_batch (Q = 4) for both parties of xor-dpf-2 keys, the
    XOR of the two shares equal to the host rows; answer_additive_batch (Q
    = 4) on the bytes view, (r0 + r1) mod 256 equal to the host bytes; the
    paper's Table 1 split, phase_eval_bits and phase_dpxor at Q = 1 and 4
    by CUDA events, beside timing's descent and B1 times; leaf_bits of
    eval_all at log_n 25 equal to that key's phase_eval_bits row;
    leaf_words of a payload pair summing to beta at alpha and to 0
    elsewhere; the packing round trips on the resident views; the spec's
    device views against the database's. B1 and B3 must advance by
    exactly the calls made here, every other kernel by none, with no plain
    call. Returns the launches."""
    from repro_torch.core import dpf, pir
    from repro_torch.core.protocol import for_config
    from repro_torch.crypto import packing
    from repro_torch.db import DatabaseSpec
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 800)
    words, db_bytes = database.view("words"), database.view("bytes")
    log_n = cfg.log_n
    xor, add = for_config(cfg), for_config(cfg_add)
    out = {"phase": "reference_api", "card": card, "config": "pir-1g"}
    calls = {"dpxor": 0, "pir_gemm": 0}
    checks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ops.reset_counts()
    before = ops.counts()

    def counted(kernel, fn):
        calls[kernel] += 1
        return fn()

    # the answer paths, both parties, records against the host
    idx1 = [int(rng.integers(cfg.n_items))]
    k1 = [k.to(device) for k in xor.query_gen_batch(rng, idx1, cfg)]
    r1 = [counted("dpxor", lambda k=k: pir.answer_xor(words, k)) for k in k1]
    checks["answer_xor"] = np.array_equal(
        packing.tensor_to_words(pir.reconstruct_xor(*r1)), host_db[idx1[0]])
    idx4 = rng.integers(0, cfg.n_items, size=4)
    k4 = [k.to(device) for k in xor.query_gen_batch(rng, idx4, cfg)]
    r4 = [counted("dpxor", lambda k=k: pir.answer_xor_batch(words, k))
          for k in k4]
    checks["answer_xor_batch"] = np.array_equal(
        packing.tensor_to_words(pir.reconstruct_xor(*r4)), host_db[idx4])
    idx_add = rng.integers(0, cfg.n_items, size=4)
    ka = [k.to(device) for k in add.query_gen_batch(rng, idx_add, cfg_add)]
    ra = [counted("pir_gemm",
                  lambda k=k: pir.answer_additive_batch(db_bytes, k))
          for k in ka]
    checks["answer_additive_batch"] = np.array_equal(
        pir.reconstruct_additive(*ra).cpu().numpy(),
        packing.np_words_to_bytes(host_db[idx_add]))

    # the Table 1 split: Eval's selection bits, then dpXOR over them
    split = {}
    for q, keys in ((1, k1[0]), (4, k4[0])):
        eval_ms = cuda_time_ms(lambda: pir.phase_eval_bits(keys, log_n),
                               reps=API_REPS)
        bits = pir.phase_eval_bits(keys, log_n)
        dpxor_ms = cuda_time_ms(
            lambda: counted("dpxor", lambda: pir.phase_dpxor(words, bits)),
            reps=API_REPS)
        # the split is the batch answer: party 0's shares from above
        checks[f"phase_split_q{q}"] = torch.equal(
            counted("dpxor", lambda: pir.phase_dpxor(words, bits)),
            r1[0][None] if q == 1 else r4[0])
        split[f"q{q}"] = {"eval_ms": eval_ms, "dpxor_ms": dpxor_ms,
                          "dpxor_share": dpxor_ms / (eval_ms + dpxor_ms)}
        if q == 1:
            bits1 = bits
        del bits
    split["timing_descent_ms_per_party_q1"] = \
        timing["batch_1_parts"]["descent_ms_per_party"]
    split["timing_dpxor_ms_q1"] = timing["dpxor"]["ms"]
    out["table1_split"] = split

    # the leaves: eval_all's bits are phase_eval_bits', word shares sum
    seeds, t = dpf.eval_all(k1[0])
    checks["eval_all_leaf_bits"] = torch.equal(dpf.leaf_bits(t), bits1)
    del seeds, t
    alpha = int(rng.integers(1 << API_WORDS_LOG_N))
    beta = rng.integers(0, 1 << 32, size=API_WORDS, dtype=np.uint32)
    pair = [k.to(device) for k in dpf.gen_keys_batch(
        rng, [alpha], API_WORDS_LOG_N, payload=beta)]
    shares = [dpf.leaf_words(k, *dpf.eval_all(k), API_WORDS) for k in pair]
    total = shares[0] + shares[1]                   # int32 adds wrap
    want = torch.zeros_like(total)
    want[0, alpha] = packing.words_to_tensor(beta, device)
    checks["leaf_words_sum"] = torch.equal(total, want)
    del shares, total, want

    # packing round trips on the resident views
    as_bytes = packing.words_to_bytes(words)
    checks["bytes_round_trip"] = torch.equal(
        packing.bytes_to_words(as_bytes), words)
    checks["words_to_bytes_is_the_bytes_view"] = torch.equal(
        as_bytes.view(torch.int8), db_bytes)
    del as_bytes
    checks["bits_round_trip"] = torch.equal(
        packing.unpack_words_to_bits(packing.pack_bits_to_words(bits1)),
        bits1)
    del bits1

    # the spec's device views: the bytes view is the words' own storage;
    # bytes32 (not resident at PIR_1G) against the resident bytes widened
    spec = DatabaseSpec.from_config(cfg)
    view_b = spec.words_to_view_device("bytes", words)
    checks["spec_bytes_view"] = (torch.equal(view_b, db_bytes)
                                 and view_b.data_ptr() == words.data_ptr())
    view_32 = spec.words_to_view_device("bytes32", words)
    checks["spec_bytes32_view"] = torch.equal(
        view_32, db_bytes.view(torch.uint8).to(torch.int32))
    del view_32
    torch.cuda.synchronize()
    after = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    # the later phases read free memory and the peak: Q = 4 descents over
    # 2^25 leaves peaked at 29.5 GB on the H100
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    advanced = {k: after[k]["launches"] - before[k]["launches"]
                for k in after}
    out.update({"checks": checks, "calls": calls, "launches": advanced,
                "plain_calls": {k: v["plain_calls"] for k, v in
                                after.items()},
                "peak_device_bytes": peak,
                "seconds": time.perf_counter() - t_phase})
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"reference_api: a check failed: {checks}")
    want_launches = {k: calls.get(k, 0) for k in advanced}
    if advanced != want_launches:
        raise AssertionError(f"reference_api: launches {advanced}, expected "
                             f"exactly the calls made {want_launches}")
    return main_path_launches("reference_api", ("dpxor", "pir_gemm"))


#: the tuner's budget on the card, per (scheme, bucket): up to 8 legal
#: candidates per kernel, one warm-up and the median of 3 timed runs each,
#: no new candidate after 20 s
TUNE_BUDGET = dict(max_candidates=8, warmup=1, iters=3, max_seconds=20.0)

#: the GGM level's width on the path: the widest level of one PIR_1G key
GGM_N = 1 << 24


#: serve_tuned's interleaved rounds per batch size: each round times the
#: heuristic, the tuned, the tuned and the heuristic deployment in turn
SERVE_TUNED_ROUNDS = ((1, 2), (32, 4))


def _kernels_of(plan, share_kind: str) -> tuple:
    """The counter a plan's answer step must advance on the card; a plan
    that launches no kernel raises."""
    from repro_torch.engine.kernels import descriptor_for_plan
    library = descriptor_for_plan(plan, share_kind).library
    if library is None:
        raise AssertionError(f"plan {plan.name} launches no kernel")
    return (library,)


def card_state() -> dict:
    """SM and memory clocks, temperature and power draw, as nvidia-smi
    reads them now."""
    fields = ("clocks.sm", "clocks.mem", "temperature.gpu", "power.draw")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    return dict(zip(fields, (v.strip() for v in out.split(","))))


def phase_check_ggm(cfg, device) -> dict:
    """B6 against its plain version (full-range seeds; n = 2^24 and a small
    n the requested 256-thread block does not divide; rounds 12 and 2), then
    ``ops.ggm_eval_leaves`` over one party's key at PIR_1G against the plain
    leaf expansion (``dpf.eval_range``: the seeds and the bits
    ``eval_bits_batch`` returns). Returns the largest error, the path's
    launches, the plain version's time and the n = 2^24 inputs."""
    from repro_torch.core import dpf
    from repro_torch.core.protocol import get
    from repro_torch.kernels import ggm_expand as kg, ops
    rng = np.random.default_rng(SEED + 30)
    worst, kept = 0, {}

    def words(shape, high):
        return torch.from_numpy(rng.integers(0, high, size=shape,
                                             dtype=np.uint32).view(np.int32)
                                ).to(device)

    def record(case, got, want, **shape):
        nonlocal worst
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        emit({"phase": "check", "kernel": "ggm_expand", "case": case,
              **shape, "max_abs_err": err,
              "equal": all(torch.equal(g, w) for g, w in zip(got, want))})
        if err:
            raise AssertionError(f"ggm_expand differs from its plain version "
                                 f"({case}, {shape}): max_abs_err {err}")

    for n, rounds in ((GGM_N, 12), (GGM_N, 2), (1000, 12), (1000, 2)):
        inputs = (words((n, 4), 1 << 32), words((n,), 2),
                  words((4,), 1 << 32), words((2,), 2))
        got = kg.ggm_expand(*inputs, rounds=rounds, tile=256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kg.ggm_expand_plain(*inputs, rounds=rounds)
        torch.cuda.synchronize()
        record("level", got, want, n=n, rounds=rounds, tile=256,
               block=kg.block_for(n, 256), plain_s=time.perf_counter() - t0)
        if (n, rounds) == (GGM_N, 12):
            kept = {"inputs": inputs, "plain_ms": cuda_time_ms(
                lambda: kg.ggm_expand_plain(*inputs, rounds=rounds), reps=2)}
        del got, want

    proto = get(cfg.protocol)
    key = proto.query_gen_batch(rng, [int(rng.integers(cfg.n_items))],
                                cfg)[1].to(device)
    ops.reset_counts()
    leaves = ops.ggm_eval_leaves(key.root_seed[0], key.party, key.cw_seed[0],
                                 key.cw_t[0], cfg.log_n, rounds=key.rounds)
    torch.cuda.synchronize()
    counts = ops.counts()["ggm_expand"]
    seeds, bits = dpf.eval_range(key, 0, cfg.log_n)
    record("eval_leaves", leaves, (seeds[0], bits[0]), log_n=cfg.log_n,
           party=key.party, launches=counts["launches"],
           plain_calls=counts["plain_calls"])
    if counts != {"launches": cfg.log_n, "plain_calls": 0}:
        raise AssertionError(f"ggm_eval_leaves did not launch the kernel "
                             f"once per level: {counts}")
    return {"max_abs_err": worst, "launches": counts["launches"], **kept}


def phase_engine_smoke(device) -> None:
    from repro_torch.engine import tuner
    t0 = time.perf_counter()
    rc = tuner.smoke(device)
    emit({"phase": "engine_smoke", "rc": rc,
          "seconds": time.perf_counter() - t0})
    if rc:
        raise AssertionError(f"engine smoke returned {rc}")


def phase_tune(card, device, ggm) -> tuple:
    """The tuner on the card: B6's blocks, then both DPF schemes' buckets
    at PIR_1G into a plan cache under a temporary directory. Returns the
    cache file, B6's row and the results by config."""
    from repro_torch.configs.pir import PIR_1G, PIR_1G_ADD
    from repro_torch.core.protocol import get
    from repro_torch.engine import PlanCache, tuner
    from repro_torch.kernels import ops
    budget = tuner.TuneBudget(**TUNE_BUDGET)
    ops.reset_counts()
    t_phase = t0 = time.perf_counter()
    standalone = tuner.tune_standalone("ggm-expand", GGM_N, budget=budget,
                                       device=device)
    counts = ops.counts()["ggm_expand"]
    tile = standalone["params"]["tile"]
    ms = cuda_time_ms(lambda: ops.ggm_expand(*ggm["inputs"], tile=tile),
                      reps=20)
    row = {"n": GGM_N, "tile": tile, "ms": ms, "plain_ms": ggm["plain_ms"],
           **ggm_bound(GGM_N, 12), "library_ms": None,
           "launches": counts["launches"]}
    emit({"phase": "tune", "kernel": "ggm-expand", "card": card,
          "timings_ms": {k: v * 1e3 for k, v in
                         standalone["timings"].items()},
          "plain_calls": counts["plain_calls"], **row,
          "seconds": time.perf_counter() - t0})
    if counts["launches"] < 1 or counts["plain_calls"]:
        raise AssertionError(f"tune_standalone did not run B6: {counts}")

    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_plans_"),
                        "plan_cache_torch.json")
    cache = PlanCache(path)
    results = {}
    for name, cfg in (("pir-1g", PIR_1G), ("pir-1g-add", PIR_1G_ADD)):
        t0 = time.perf_counter()
        res = tuner.autotune(cfg, (1, 32), device=device, budget=budget,
                             cache=cache, persist=True)
        seconds = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        for b, r in res.items():
            emit({"phase": "tune", "config": name, "protocol": cfg.protocol,
                  "card": card, "bucket": b,
                  "heuristic": tuner.plan_label(r.heuristic),
                  "heuristic_ms": r.heuristic_s * 1e3,
                  "tuned": tuner.plan_label(r.plan),
                  "tuned_ms": r.tuned_s * 1e3,
                  "timings_ms": {k: v * 1e3 for k, v in r.timings.items()},
                  "n_candidates": r.n_candidates, "n_timed": r.n_timed,
                  "n_pruned": r.n_pruned,
                  "memory_pruned_predicted_bytes": r.mem_pruned,
                  "heuristic_peak_bytes": r.heuristic_peak,
                  "budget": TUNE_BUDGET, "seconds": seconds})
            if r.tuned_s > r.heuristic_s:
                raise AssertionError(f"tune {name} bucket {b}: the tuned "
                                     f"plan is slower than the heuristic")
            if tuner.plan_label(r.plan) not in r.timings:
                raise AssertionError(f"tune {name} bucket {b}: the winner "
                                     f"was not timed")
        results[name] = (cfg, get(cfg.protocol).share_kind, res)
    emit({"phase": "tune_cache", "path": path,
          "entries": len(PlanCache(path)),
          "seconds": time.perf_counter() - t_phase})
    return path, row, results


def interleaved_e2e(systems: dict, cfg, rng, rounds_by_q) -> dict:
    """Host-clock latency of ``query()`` on the ``heuristic`` and the
    ``tuned`` deployment, timed in rounds of heuristic, tuned, tuned,
    heuristic after one untimed query each, so that both meet the same
    state of the card and the host: per batch size and deployment the runs,
    their median and their spread (slowest less fastest)."""
    out = {}
    for q, rounds in rounds_by_q:
        lat = {name: [] for name in systems}
        for name, system in systems.items():
            system.query(rng.integers(0, cfg.n_items, size=q))
        for _ in range(rounds):
            for name in ("heuristic", "tuned", "tuned", "heuristic"):
                idx = rng.integers(0, cfg.n_items, size=q)
                lat[name].append(host_time_s(
                    lambda: systems[name].query(idx), sync=False)[0])
        out[f"e2e_{q}"] = {name: {"latency_s": v,
                                  "median_s": float(np.median(v)),
                                  "spread_s": max(v) - min(v)}
                           for name, v in lat.items()}
    return out


def phase_serve_tuned(host_db, database, path, results, timing, timing_add,
                      card, device) -> None:
    """Serve PIR_1G and PIR_1G_ADD on the tuned plans (``path=None`` with
    the port's cache pointed at the tuner's file), records exact and the
    plans' kernels launched; then time batches of 1 and 32 on the tuned
    and on a heuristic deployment (resolved before the cache is pointed at
    the file), interleaved. A tuned median slower than the heuristic's by
    more than the heuristic's spread fails. The cache is turned off again
    after."""
    from repro_torch import engine
    from repro_torch.engine.tuner import plan_label
    from repro_torch.runtime.serve_loop import TwoServerPIR
    configs = (("pir-1g", timing), ("pir-1g-add", timing_add))

    def deployment(cfg, seed):     # a closed session takes no queries
        system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                              buckets=(1, 32), path=None,
                              client_rng=np.random.default_rng(seed))
        for s in system.servers:       # resolve now, under this cache
            for b in s.buckets:
                s.bucketed.plan_for_bucket(b)
        return system

    heuristic = {name: deployment(results[name][0], SEED + 70 + i)
                 for i, (name, _) in enumerate(configs)}
    os.environ["REPRO_TORCH_PLAN_CACHE"] = path
    engine.plan_cache(reload=True)
    try:
        for i, (name, heur) in enumerate(configs):
            cfg, kind, res = results[name]
            system = deployment(cfg, SEED + 40 + i)
            plans = {b: system.servers[0].bucketed.plan_for_bucket(b)
                     for b in system.servers[0].buckets}
            if any(plans[b] != res[b].plan for b in plans):
                raise AssertionError(f"serve_tuned {name}: resolved plans "
                                     f"{plans} are not the tuned ones")
            kernels = tuple(sorted({k for p in plans.values()
                                    for k in _kernels_of(p, kind)}))
            rng = np.random.default_rng(SEED + 50 + i)
            serve_phase("serve_tuned", name, system, host_db, sizes=(32, 1),
                        kernels=kernels, rng=rng, provenance="tuned")
            systems = {"heuristic": heuristic[name],
                       "tuned": deployment(cfg, SEED + 60 + i)}
            heur_plans = {b: plan_label(systems["heuristic"].servers[0]
                                        .bucketed.plan_for_bucket(b))
                          for b in plans}
            state = card_state()
            out = {"phase": "serve_tuned_timing", "config": name,
                   "card": card, "card_state": state,
                   "plans": {b: plan_label(p) for b, p in plans.items()},
                   "heuristic_plans": heur_plans,
                   **interleaved_e2e(systems, cfg, rng, SERVE_TUNED_ROUNDS),
                   "card_state_after": card_state()}
            for q in (1, 32):
                out[f"timing_heuristic_e2e_{q}_median_s"] = heur[
                    f"e2e_{q}"]["median_s"]
            emit(out)
            for q, _ in SERVE_TUNED_ROUNDS:
                h, t = out[f"e2e_{q}"]["heuristic"], out[f"e2e_{q}"]["tuned"]
                if t["median_s"] > h["median_s"] + h["spread_s"]:
                    raise AssertionError(
                        f"serve_tuned {name}: the tuned batch of {q} took "
                        f"{t['median_s']:.4f} s, the heuristic's "
                        f"{h['median_s']:.4f} s (spread {h['spread_s']:.4f})")
    finally:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = "off"
        engine.plan_cache(reload=True)


def phase_database_lwe(cfg, device):
    """The LWE deployment's records (its own seed), the int32 byte view,
    and A on the card; returns (host words, Database, A)."""
    from repro_torch.core import lwe, pir
    from repro_torch.db import Database
    t0 = time.perf_counter()
    host_db = pir.make_database(np.random.default_rng(SEED + 20),
                                cfg.n_items, cfg.item_bytes)
    database = Database(host_db, cfg, device)
    database.view("bytes32")
    torch.cuda.synchronize()
    db_s = time.perf_counter() - t0
    params = lwe.params_for(cfg.n_items)
    t0 = time.perf_counter()
    a = lwe.matrix_a_device(params, cfg.n_items, device)
    torch.cuda.synchronize()
    emit({"phase": "database_lwe", "config": "pir-128m-lwe",
          "rows": cfg.n_items, "item_bytes": cfg.item_bytes, "n": params.n,
          "sigma": params.sigma, "db_seconds": db_s,
          "db_resident_bytes": database.resident_bytes,
          "a_bytes": a.numel() * a.element_size(),
          "a_seconds": time.perf_counter() - t0,
          "host_cores": os.cpu_count()})
    return host_db, database, a


#: (M, K, P) of the int32 GEMM checked beside the checksum database's
#: shapes: the wide instance at 33, 36 and 40 answer columns (4 and 8
#: remainder columns), also over several 32-row M tiles (36 rows, and the
#: client's A.S^T at 4096 rows for a batch of 36 or 40 queries); the 40-row
#: tile at 33, 36 and 40 hint rows, and 32-row tiles again at 41
LWE_TILES = ((32, 4096, 33), (32, 4096, 36), (32, 4096, 40), (1, 4096, 36),
             (36, 4096, 36), (4096, 1024, 36), (4096, 1024, 40),
             (33, 4096, 1024), (36, 4096, 1024), (40, 4096, 1024),
             (41, 4096, 1024))


def phase_check_lwe(database, a, device, *, answer_qs=(1, 8, 32),
                    client_qs=(1, 32, 40), tiles=()) -> tuple:
    """The int32 GEMM kernel against its plain version at the path's three
    shapes (the answer at ``answer_qs`` queries, the hint, the client's
    A.S^T at ``client_qs``), full size, with full-range int32 operands so
    that every sum wraps; the answer and the hint read ``database``'s
    bytes32 view, 36 columns where it holds checksums; then each (M, K, P)
    of ``tiles``. Returns the largest error and the plain answer's
    time by batch."""
    from repro_torch.kernels import lwe_matmul as kl
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    db32 = database.view("bytes32")
    rows, cols = db32.shape
    worst = {"lwe_gemm": 0}
    plain_ms = {}

    def full_range(shape):
        return torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                             device=device, dtype=torch.int32)

    def check(case, x, y, **shape):
        got = kl.lwe_gemm(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kl.lwe_gemm_plain(x, y)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max_abs_err(got, want)
        worst["lwe_gemm"] = max(worst["lwe_gemm"], err)
        emit({"phase": "check", "kernel": "lwe_gemm", "case": case,
              "m": x.shape[0], "k": x.shape[1], "p": y.shape[1],
              "instance": kl.instance(x.shape[0], y.shape[1]), **shape,
              "equal": bool(torch.equal(got, want)), "max_abs_err": err,
              "plain_s": plain_s})
        if err:
            raise AssertionError(f"lwe_gemm differs from its plain version "
                                 f"({case}, {tuple(x.shape)} x "
                                 f"{tuple(y.shape)}): max_abs_err {err}")
        return plain_s

    for q in answer_qs:            # the answer: ct [Q, N] x bytes32 [N, L]
        plain_ms[q] = check("answer", full_range((q, rows)), db32, q=q) * 1e3
    d_t = db32.t().contiguous()    # the hint as (D^T.A)^T
    check("hint", d_t, a)
    del d_t
    for q in client_qs:            # the client's A.S^T
        check("client", a, full_range((a.shape[1], q)), q=q)
    for m, k, p in tiles:
        check("tile", full_range((m, k)), full_range((k, p)))
    return worst, plain_ms


def phase_serve_lwe(host_db, cfg, database, device):
    from repro_torch.runtime.serve_loop import SingleServerPIR
    system = SingleServerPIR(database, cfg, device=device, n_queries=32,
                             client_rng=np.random.default_rng(SEED + 23))
    launches = serve_phase("serve_lwe", "pir-128m-lwe", system, host_db,
                           sizes=(32, 1), kernels=("lwe_gemm",),
                           rng=np.random.default_rng(SEED + 22))
    emit({"phase": "serve_lwe_hint", "hint_fetches": system.hint_fetches,
          "hint_builds": database.n_hint_builds})
    if system.hint_fetches != 1:
        raise AssertionError(f"serve_lwe fetched the hint "
                             f"{system.hint_fetches} times, not once")
    return launches


#: rows of the one-query ciphertext held to host numpy
ENCRYPT_CHECK_ROWS = 4096


def phase_encrypt_lwe(database, a, cfg, device) -> dict:
    """The one-query ``lwe.encrypt`` while A is resident (``a``, the cached
    ``matrix_a_device``): one B5 launch, equal to row 0 of
    ``encrypt_batch`` under the same seed, and to host numpy A.s + e +
    Delta * onehot mod 2^32 on ENCRYPT_CHECK_ROWS sampled rows (the index
    among them); then the spec's device views against the database's
    resident ones. Returns the launches of the one-query call."""
    from repro_torch.core import lwe
    from repro_torch.crypto.packing import tensor_to_words
    from repro_torch.db import DatabaseSpec
    from repro_torch.kernels import ops
    params = lwe.params_for(cfg.n_items)
    seed = SEED + 810
    index = int(np.random.default_rng(seed + 1).integers(cfg.n_items))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_counts()
    ct, state = lwe.encrypt(np.random.default_rng(seed), index, cfg.n_items,
                            params, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = main_path_launches("encrypt_lwe", ("lwe_gemm",))
    cts, states = lwe.encrypt_batch(np.random.default_rng(seed), [index],
                                    cfg.n_items, params, device)
    # the same draws on the host, and the rows of A they multiply
    s, e = lwe.sample_batch(np.random.default_rng(seed), [index],
                            cfg.n_items, params)
    rows = np.random.default_rng(seed + 2).choice(
        cfg.n_items, size=ENCRYPT_CHECK_ROWS, replace=False)
    rows[0] = index
    a_rows = tensor_to_words(a[torch.from_numpy(rows).to(device)])
    want = a_rows.astype(np.uint64) @ s[0] + e[0, rows].astype(np.uint64)
    want[0] += np.uint64(params.delta)
    want = (want & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got = tensor_to_words(ct.ct[torch.from_numpy(rows).to(device)])
    words = database.view("words")
    spec = DatabaseSpec.from_config(cfg)
    checks = {
        "shape": tuple(ct.ct.shape) == (cfg.n_items,),
        "batch_row_0": bool(torch.equal(ct.ct, cts.ct[0])
                            and np.array_equal(state.s, states[0].s)),
        "host_numpy_rows": bool(np.array_equal(got, want)),
        "spec_bytes_view": bool(
            torch.equal(spec.words_to_view_device("bytes", words),
                        database.view("bytes"))),
        "spec_bytes32_view": bool(
            torch.equal(spec.words_to_view_device("bytes32", words),
                        database.view("bytes32")))}
    emit({"phase": "encrypt_lwe", "config": "pir-128m-lwe",
          "index": index, "rows_checked": ENCRYPT_CHECK_ROWS,
          "seconds": seconds, "launches": launches, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"encrypt_lwe: a check failed: {checks}")
    if launches["lwe_gemm"] != 1:
        raise AssertionError(f"encrypt_lwe: {launches['lwe_gemm']} B5 "
                             f"launches for one query, not 1")
    return launches


def phase_timing_lwe(host_db, database, a, cfg, card, device, plain_ms):
    from repro_torch.core import lwe
    from repro_torch.crypto.packing import np_words_to_bytes
    from repro_torch.kernels import lwe_matmul as kl
    from repro_torch.runtime.serve_loop import SingleServerPIR
    rng = np.random.default_rng(SEED + 24)
    system = SingleServerPIR(database, cfg, device=device, n_queries=32,
                             client_rng=np.random.default_rng(SEED + 25))
    proto = system.protocol
    params = lwe.params_for(cfg.n_items)
    db32 = database.view("bytes32")
    rows, cols = db32.shape
    out = {"phase": "timing_lwe", "card": card, "config": "pir-128m-lwe"}
    torch.cuda.reset_peak_memory_stats()
    hint = database.hint(proto.name).cpu().numpy()

    # per batch: host keygen, A.S on the card, the answer kernel (beside its
    # bound and the plain version), decode on the host
    for q in (1, 32):
        idx = rng.integers(0, cfg.n_items, size=q)
        kg_s, (s, e) = host_time_s(
            lambda: lwe.sample_batch(rng, idx, cfg.n_items, params),
            sync=False)
        enc_s, ct = host_time_s(
            lambda: lwe.encrypt_with(s, e, idx, cfg.n_items, params, device),
            sync=True)
        s_t = torch.from_numpy(np.ascontiguousarray(
            s.T.astype(np.uint32)).view(np.int32)).to(device)
        client_ms = cuda_time_ms(lambda: kl.lwe_gemm(a, s_t), reps=3)
        ans_ms = cuda_time_ms(lambda: kl.lwe_gemm(ct.ct, db32), reps=20)
        plain = cuda_time_ms(lambda: kl.lwe_gemm_plain(ct.ct, db32), reps=1,
                             warmup=0)
        ans = kl.lwe_gemm(ct.ct, db32)
        states = [lwe.LWEClientState(s=s[i], index=int(j))
                  for i, j in enumerate(idx)]
        dec_s, rec = host_time_s(lambda: proto.reconstruct_with(
            [ans], states, cfg=cfg, hint=hint), sync=False)
        if not check_records(rec, np_words_to_bytes(host_db[idx])):
            raise AssertionError(f"timing_lwe: a record of the batch of {q} "
                                 f"differs from the database")
        bound, by = lwe_gemm_bound(q, rows, cols)
        c_bound, c_by = lwe_gemm_bound(rows, params.n, q)
        out[f"lwe_gemm_q{q}"] = {
            "q": q, "rows": rows, "cols": cols, "ms": ans_ms,
            "plain_ms": plain, "plain_ms_check": plain_ms[q],
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        out[f"batch_{q}_parts"] = {
            "keygen_s": kg_s, "encrypt_s": enc_s,
            "client_gemm_ms": client_ms, "client_gemm_bound_ms": c_bound,
            "client_gemm_bound_by": c_by, "answer_ms": ans_ms,
            "decode_s": dec_s,
            "plan": system.servers[0].plan_report()[q]["plan"]}
    out["library_note"] = ("no PyTorch call computes a wrapping int32 "
                           "product on CUDA: torch.matmul has no int32 CUDA "
                           "kernel and torch._int_mm takes int8 operands")

    # the hint: the whole build from the words, and its GEMM alone
    d_t = db32.t().contiguous()
    h_bound, h_by = lwe_gemm_bound(cols, rows, params.n)
    out["hint"] = {
        "build_ms": cuda_time_ms(
            lambda: proto.hint_builder(cfg)(database.view("words")), reps=3),
        "gemm_ms": cuda_time_ms(lambda: kl.lwe_gemm(d_t, a), reps=3),
        "bound_ms": h_bound, "bound_by": h_by}
    del d_t

    # the client's A.S^T past 32 queries (the wide instance at 33, 36 and 40
    # columns) beside 32 columns and beside two 32-wide tiles (the route
    # before the wide instance), in turns
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    s_t = torch.randint(-(1 << 31), (1 << 31) - 1, (params.n, 40),
                        generator=gen, device=device, dtype=torch.int32)
    cols_by_q = {q: s_t[:, :q].contiguous() for q in (32, 33, 36, 40)}
    s_hi = s_t[:, 8:].contiguous()
    fns = {str(q): (lambda x=x: kl.lwe_gemm(a, x))
           for q, x in cols_by_q.items()}
    fns["2x32"] = lambda: (kl.lwe_gemm(a, cols_by_q[32]),
                           kl.lwe_gemm(a, s_hi))
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k in ("32", "33", "36", "40", "2x32", "2x32", "40", "36", "33",
                  "32"):
            runs[k].append(cuda_time_ms(fns[k], reps=3))
    client = {}
    for k, t in runs.items():
        q = 32 if k == "2x32" else int(k)
        bound, by = lwe_gemm_bound(rows, params.n, q)
        if k == "2x32":
            bound *= 2
        client[k] = {"ms": float(np.median(t)), "runs": t,
                     "spread_ms": max(t) - min(t), "bound_ms": bound,
                     "bound_by": by, "share_of_bound": bound / np.median(t),
                     "instance": kl.instance(rows, q)}
    two = client["2x32"]["ms"]
    for q in ("33", "36", "40"):
        client[q]["slower_than_two_tiles"] = client[q]["ms"] > two
    out["client_gemm_wide"] = client
    del s_t, cols_by_q, s_hi, fns
    for q in (1, 32):
        r = out[f"lwe_gemm_q{q}"]
        r["beats_bound"] = r["ms"] < r["bound_ms"]
        if r["beats_bound"]:
            print(f"NOTE: lwe_gemm at Q={q} ran in {r['ms']:.4f} ms, under "
                  f"its bound {r['bound_ms']:.4f} ms", flush=True)

    # end to end through SingleServerPIR.query (host clock, records on host)
    out.update(e2e(system, cfg, rng, ((1, 3), (32, 1))))
    out["hint_fetches"] = system.hint_fetches
    out["peak_device_bytes_run"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Every record width, and verified reconstruction
# ---------------------------------------------------------------------------

#: the kernels whose record width is free: B1-B4
WIDTH_KERNELS = ("dpxor", "fused_scan_xor", "pir_gemm", "fused_scan_add")

#: the private embedding lookup's records (tests/test_system.py): 128 bytes,
#: 2^23 of them (1 GiB, as PIR_1G)
ROWS_128 = 1 << 23

#: widths past 128 bytes of the fused add's split instance, checked on a
#: small DB (ROWS_SPLIT rows): P = 8, P = 16, and P = 32 in two passes of
#: 1024 bytes (1056: one lane live in the second pass; 2048: both full)
SPLIT_WIDTHS = (256, 512, 1056, 2048)
ROWS_SPLIT = 1 << 16

#: the fused XOR's wide instance (records past 128 bytes) on ROWS_SPLIT
#: random rows: 1,028-byte records (257 words, not whole 16-byte words:
#: word loads) and a row slice of 5,120-byte records one word into its
#: buffer (4-byte aligned: word loads), at batches of 1, 4, 32 and 33 (two
#: query groups)
WIDE_ODD_BYTES = 1028
WIDE_SLICE_BYTES = 5120
WIDE_QS = (1, 4, 32, 33)

#: rounds of the interleaved width timing (32, 36, 128, 128, 36, 32 bytes)
WIDTH_ROUNDS = 2
WIDTH_TURNS = (32, 36, 128, 128, 36, 32)


def phase_database_widths(host_db, cfg, device) -> tuple:
    """PIR_1G with the checksum column (the same payload records, each
    stored as 36 bytes: W = 9, the column attached on the host) and 2^23
    records of 128 bytes (W = 32) from their own seed; both placed on the
    card. Returns (checksum Database, 128-byte host words, its Database)."""
    from repro_torch.core import pir
    from repro_torch.db import Database
    t0 = time.perf_counter()
    chk = Database(host_db, replace(cfg, checksum=True), device)
    torch.cuda.synchronize()
    chk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host128 = pir.make_database(np.random.default_rng(SEED + 80), ROWS_128,
                                128)
    w128 = Database(host128, replace(cfg, n_items=ROWS_128, item_bytes=128),
                    device)
    torch.cuda.synchronize()
    emit({"phase": "database_widths",
          "checksum": {"rows": cfg.n_items,
                       "stored_bytes": chk.spec.stored_bytes,
                       "bytes": chk.resident_bytes, "seconds": chk_s},
          "w128": {"rows": ROWS_128, "stored_bytes": w128.spec.stored_bytes,
                   "bytes": w128.resident_bytes,
                   "seconds": time.perf_counter() - t0}})
    return chk, host128, w128


def width_instances() -> dict:
    """ptxas's registers and spills of every template instance the 36- and
    128-byte records select at Q = 1 and Q = 32, of the fused XOR's word
    instance at 128 bytes (a row slice), of every wide instance of the
    fused XOR (records past 128 bytes: each query block, both loads), of
    both loads of the fused add's split instance (all widths past 64
    bytes), and of the int32 GEMM's at the checksum width (answers of 36
    and 40 columns, hints of 36 rows) beside 32."""
    from repro_torch.kernels import build, dpxor as kd, fused_scan as kf
    from repro_torch.kernels import lwe_matmul as kl, pir_matmul as km
    wanted = {
        "dpxor": {kd.instance(w, q) for w in (9, 32) for q in (1, 32)},
        "fused_scan_xor": {kf.instance_xor(w) for w in (9, 32)} | {
            kf.instance_xor(32, 4)} | {
            kf.instance_xor(w, 16, q) for w in (1280, 257)
            for q in kf.XOR_WIDE_QUERY_BLOCKS},
        "pir_gemm": {km.instance(b, q) for b in (36, 128) for q in (1, 32)},
        "fused_scan_add": {kf.instance_add(b) for b in (36, 128)} | {
            build.mangled("fused_scan_add_split_kernel", v)
            for v in (True, False)},
        "lwe_gemm": {kl.instance(m, p) for m, p in (
            (1, 36), (32, 36), (32, 40), (36, 1024), (1, 32), (32, 32),
            (32, 1024))},
    }
    out = {}
    for name, stems in wanted.items():
        report = build.ptxas_report(name)
        for stem in sorted(stems):
            hits = [v for k, v in report.items() if stem in k]
            if len(hits) != 1:
                raise AssertionError(f"{name}: ptxas reports {len(hits)} "
                                     f"entries for instance {stem}")
            out[f"{name}:{stem}"] = hits[0]
    return out


def phase_check_widths(dbs, cfg, card, device) -> dict:
    """B1-B4 past their fixed-width instances, on the served operands:
    36-byte records (``dbs[36]``, PIR_1G's rows with the checksum column)
    and 128-byte records (``dbs[128]``, 2^23 rows), each exact against its
    plain version at Q = 1 and Q = 32 (at Q = 32 every lane of a fused
    kernel's warp is a query), the fused add at 128 bytes for both
    parties, and at SPLIT_WIDTHS (its split instance at P = 8, 16 and 32,
    past 1024 bytes in passes) on 2^16 random rows; dpXOR on a row slice
    only 4-byte aligned, and the fused XOR on one of the 128-byte records
    (its word instance; the whole DB takes the exact one); the fused XOR's
    wide instance at WIDE_ODD_BYTES and on a row slice of WIDE_SLICE_BYTES
    records, ROWS_SPLIT random rows each, at the batches of WIDE_QS;
    the registers and spills of each instance; then every kernel at 32, 36
    and 128 bytes timed in turns (WIDTH_TURNS, WIDTH_ROUNDS times) beside
    its bound at each width. Returns each kernel's largest error."""
    from repro_torch.core import dpf
    from repro_torch.core.protocol import GEMM_TILE_R_DEFAULT, PAYLOAD_ONE
    from repro_torch.core.protocol import plan_for
    from repro_torch.kernels import dpxor as kd, fused_scan as kf, ops
    from repro_torch.kernels import pir_matmul as km
    rng = np.random.default_rng(SEED + 90)
    gen = torch.Generator(device=device).manual_seed(SEED + 91)
    worst = {k: 0 for k in WIDTH_KERNELS}
    t_phase = time.perf_counter()

    def record(kernel, got, want, **shape):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        emit({"phase": "check_widths", "kernel": kernel, **shape,
              "equal": bool(torch.equal(got, want)), "max_abs_err": err})
        if err:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"at {shape}: max_abs_err {err}")

    def timed_plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check_add(b, keys, lg, clog, party, **shape):
        inputs = fused_inputs(keys, 0, lg, clog) + (
            keys.cw_final[:, 0].contiguous(),)
        want, plain_s = timed_plain(lambda: kf.fused_scan_add_plain(
            b, *inputs, party=party, rounds=keys.rounds))
        record("fused_scan_add", kf.fused_scan_add(
            b, *inputs, party=party, rounds=keys.rounds), want,
            rows=b.shape[0], clog=clog, party=party, plain_s=plain_s,
            **shape)

    # the plans' chunk logs at each DB's rows, as the served path takes them
    plan = plan_for(cfg, 32, backend="cuda")

    def clogs(rows):
        lg = (rows - 1).bit_length()
        _, cx = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log, lg))
        _, ca = ops.fused_tile(rows, GEMM_TILE_R_DEFAULT, lg)
        return lg, cx, ca

    for item_bytes, db in dbs.items():
        if item_bytes == 32:
            continue
        rows = db.shape[0]
        lg, clog_x, clog_a = clogs(rows)
        b = db.view(torch.int8)
        for q in (1, 32):
            bits = torch.randint(0, 2, (q, rows), generator=gen,
                                 device=device, dtype=torch.int32)
            record("dpxor", kd.dpxor(db, bits), kd.dpxor_plain(db, bits),
                   q=q, rows=rows, item_bytes=item_bytes)
            shares = torch.randint(-128, 128, (q, rows), generator=gen,
                                   device=device, dtype=torch.int8)
            record("pir_gemm", km.pir_gemm(shares, b),
                   km.pir_gemm_plain(shares, b), q=q, rows=rows,
                   item_bytes=item_bytes)
            del bits, shares
            idx = rng.integers(0, rows, size=q)
            party = (q + item_bytes // 4) % 2
            keys = dpf.gen_keys_batch(rng, idx, lg)[party].to(device)
            inputs = fused_inputs(keys, 0, lg, clog_x)
            want, plain_s = timed_plain(lambda: kf.fused_scan_xor_plain(
                db, *inputs, rounds=keys.rounds))
            record("fused_scan_xor", kf.fused_scan_xor(
                db, *inputs, rounds=keys.rounds), want, q=q, rows=rows,
                item_bytes=item_bytes, clog=clog_x, party=party,
                instance=kf.instance_xor(item_bytes // 4), plain_s=plain_s)
            pair = dpf.gen_keys_batch(rng, idx, lg, payload=PAYLOAD_ONE)
            # the split instance (128 B) with both parties' keys
            for pa in (party, 1 - party) if item_bytes > 64 else (party,):
                check_add(b, pair[pa].to(device), lg, clog_a, pa, q=q,
                          item_bytes=item_bytes)
    # the split instance at P = 8, 16 and 32 (and in passes) on a small DB
    rows = ROWS_SPLIT
    lg, _, clog_a = clogs(rows)
    for item_bytes in SPLIT_WIDTHS:
        b = torch.randint(-(1 << 31), (1 << 31) - 1, (rows, item_bytes // 4),
                          generator=gen, device=device,
                          dtype=torch.int32).view(torch.int8)
        for q in (1, 32):
            pair = dpf.gen_keys_batch(rng, rng.integers(0, rows, size=q), lg,
                                      payload=PAYLOAD_ONE)
            for pa in (0, 1):
                check_add(b, pair[pa].to(device), lg, clog_a, pa, q=q,
                          item_bytes=item_bytes)
        del b
    # a row slice of the 36-byte DB starts 36 bytes in (4-byte aligned
    # only), and its bits are cut from a flat buffer one word in
    db36 = dbs[36]
    rows = db36.shape[0]
    sliced = db36[1:]
    flat = torch.randint(0, 2, (2 * (rows - 1) + 1,), generator=gen,
                         device=device, dtype=torch.int32)
    bits = flat[1:].view(2, rows - 1)
    record("dpxor", kd.dpxor(sliced, bits), kd.dpxor_plain(sliced, bits),
           q=2, rows=rows - 1, item_bytes=36, row_slice=True,
           db_align=sliced.data_ptr() % 16, bits_align=bits.data_ptr() % 16)
    del flat, bits
    # half the 128-byte DB's rows, one word in: 4-byte aligned only, so the
    # fused XOR reads it on its word instance, not the exact one
    rows = dbs[128].shape[0] // 2
    sliced = dbs[128].view(-1)[1:1 + rows * 32].view(rows, 32)
    lg, clog_x, _ = clogs(rows)
    for q in (1, 32):
        keys = dpf.gen_keys_batch(rng, rng.integers(0, rows, size=q),
                                  lg)[q % 2].to(device)
        inputs = fused_inputs(keys, 0, lg, clog_x)
        want, plain_s = timed_plain(lambda: kf.fused_scan_xor_plain(
            sliced, *inputs, rounds=keys.rounds))
        record("fused_scan_xor", kf.fused_scan_xor(
            sliced, *inputs, rounds=keys.rounds), want, q=q, rows=rows,
            item_bytes=128, clog=clog_x, row_slice=True,
            db_align=sliced.data_ptr() % 16,
            instance=kf.instance_xor(32, 4), plain_s=plain_s)
    del sliced
    # the wide instance: records of 257 words (word loads), and 5,120-byte
    # records one word into their buffer (a 4-byte aligned row slice)
    rows = ROWS_SPLIT
    lg, clog_x, _ = clogs(rows)
    for item_bytes, offset in ((WIDE_ODD_BYTES, 0), (WIDE_SLICE_BYTES, 1)):
        w = item_bytes // 4
        flat = torch.randint(-(1 << 31), (1 << 31) - 1, (rows * w + offset,),
                             generator=gen, device=device, dtype=torch.int32)
        wide = flat[offset:].view(rows, w)
        for q in WIDE_QS:
            keys = dpf.gen_keys_batch(rng, rng.integers(0, rows, size=q),
                                      lg)[q % 2].to(device)
            inputs = fused_inputs(keys, 0, lg, clog_x)
            want, plain_s = timed_plain(lambda: kf.fused_scan_xor_plain(
                wide, *inputs, rounds=keys.rounds))
            record("fused_scan_xor", kf.fused_scan_xor(
                wide, *inputs, rounds=keys.rounds), want, q=q, rows=rows,
                item_bytes=item_bytes, clog=clog_x, row_slice=bool(offset),
                db_align=wide.data_ptr() % 16,
                instance=kf.instance_xor(w, wide.data_ptr() % 16 or 16, q),
                plain_s=plain_s)
        del flat, wide
    emit({"phase": "check_widths_ptxas", "instances": width_instances()})

    # times: each width on its served operand, in turns
    runs = {}
    for item_bytes, db in dbs.items():
        rows = db.shape[0]
        lg, clog_x, clog_a = clogs(rows)
        bits = torch.randint(0, 2, (1, rows), generator=gen, device=device,
                             dtype=torch.int32)
        shares = torch.randint(-128, 128, (1, rows), generator=gen,
                               device=device, dtype=torch.int8)
        idx = rng.integers(0, rows, size=32)
        kx = dpf.gen_keys_batch(rng, idx, lg)[0].to(device)
        in_x = fused_inputs(kx, 0, lg, clog_x)
        ka = dpf.gen_keys_batch(rng, idx, lg,
                                payload=PAYLOAD_ONE)[0].to(device)
        in_a = fused_inputs(ka, 0, lg, clog_a) + (
            ka.cw_final[:, 0].contiguous(),)
        b = db.view(torch.int8)
        runs[item_bytes] = {
            "dpxor": (lambda db=db, bits=bits: kd.dpxor(db, bits), 20,
                      (dpxor_bound_ms(rows, item_bytes // 4, 1), "bytes")),
            "pir_gemm": (lambda b=b, s=shares: km.pir_gemm(s, b), 20,
                         (gemm_bound_ms(rows, item_bytes, 1), "bytes")),
            "fused_scan_xor": (
                lambda db=db, i=in_x, r=kx.rounds: kf.fused_scan_xor(
                    db, *i, rounds=r), 3,
                (fused_bound_ms(rows, 32, clog_x, kx.rounds), "operations")),
            "fused_scan_add": (
                lambda b=b, i=in_a, r=ka.rounds: kf.fused_scan_add(
                    b, *i, party=0, rounds=r), 3,
                (fused_add_bound_ms(rows, 32, clog_a, ka.rounds),
                 "operations")),
        }
    times = {k: {w: [] for w in dbs} for k in WIDTH_KERNELS}
    state = card_state()
    for _ in range(WIDTH_ROUNDS):
        for name in WIDTH_KERNELS:
            for w in WIDTH_TURNS:
                fn, reps, _ = runs[w][name]
                times[name][w].append(cuda_time_ms(fn, reps=reps))
    out = {"phase": "check_widths_timing", "card": card, "card_state": state,
           "turns": WIDTH_TURNS, "rounds": WIDTH_ROUNDS, "kernels": {}}
    for name in WIDTH_KERNELS:
        row = {"q": 1 if name in ("dpxor", "pir_gemm") else 32}
        for w in dbs:
            t = times[name][w]
            bound, by = runs[w][name][2]
            ms = float(np.median(t))
            row[str(w)] = {"rows": dbs[w].shape[0], "ms": ms, "runs": t,
                           "spread_ms": max(t) - min(t), "bound_ms": bound,
                           "bound_by": by, "share_of_bound": bound / ms}
        out["kernels"][name] = row
    out["card_state_after"] = card_state()
    out["worst"] = worst
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return worst


def first_dispatch_edited(system, edit):
    """Apply ``edit`` to the raw answers of the scheduler's next dispatch
    only, between its dispatch and its finalize; returns the callable that
    restores the dispatch."""
    sched = system.scheduler
    orig, calls = sched._dispatch, []

    def dispatch(staged):
        raw = orig(staged)
        calls.append(1)
        return edit(raw) if len(calls) == 1 else raw

    sched._dispatch = dispatch
    return lambda: setattr(sched, "_dispatch", orig)


def corrupt_batch(system, idx, edit) -> tuple:
    """Serve ``idx`` (one batch) with ``edit`` applied to its raw answers;
    returns the ``bad_queries`` of the IntegrityError the batch must
    raise."""
    from repro_torch.db import IntegrityError
    restore = first_dispatch_edited(system, edit)
    try:
        system.query(idx)
    except IntegrityError as e:
        return e.bad_queries
    finally:
        restore()
    raise AssertionError("a corrupted batch reconstructed without an "
                         "IntegrityError")


def flip_share(party: int, query: int, word: int, mask: int):
    """An ``edit`` for :func:`corrupt_batch`: XOR ``mask`` into one word of
    one party's answer share for one query (the LWE answer is its one
    share)."""
    def edit(raw):
        answers, rest = raw[0], raw[1:]
        if isinstance(answers, tuple):          # multi-server: per party
            a = answers[party].clone()
            a[query, word] ^= mask
            return (answers[:party] + (a,) + answers[party + 1:],) + rest
        a = answers.clone()
        a[query, word] ^= mask
        return (a,) + rest
    return edit


def phase_serve_chk(host_db, configs, database, device) -> dict:
    """Verified reconstruction at PIR_1G with the checksum column, through
    TwoServerPIR, for xor-dpf-2 and additive-dpf-2 on one database: one
    word of one party's share flipped for one query of a batch of 32 must
    raise IntegrityError naming exactly that query; then batches of 32 and
    1 and a session exact at the logical width on the path's kernels.
    Returns the launches by kernel."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    launches = {}
    for i, (name, cfg, kernels) in enumerate(configs):
        system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                              client_rng=np.random.default_rng(SEED + 100 + i))
        rng = np.random.default_rng(SEED + 110 + i)
        bad, party = int(rng.integers(32)), i % 2
        got = corrupt_batch(system, rng.integers(0, cfg.n_items, size=32),
                            flip_share(party, bad, 3, 0x5A))
        emit({"phase": "serve_chk_corrupt", "config": name, "party": party,
              "flipped_query": bad, "bad_queries": list(got)})
        if got != (bad,):
            raise AssertionError(f"serve_chk {name}: flipped query {bad}, "
                                 f"IntegrityError named {got}")
        for k, n in serve_phase("serve_chk", name, system, host_db,
                                sizes=(32, 1), kernels=kernels,
                                rng=rng).items():
            launches[k] = launches.get(k, 0) + n
    return launches


def phase_serve_w128(host128, configs, database, device) -> dict:
    """128-byte records (the private embedding lookup's, 2^23 of them)
    through TwoServerPIR, xor-dpf-2 and additive-dpf-2 on one database:
    batches of 32 and 1 and a session exact on the path's kernels. Returns
    the launches by kernel."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    launches = {}
    for i, (name, cfg, kernels) in enumerate(configs):
        system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                              client_rng=np.random.default_rng(SEED + 120 + i))
        for k, n in serve_phase("serve_w128", name, system, host128,
                                sizes=(32, 1), kernels=kernels,
                                rng=np.random.default_rng(SEED + 130 + i)
                                ).items():
            launches[k] = launches.get(k, 0) + n
    return launches


def phase_serve_chk_lwe(host_db, cfg, a, card, device) -> tuple:
    """Verified reconstruction of the single-server scheme at PIR_128M_LWE
    with the checksum column (its own Database of the same payload,
    stored at 36 bytes): B5 against its plain version at this database's
    answer shapes (1 and 32 queries x 36 columns) and hint shape ([36, N]
    x A), and at LWE_TILES; B5 at 36 and at 32 columns timed in turns; one answer word of a
    batch with its top byte flipped (a shift by a multiple of Delta) and
    one answer shifted by Delta, each of which the noise check passes and
    the checksum must name; then batches of 32 and 1 and a session exact
    at the logical width on B5. Returns B5's largest error and the
    launches."""
    from repro_torch.core import lwe
    from repro_torch.db import Database
    from repro_torch.kernels import lwe_matmul as kl
    from repro_torch.runtime.serve_loop import SingleServerPIR
    database = Database(host_db, cfg, device)
    worst, _ = phase_check_lwe(database, a, device, answer_qs=(1, 32),
                               client_qs=(), tiles=LWE_TILES)
    db36 = database.view("bytes32")
    rows = db36.shape[0]
    db32 = db36[:, :32].contiguous()
    gen = torch.Generator(device=device).manual_seed(SEED + 152)
    ct = torch.randint(-(1 << 31), (1 << 31) - 1, (32, rows), generator=gen,
                       device=device, dtype=torch.int32)
    d36, d32 = db36.t().contiguous(), db32.t().contiguous()
    shapes = {"answer_q32": {36: (ct, db36), 32: (ct, db32)},
              "hint": {36: (d36, a), 32: (d32, a)}}
    times = {c: {p: [] for p in (36, 32)} for c in shapes}
    for _ in range(2):
        for case, by_p in shapes.items():
            for p in (32, 36, 36, 32):
                x, y = by_p[p]
                times[case][p].append(cuda_time_ms(
                    lambda: kl.lwe_gemm(x, y),
                    reps=20 if case == "answer_q32" else 3))
    out = {"phase": "serve_chk_lwe_timing", "card": card, "kernels": {}}
    for case, by_p in shapes.items():
        row = {}
        for p, (x, y) in by_p.items():
            t = times[case][p]
            bound, by = lwe_gemm_bound(x.shape[0], x.shape[1], y.shape[1])
            ms = float(np.median(t))
            row[str(p)] = {"m": x.shape[0], "k": x.shape[1], "p": y.shape[1],
                           "instance": kl.instance(x.shape[0], y.shape[1]),
                           "ms": ms, "runs": t, "spread_ms": max(t) - min(t),
                           "bound_ms": bound, "bound_by": by,
                           "share_of_bound": bound / ms}
        out["kernels"][case] = row
    emit(out)
    del ct, d36, d32, db32, shapes

    system = SingleServerPIR(database, cfg, device=device, n_queries=32,
                             client_rng=np.random.default_rng(SEED + 150))
    rng = np.random.default_rng(SEED + 151)
    delta = lwe.params_for(cfg.n_items).delta
    bad = int(rng.integers(4))
    got = corrupt_batch(system, rng.integers(0, cfg.n_items, size=4),
                        flip_share(0, bad, 5, 0x5A << 24))
    emit({"phase": "serve_chk_corrupt", "config": "pir-128m-lwe+chk",
          "flipped_query": bad, "mask": 0x5A << 24,
          "bad_queries": list(got)})
    if got != (bad,):
        raise AssertionError(f"serve_chk LWE: flipped query {bad}, "
                             f"IntegrityError named {got}")

    bad = int(rng.integers(4))

    def shift(raw):                # the checksum word's first byte + Delta
        ans = raw[0].clone()
        ans[bad, cfg.item_bytes] += delta
        return (ans,) + raw[1:]

    got = corrupt_batch(system, rng.integers(0, cfg.n_items, size=4), shift)
    emit({"phase": "serve_chk_corrupt", "config": "pir-128m-lwe+chk",
          "shifted_by_delta": bad, "bad_queries": list(got)})
    if got != (bad,):
        raise AssertionError(f"serve_chk LWE: shifted query {bad}, "
                             f"IntegrityError named {got}")
    # one publish of 64 rows: the hint delta at L = 36 (B5's 40-row tile),
    # then the updated records served at the logical width
    from repro_torch.crypto.packing import np_words_to_bytes
    from repro_torch.kernels import ops
    info, rows = lwe_publish(system, database, cfg, rng, 64, host_db, device,
                             phase="serve_chk_lwe")
    ops.reset_counts()
    idx = np.concatenate([rows[:4], rng.integers(0, cfg.n_items, size=4)])
    exact = check_records(system.query(idx), np_words_to_bytes(host_db[idx]))
    served = main_path_launches("serve_chk_lwe", ("lwe_gemm",))["lwe_gemm"]
    emit({"phase": "serve_chk_lwe_updated", "n": len(idx), "exact": exact})
    if not exact:
        raise AssertionError("serve_chk LWE: an updated record differs")
    launches = serve_phase("serve_chk", "pir-128m-lwe+chk", system, host_db,
                           sizes=(32, 1), kernels=("lwe_gemm",), rng=rng)
    launches["lwe_gemm"] += info["delta_launches"] + served
    del system, database
    return max(worst["lwe_gemm"], info["max_abs_err"]), launches


# ---------------------------------------------------------------------------
# Online updates, and the batch plane
# ---------------------------------------------------------------------------

#: rows published per step of the updates phase at PIR_1G
UPDATE_ROWS = (1, 64, 4096)
#: rows published per step of updates_lwe (K = 4, 4, 64, 4096 on B5)
LWE_UPDATE_ROWS = (1, 3, 64, 4096)
#: publishes made while a session serves (the dispatch-wait measurement)
WAIT_PUBLISHES = 20


def fresh_rows(rng, n_items: int, n_rows: int, words: int, low: int = 0):
    """``n_rows`` distinct row indices in ``[low, n_items)`` and fresh random
    u32 words for them."""
    rows = low + rng.choice(n_items - low, size=n_rows, replace=False)
    return rows, rng.integers(0, 1 << 32, size=(n_rows, words),
                              dtype=np.uint32)


def served_with_tags(system, idx) -> tuple:
    """Serve ``idx`` as one call through the scheduler (keys for the call
    made in one batch, as ``query()`` makes them): the records and each
    future's epoch tag."""
    with system._lock:
        items = system._query_items([int(i) for i in idx])
    futs = [system.scheduler.submit(it) for it in items]
    if not system.scheduler.running:
        system.scheduler.pump()
    recs = np.stack([f.result(timeout=600) for f in futs])
    return recs, [f.epoch for f in futs]


def main_path_launches(phase: str, kernels) -> dict:
    """The counters' launches since their reset; fails where a plain
    version ran or one of ``kernels`` never launched."""
    from repro_torch.kernels import ops
    counts = ops.counts()
    launches = {k: v["launches"] for k, v in counts.items()}
    plain = {k: v["plain_calls"] for k, v in counts.items()}
    if any(plain.values()) or any(launches[k] < 1 for k in kernels):
        raise AssertionError(f"{phase}: main path did not run on the "
                             f"kernels {kernels}: launches {launches}, "
                             f"plain calls {plain}")
    return launches


def dispatch_wait(system, database, host_db, rng, cfg) -> dict:
    """How long ``snapshot()`` takes on the scheduler thread while a session
    serves batches of 8 continuously and a second thread publishes
    WAIT_PUBLISHES times (64 rows each, in the upper half of the rows; the
    served queries read the lower half, so their records stay known).
    Each publish is started as a dispatch is about to read its snapshot
    (the dispatch signals, then waits up to 0.1 s for the publish to
    start, untimed), so that every publish overlaps one timed snapshot."""
    n, words = cfg.n_items, cfg.item_bytes // 4
    served = rng.choice(n // 2, size=1024, replace=False)
    times = []                               # (start, seconds) per snapshot
    orig = database.snapshot
    # publishes still to make; 0 while serving before and after them
    ready, started, left = threading.Event(), threading.Event(), [0]

    def timed(*args, **kwargs):
        if left[0]:
            ready.set()
            started.wait(timeout=0.1)
            started.clear()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        times.append((t0, time.perf_counter() - t0))
        return out

    spans, deltas, errors = [], [], []      # spans: (start, end) per publish

    def publisher():
        try:
            prng = np.random.default_rng(SEED + 210)
            while left[0]:
                rows, vals = fresh_rows(prng, n, 64, words, low=n // 2)
                if not ready.wait(timeout=60):
                    raise TimeoutError("no dispatch within 60 s")
                ready.clear()
                t0 = time.perf_counter()
                started.set()
                system.update(rows, vals)
                system.publish()
                spans.append((t0, time.perf_counter()))
                deltas.append((rows, vals))
                left[0] -= 1
        except BaseException as e:        # re-raised on the main thread
            left[0] = 0
            errors.append(e)

    served_ok = []

    def serve_one():
        idx = rng.choice(served, size=8)
        recs, _ = served_with_tags(system, idx)
        served_ok.append(check_records(recs, host_db[idx]))

    database.snapshot = timed                # the dispatch reads it per batch
    try:
        with system:
            for _ in range(4):               # before the first publish
                serve_one()
            left[0] = WAIT_PUBLISHES
            pub = threading.Thread(target=publisher)
            pub.start()
            while pub.is_alive():
                serve_one()
            pub.join()
            for _ in range(4):               # after the last publish
                serve_one()
    finally:
        del database.snapshot
    if errors:
        raise errors[0]
    for rows, vals in deltas:
        host_db[rows] = vals
    across = [dt for t0, dt in times
              if any(a <= t0 + dt and t0 <= b for a, b in spans)]
    apart = [dt for t0, dt in times
             if not any(a <= t0 + dt and t0 <= b for a, b in spans)]
    return {"publishes": len(deltas), "batches": len(served_ok),
            "publish_s": [b - a for a, b in spans],
            "snapshots_across_a_publish": len(across),
            "wait_across_max_s": max(across) if across else None,
            "wait_across_median_s": (float(np.median(across)) if across
                                     else None),
            "snapshots_apart": len(apart),
            "wait_apart_max_s": max(apart) if apart else None,
            "wait_apart_median_s": (float(np.median(apart)) if apart
                                    else None),
            "exact": all(served_ok)}


def phase_updates(host_db, cfg, cfg_add, database, card, device) -> dict:
    """Online updates on the resident PIR_1G database (the phase is
    ``host_db``'s last reader, so the published rows are written into it).
    For R = 1, 64 and 4096 fresh rows: stage and publish (host clock,
    synchronized), then XOR batches of 32 and 1 and additive batches of 32
    and 1, each exact with every tag the published epoch; a snapshot taken
    before the publish serves the old rows with the old tag. Then batches
    of 32 right after a publish and without one, in turns, and the
    dispatch wait across publishes. Returns the launches."""
    from repro_torch.crypto.packing import records_to_host
    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_loop import TwoServerPIR
    rng = np.random.default_rng(SEED + 200)
    xor = TwoServerPIR(database, cfg, device=device, n_queries=32,
                       client_rng=np.random.default_rng(SEED + 201))
    add = TwoServerPIR(database, cfg_add, device=device, n_queries=32,
                       client_rng=np.random.default_rng(SEED + 202))
    words, stats = cfg.item_bytes // 4, database.stats
    out = {"phase": "updates", "card": card, "config": "pir-1g",
           "publishes": []}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    for r in UPDATE_ROWS:
        rows, vals = fresh_rows(rng, cfg.n_items, r, words)
        probe = rows[:min(r, 8)]
        old_rows = host_db[probe].copy()
        old_epoch, old_views = database.snapshot(("words",))
        h2d0, clone0 = stats.update_h2d_bytes, stats.clone_device_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xor.update(rows, vals)
        epoch = xor.publish()
        torch.cuda.synchronize()
        pub_s = time.perf_counter() - t0
        host_db[rows] = vals
        row = {"rows": r, "epoch": epoch, "publish_s": pub_s,
               "h2d_bytes": stats.update_h2d_bytes - h2d0,
               "clone_device_bytes": stats.clone_device_bytes - clone0,
               "batches": []}
        for system, n in ((xor, 32), (xor, 1), (add, 32), (add, 1)):
            k = min(r, max(n // 2, 1))
            idx = np.concatenate([rows[:k], rng.integers(0, cfg.n_items,
                                                         size=n - k)])
            t0 = time.perf_counter()
            recs, tags = served_with_tags(system, idx)
            row["batches"].append({
                "protocol": system.cfg.protocol, "n": n, "updated": k,
                "seconds": time.perf_counter() - t0, "tags": sorted(set(tags)),
                "exact": check_records(
                    recs, expected_records(system, host_db, idx))})
        # the snapshot read before the publish: old rows, old tag
        keys = xor.protocol.query_gen_batch(xor.rng, probe, cfg)
        old = records_to_host(xor.protocol.reconstruct(
            [s.bucketed.answer(old_views["words"], k.to(device))
             for s, k in zip(xor.servers, keys)]))
        row["old_snapshot"] = {"epoch": old_epoch,
                               "exact": check_records(old, old_rows)}
        del old_views
        out["publishes"].append(row)
        emit({"phase": "updates_publish", "card": card, **row})
        if not (all(b["exact"] and b["tags"] == [epoch]
                    for b in row["batches"])
                and row["old_snapshot"]["exact"] and old_epoch == epoch - 1):
            raise AssertionError(f"updates: R={r}: a record or tag is wrong "
                                 f"after publishing epoch {epoch}")

    # a batch of 32 right after a publish of 64 rows, and one without a
    # publish, in turns
    lat = {"after_publish": [], "no_publish": []}
    for _ in range(3):
        for kind in lat:
            if kind == "after_publish":
                rows, vals = fresh_rows(rng, cfg.n_items, 64, words)
                xor.update(rows, vals)
                xor.publish()
                host_db[rows] = vals
            idx = rng.integers(0, cfg.n_items, size=32)
            dt, recs = host_time_s(lambda: xor.query(idx), sync=False)
            if not check_records(recs, host_db[idx]):
                raise AssertionError("updates: a batch after a publish "
                                     "differs from the database")
            lat[kind].append(dt)
    out["batch_32_latency_s"] = {
        k: {"runs": v, "median_s": float(np.median(v))}
        for k, v in lat.items()}
    out["dispatch_wait"] = dispatch_wait(xor, database, host_db, rng, cfg)
    if not out["dispatch_wait"]["exact"]:
        raise AssertionError("updates: a record served across the "
                             "publishes differs from the database")
    out["launches"] = main_path_launches(
        "updates", ("dpxor", "fused_scan_xor", "pir_gemm", "fused_scan_add"))
    out["stats"] = vars(stats).copy()
    out["db_resident_bytes"] = database.resident_bytes
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out["launches"]


def lwe_publish(system, database, cfg, rng, r, host, device,
                phase: str = "updates_lwe") -> tuple:
    """One publish of ``r`` fresh rows into an LWE deployment's database
    (``host`` takes the rows too): its time and the hint delta's B5
    launches, counted from zero; then, uncounted, the delta-updated hint
    against a full rebuild (``torch.equal``) and B5 at the delta's shape
    against its plain version, timed beside its bound."""
    from repro_torch.core import lwe
    from repro_torch.kernels import lwe_matmul as kl, ops
    proto = system.protocol
    rows, vals = fresh_rows(rng, cfg.n_items, r, cfg.item_bytes // 4)
    idx = torch.as_tensor(rows, device=device)
    old_words = database.view("words")[idx]
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.update(rows, vals)
    epoch = system.publish()
    hint = database.hint(proto.name)
    torch.cuda.synchronize()
    pub_s = time.perf_counter() - t0
    launches = main_path_launches(phase, ("lwe_gemm",))
    host[rows] = vals
    full = proto.hint_builder(cfg)(database.view("words"))
    d_t, a_rows = lwe.hint_delta_operands(
        lwe.params_for(cfg.n_items), cfg.n_items, rows, old_words,
        database.view("words")[idx])
    got, want = kl.lwe_gemm(d_t, a_rows), kl.lwe_gemm_plain(d_t, a_rows)
    bound, by = lwe_gemm_bound(*d_t.shape, a_rows.shape[1])
    out = {"rows": r, "epoch": epoch, "publish_s": pub_s,
           "hint_equals_rebuild": bool(torch.equal(hint, full)),
           "m": d_t.shape[0], "k": d_t.shape[1], "p": a_rows.shape[1],
           "instance": kl.instance(d_t.shape[0], a_rows.shape[1]),
           "max_abs_err": max_abs_err(got, want),
           "ms": cuda_time_ms(lambda: kl.lwe_gemm(d_t, a_rows), reps=20),
           "plain_ms": cuda_time_ms(lambda: kl.lwe_gemm_plain(d_t, a_rows),
                                    reps=1, warmup=0),
           "bound_ms": bound, "bound_by": by,
           "delta_launches": launches["lwe_gemm"],
           "hint_deltas": database.stats.n_hint_deltas,
           "hint_builds": database.stats.n_hint_builds}
    emit({"phase": f"{phase}_publish", **out})
    if not out["hint_equals_rebuild"] or out["max_abs_err"]:
        raise AssertionError(f"{phase}: R={r}: the delta-updated hint "
                             f"or B5 at the delta shape differs")
    return out, rows


def phase_updates_lwe(host_lwe, database, cfg, card, device) -> tuple:
    """Online updates of the single-server scheme at PIR_128M_LWE with A
    resident: for R = 1, 3, 64 and 4096 a publish whose hint delta must
    equal a full rebuild, with B5 at each delta shape exact and timed;
    then SingleServerPIR serves the updated records exactly, and a batch
    answered from a snapshot taken before a publish decodes with the
    retired epoch's hint. Returns B5's largest error and its launches."""
    from repro_torch.crypto.packing import np_words_to_bytes
    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_loop import SingleServerPIR
    rng = np.random.default_rng(SEED + 220)
    system = SingleServerPIR(database, cfg, device=device, n_queries=32,
                             client_rng=np.random.default_rng(SEED + 221))
    proto = system.protocol
    database.hint(proto.name)
    out = {"phase": "updates_lwe", "card": card, "config": "pir-128m-lwe",
           "publishes": []}
    updated = []
    for r in LWE_UPDATE_ROWS:
        info, rows = lwe_publish(system, database, cfg, rng, r, host_lwe,
                                 device)
        out["publishes"].append(info)
        updated.append(rows[:8])
    launches = sum(p["delta_launches"] for p in out["publishes"])
    if database.stats.n_hint_builds != 1:
        raise AssertionError("updates_lwe: a publish rebuilt the hint")

    # the updated records, served; then a batch from a snapshot read before
    # a publish, decoded with the retired epoch's hint
    ops.reset_counts()
    fetches0 = system.hint_fetches
    idx = np.concatenate(updated + [rng.integers(0, cfg.n_items, size=8)])
    t0 = time.perf_counter()
    recs = system.query(idx)
    served = {"n": len(idx), "seconds": time.perf_counter() - t0,
              "exact": check_records(recs, np_words_to_bytes(host_lwe[idx])),
              "hint_fetches": system.hint_fetches - fetches0}
    probe, new_vals = fresh_rows(rng, cfg.n_items, 8, cfg.item_bytes // 4)
    old_vals = host_lwe[probe].copy()
    old_epoch, old_views = database.snapshot(("bytes32",))
    (ct,), states = proto.query_gen_batch_full(system.rng, probe, cfg,
                                               device=device)
    system.update(probe, new_vals)
    epoch = system.publish()
    host_lwe[probe] = new_vals
    server = system.servers[0].bucketed
    rec_old = proto.reconstruct_with(
        [server.answer(old_views["bytes32"], ct)], states, cfg=cfg,
        hint=system._client_hint(old_epoch))
    rec_new = proto.reconstruct_with(
        [server.answer(database.view("bytes32"), ct)], states, cfg=cfg,
        hint=system._client_hint(epoch))
    served["retired_epoch"] = {
        "epoch": old_epoch, "exact": check_records(
            rec_old, np_words_to_bytes(old_vals))}
    served["current_epoch"] = {
        "epoch": epoch, "exact": check_records(
            rec_new, np_words_to_bytes(new_vals))}
    launches += main_path_launches("updates_lwe", ("lwe_gemm",))["lwe_gemm"]
    del old_views
    out["served"] = served
    out["launches"] = launches
    out["stats"] = vars(database.stats).copy()
    emit(out)
    if not (served["exact"] and served["retired_epoch"]["exact"]
            and served["current_epoch"]["exact"]
            and old_epoch == epoch - 1):
        raise AssertionError("updates_lwe: a served record differs after a "
                             "publish")
    return max(p["max_abs_err"] for p in out["publishes"]), launches


def submit_placed(system, idx):
    """``submit_batch(idx)``; a placement that fails (probability O(1/B))
    is planned again with the generator moved on."""
    from repro_torch.core.batch import CuckooFailure
    for attempt in range(3):
        try:
            return system.submit_batch(idx)
        except CuckooFailure:
            if attempt == 2:
                raise


def batch_round(system, idx) -> tuple:
    """One round of ``idx`` through ``submit_batch``: the records, the
    future's epoch tag, the dispatches it took and the seconds of the
    client's plan (cuckoo walk and B keygens)."""
    log0 = len(system.dispatch_log)
    t0 = time.perf_counter()
    fut = submit_placed(system, idx)
    plan_s = time.perf_counter() - t0
    system.scheduler.pump()
    return (fut.result(timeout=600), fut.epoch, system.dispatch_log[log0:],
            plan_s)


def batch_lanes(bdb, cfg, host, rng, device) -> dict:
    """A second facade over the same buckets with two logical lanes
    (``n_clusters=2``): two rounds of m distinct indices submitted before
    either is waited on, then one pump. The records must be exact, each
    lane (``cluster0``, ``cluster1``) must carry a batch, counted where the
    scheduler records a batch's latency, and every dispatch must be B
    wide."""
    from collections import Counter
    from repro_torch.runtime.batch import BatchPIR
    system = BatchPIR(bdb, cfg, device=device, n_clusters=2,
                      client_rng=np.random.default_rng(SEED + 303))
    lanes = Counter()
    record = system.scheduler.monitor.record

    def counting(lane, latency):
        lanes[lane] += 1
        record(lane, latency)

    system.scheduler.monitor.record = counting
    t0 = time.perf_counter()
    idx = [rng.choice(cfg.n_items, size=cfg.batch_m, replace=False)
           for _ in range(2)]
    futs = [submit_placed(system, i) for i in idx]
    plan_s = time.perf_counter() - t0
    system.scheduler.pump()
    recs = [f.result(timeout=600) for f in futs]
    out = {"n_clusters": 2, "rounds": len(idx),
           "seconds": time.perf_counter() - t0, "plan_s": plan_s,
           "lanes": dict(lanes), "dispatch_log": system.dispatch_log,
           "epochs": [f.epoch for f in futs],
           "exact": all(check_records(r, host[i])
                        for r, i in zip(recs, idx))}
    if not (out["exact"] and set(lanes) == {"cluster0", "cluster1"}
            and all(n >= 1 for n in lanes.values())
            and all(w == bdb.n_buckets for _, w in system.dispatch_log)):
        raise AssertionError(f"batch: the two-lane rounds are wrong: {out}")
    return out


def phase_batch(cfg, card, device) -> tuple:
    """The batch plane at PIR_1G_BATCH (2^25 records x 32 B, xor-dpf-2,
    m = 256, B = 512 buckets), with no other database on the card: the
    layout and the BucketedDatabase built and timed, two rounds (one of
    256 distinct random indices, one with duplicates) exact and 512 wide,
    two rounds of 256 distinct indices on two lanes (``batch_lanes``),
    then 64 global rows staged and published into every candidate bucket
    and a round serving them with the new outer epoch. Returns the
    launches and the layout, which the sharded phase serves from too."""
    import resource
    from repro_torch.core import pir
    from repro_torch.core.batch import CuckooLayout, CuckooParams
    from repro_torch.crypto.packing import tensor_to_words
    from repro_torch.db import BucketedDatabase
    from repro_torch.kernels import ops
    from repro_torch.runtime.batch import BatchPIR
    out = {"phase": "batch", "card": card, "config": "pir-1g-batch"}
    t0 = time.perf_counter()
    host = pir.make_database(np.random.default_rng(SEED + 300), cfg.n_items,
                             cfg.item_bytes)
    out["host_db_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = CuckooLayout.build(cfg.n_items, CuckooParams.from_config(cfg))
    out["layout_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bdb = BucketedDatabase(host, cfg, device, layout=layout)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    loads = layout.loads
    out.update({"n_buckets": bdb.n_buckets, "capacity": bdb.capacity,
                "load_min": int(loads.min()), "load_max": int(loads.max()),
                "load_mean": float(loads.mean()),
                "expansion": bdb.expansion,
                "resident_bytes": bdb.resident_bytes,
                "host_peak_rss_bytes": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024})
    system = BatchPIR(bdb, cfg, device=device,
                      client_rng=np.random.default_rng(SEED + 301))
    out["plan"] = system.serve[0].plan_for_bucket(1).name
    rng = np.random.default_rng(SEED + 302)
    m = cfg.batch_m
    rounds = []
    ops.reset_counts()

    def serve_round(kind, idx, want_epoch):
        b1 = ops.counts()["dpxor"]["launches"]
        t0 = time.perf_counter()
        recs, epoch, log, plan_s = batch_round(system, idx)
        dt = time.perf_counter() - t0
        rounds.append({
            "kind": kind, "n": len(idx), "unique": len(set(idx.tolist())),
            "seconds": dt, "plan_s": plan_s, "records_per_s": len(idx) / dt,
            "dispatch_log": log, "epoch": epoch,
            "dpxor_launches": ops.counts()["dpxor"]["launches"] - b1,
            "exact": check_records(recs, host[idx])})
        if not (rounds[-1]["exact"] and epoch == want_epoch
                and log and all(w == bdb.n_buckets for _, w in log)):
            raise AssertionError(f"batch: round {rounds[-1]} is wrong")

    serve_round("distinct", rng.choice(cfg.n_items, size=m, replace=False),
                0)
    dup = rng.choice(cfg.n_items, size=m // 2, replace=False)
    serve_round("duplicates", rng.choice(dup, size=m), 0)
    out["lanes"] = batch_lanes(bdb, cfg, host, rng, device)

    rows, vals = fresh_rows(rng, cfg.n_items, 64, cfg.item_bytes // 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.update(rows, vals)
    epoch = system.publish()
    torch.cuda.synchronize()
    out["publish"] = {"rows": 64, "epoch": epoch,
                      "seconds": time.perf_counter() - t0,
                      "buckets_published": bdb.stats.n_publishes,
                      "h2d_bytes": bdb.stats.update_h2d_bytes,
                      "clone_device_bytes": bdb.stats.clone_device_bytes}
    host[rows] = vals
    landed = all(
        np.array_equal(tensor_to_words(bdb.buckets[b].view("words")[slot]), v)
        for r, v in zip(rows, vals) for b, slot in layout.occurrences(int(r)))
    out["publish"]["landed_in_every_candidate"] = landed
    if not landed or epoch != 1:
        raise AssertionError("batch: a published row is missing from one "
                             "of its candidate buckets")
    serve_round("after_publish", np.concatenate(
        [rows[:m], rng.choice(cfg.n_items, size=max(m - len(rows), 0),
                              replace=False)]), 1)
    out["rounds"] = rounds
    out["launches"] = main_path_launches("batch", ("dpxor",))
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out["launches"], layout


def phase_twins(device) -> dict:
    """The db_updates and batch_query twins on the card at their smoke
    configs (batch_query's has checksums on). Returns the launches."""
    from repro_torch import batch_query, db_updates
    from repro_torch.kernels import ops
    ops.reset_counts()
    t0 = time.perf_counter()
    upd = db_updates.run(device=str(device), verbose=False)
    t1 = time.perf_counter()
    bq = batch_query.run(device=str(device), verbose=False)
    launches = main_path_launches("twins", ("dpxor",))
    emit({"phase": "twins", "db_updates": upd, "db_updates_s": t1 - t0,
          "batch_query": bq, "batch_query_s": time.perf_counter() - t1,
          "launches": launches})
    return launches


#: the serve_runtime phase: PIRServeLoop's batches (8 of 32, one of 5, one
#: of 1), the lanes' sessions (n_clusters in turns) and their load
RUNTIME_LOOP_BATCHES = (32,) * 8 + (5, 1)
RUNTIME_LANE_TURNS = (2, 1, 2, 1)
RUNTIME_CLIENTS = 4
RUNTIME_QUERIES = 256
#: the twins run as subprocesses, started together: module and arguments
RUNTIME_TWINS = {"multi_server": (), "single_server": (),
                 "serving_session": (), "replicas": (),
                 "chaos": ("--smoke",), "private_inference": ()}
#: the verification-cost turns: sessions on the plain and the checksum
#: database, alternating, and the cost the reference allows
#: (benchmarks/bench_chaos.py)
RUNTIME_VERIFY_TURNS = ("plain", "chk", "chk", "plain") * 2
VERIFY_BUDGET = 0.15


def wait_stopped(scheduler, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while scheduler.running and time.monotonic() < deadline:
        time.sleep(0.005)
    return not scheduler.running


def drain_stats(stats, seconds: float) -> dict:
    return {"answered": stats.answered, "batches": stats.batches,
            "wall_s": stats.wall_s, "qps": stats.qps,
            "median_latency_s": float(np.median(stats.latencies)),
            "seconds": seconds}


def runtime_serve_loop(host_db, cfg, database, rng) -> dict:
    """PIRServeLoop, one per party, n_clusters=2, over the shared database:
    RUNTIME_LOOP_BATCHES of keys from pir.batch_queries, drained serially
    and pipelined in turns (serial, pipelined, pipelined, serial); every
    drain gives the first one's shares, and the parties' shares XOR to the
    host rows."""
    from repro_torch.core import pir
    from repro_torch.core.server import PIRServer
    from repro_torch.crypto.packing import tensor_to_words
    from repro_torch.runtime.serve_loop import PIRServeLoop
    idx = [rng.integers(0, cfg.n_items, size=n) for n in RUNTIME_LOOP_BATCHES]
    t0 = time.perf_counter()
    keys = [pir.batch_queries(rng, i, cfg) for i in idx]
    out = {"batches": list(RUNTIME_LOOP_BATCHES),
           "keygen_s": time.perf_counter() - t0}
    shares, equal = [], True
    for party in (0, 1):
        server = PIRServer(party, database=database, cfg=cfg, n_queries=32)
        drains, first = [], None
        for kind in ("drain", "drain_pipelined", "drain_pipelined", "drain"):
            loop = PIRServeLoop(server, n_clusters=2)
            for k in keys:
                loop.submit(k[party])
            t0 = time.perf_counter()
            answers = getattr(loop, kind)()
            drains.append(dict(kind=kind, **drain_stats(
                loop.stats, time.perf_counter() - t0)))
            first = answers if first is None else first
            equal &= all(torch.equal(a, b) for a, b in zip(answers, first))
            equal &= [a.shape[0] for a in answers] == [len(i) for i in idx]
        shares.append(first)
        out[f"party{party}"] = drains
    out["equal"] = bool(equal)
    out["exact"] = all(check_records(tensor_to_words(a ^ b), host_db[i])
                       for a, b, i in zip(shares[0], shares[1], idx))
    return out


def session_load(system, idx, want) -> tuple:
    """``idx`` from RUNTIME_CLIENTS client threads through ``system``'s
    session, each client making its keys in one batch (as query() does),
    so that the session measures serving rather than keygen: the seconds
    from the start to the last record, whether every record equals
    ``want``, and the first errors."""
    recs, errors = [None] * len(idx), []

    def client(c):
        mine = list(range(c, len(idx), RUNTIME_CLIENTS))
        try:
            with system._lock:
                items = system._query_items([int(idx[i]) for i in mine])
            futs = [system.scheduler.submit(
                it, future=system._deadline_future(None)) for it in items]
            for i, f in zip(mine, futs):
                recs[i] = f.result(timeout=600)
        except Exception as e:       # noqa: BLE001 - reported, then fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    with system:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(RUNTIME_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    seconds = time.perf_counter() - t0
    exact = (not errors and not any(t.is_alive() for t in threads)
             and all(r is not None for r in recs)
             and check_records(np.stack(recs), want))
    return seconds, exact, errors[:3]


def runtime_lanes(host_db, cfg, database, device, rng) -> list:
    """RUNTIME_QUERIES queries from RUNTIME_CLIENTS client threads through a
    TwoServerPIR session, for each n_clusters of RUNTIME_LANE_TURNS in
    turns: every record exact, queue_depth 0 at the end. The lanes share
    the card, so the turns are expected within the host clock's spread."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    turns = []
    for turn, n_clusters in enumerate(RUNTIME_LANE_TURNS):
        system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                              n_clusters=n_clusters,
                              client_rng=np.random.default_rng(SEED + 210
                                                               + turn))
        idx = rng.integers(0, cfg.n_items, size=RUNTIME_QUERIES)
        seconds, exact, errors = session_load(system, idx, host_db[idx])
        stats = system.scheduler.stats
        turns.append({"n_clusters": n_clusters, "seconds": seconds,
                      "answered": stats.answered, "batches": stats.batches,
                      "qps": stats.qps, "wall_s": stats.wall_s,
                      "pad_fraction": stats.pad_fraction,
                      "bucket_counts": {str(b): n for b, n in
                                        sorted(stats.bucket_counts.items())},
                      "reassignments": stats.reassignments,
                      "queue_depth": system.scheduler.queue_depth,
                      "exact": exact, "errors": errors})
        if not exact or turns[-1]["queue_depth"]:
            raise AssertionError(f"serve_runtime lanes: {turns[-1]}")
    return turns


def runtime_verify_cost(host_db, cfg, database, host_chk, cfg_chk,
                        database_chk, device, rng) -> dict:
    """What verified reconstruction costs a session: RUNTIME_QUERIES queries
    from RUNTIME_CLIENTS client threads through TwoServerPIR on the plain
    database and on the checksum one (the same records, 36 bytes stored),
    in RUNTIME_VERIFY_TURNS, every record exact against its own
    database's rows (``updates`` rewrote some of the plain database's and
    ``host_db``'s, not the checksum database's). The cost is read from
    the scheduler's per-batch dispatch-to-finalize latencies (ServeStats),
    which hold neither keygen nor the session's start-up: 1 - plain/chk of
    the pooled medians, and its spread over every pair of a plain turn's
    median and a chk turn's. Against the reference's budget
    (VERIFY_BUDGET) it is "within" or "over" only if the whole spread is,
    else "unresolved"; it is reported, not held. Each session window's
    records/s (keygen and start-up included) is reported beside it."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    turns, lat = [], {"plain": [], "chk": []}
    for turn, which in enumerate(RUNTIME_VERIFY_TURNS):
        c, db, host = ((cfg_chk, database_chk, host_chk) if which == "chk"
                       else (cfg, database, host_db))
        system = TwoServerPIR(db, c, device=device, n_queries=32,
                              client_rng=np.random.default_rng(SEED + 240
                                                               + turn))
        idx = rng.integers(0, cfg.n_items, size=RUNTIME_QUERIES)
        seconds, exact, errors = session_load(system, idx, host[idx])
        stats = system.scheduler.stats
        lat[which] += stats.latencies
        turns.append({"database": which, "seconds": seconds,
                      "records_per_s": RUNTIME_QUERIES / seconds,
                      "batch_ms_median":
                          1e3 * float(np.median(stats.latencies)),
                      "batches": stats.batches,
                      "bucket_counts": {str(b): n for b, n in
                                        sorted(stats.bucket_counts.items())},
                      "pad_fraction": stats.pad_fraction, "exact": exact,
                      "errors": errors})
        if not exact:
            raise AssertionError(f"serve_runtime verify cost: {turns[-1]}")
    med = {w: 1e3 * float(np.median(v)) for w, v in lat.items()}
    per_turn = {w: [t["batch_ms_median"] for t in turns
                    if t["database"] == w] for w in lat}
    pairs = [1.0 - p / c for p in per_turn["plain"] for c in per_turn["chk"]]
    spread = [min(pairs), max(pairs)]
    verdict = ("within" if spread[1] < VERIFY_BUDGET else
               "over" if spread[0] > VERIFY_BUDGET else "unresolved")
    window = {w: [t["records_per_s"] for t in turns if t["database"] == w]
              for w in lat}
    return {"queries": RUNTIME_QUERIES, "clients": RUNTIME_CLIENTS,
            "turns": turns, "batch_ms_median": med,
            "cost": 1.0 - med["plain"] / med["chk"], "cost_spread": spread,
            "budget": VERIFY_BUDGET, "verdict": verdict,
            "window_records_per_s": window,
            "window_cost": 1.0 - float(np.mean(window["chk"])
                                       / np.mean(window["plain"]))}


def runtime_shedding(host_db, cfg, database, device, rng) -> dict:
    """A StragglerMonitor seeded so that cluster1 is flagged (alpha=1.0;
    factor 1.5, since of two lanes the median is their mean), then a pump
    of four batches of 32 cut onto both lanes: the first completion sheds
    cluster1's queued batches, every batch runs on cluster0, every record
    exact."""
    from repro_torch.runtime.fault import StragglerMonitor
    from repro_torch.runtime.serve_loop import TwoServerPIR
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          n_clusters=2,
                          client_rng=np.random.default_rng(SEED + 220))
    monitor = StragglerMonitor(factor=1.5, alpha=1.0)
    monitor.record("cluster0", 0.001)
    monitor.record("cluster1", 10.0)
    ran, record = [], monitor.record

    def logged(lane, dt):
        ran.append(lane)
        record(lane, dt)

    monitor.record = logged
    system.scheduler.monitor = monitor
    idx = rng.integers(0, cfg.n_items, size=4 * 32)
    futs = [system.scheduler.submit(it)
            for it in system._query_items([int(i) for i in idx])]
    queued = {lane: len(q) for lane, q in system.scheduler.queues.items()}
    t0 = time.perf_counter()
    system.scheduler.pump()
    out = {"queued": queued, "ran_on": ran,
           "reassignments": system.scheduler.stats.reassignments,
           "stragglers": monitor.stragglers(),
           "seconds": time.perf_counter() - t0,
           "exact": check_records(np.stack([f.result(timeout=600)
                                            for f in futs]), host_db[idx])}
    if (queued != {"cluster0": 2, "cluster1": 2} or not out["exact"]
            or out["reassignments"] < 1 or ran != ["cluster0"] * 4):
        raise AssertionError(f"serve_runtime shedding: {out}")
    return out


def runtime_kill(host_db, cfg, database, device, rng) -> dict:
    """64 queries submitted by a client to a running session (n_clusters
    2), then kill() once the first batch completes: every future resolves
    within a timeout, exactly or with the kill's exception; submit then
    raises and queue_depth is 0."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          n_clusters=2,
                          client_rng=np.random.default_rng(SEED + 230))
    idx = rng.integers(0, cfg.n_items, size=64)
    resolved_at = [None] * len(idx)
    first = threading.Event()
    system.start()
    futs = []
    for i, index in enumerate(idx):
        f = system.submit(int(index))
        f.add_done_callback(
            lambda f, i=i: resolved_at.__setitem__(i, time.perf_counter()))
        futs.append(f)
    futs[0].add_done_callback(lambda f: first.set())
    if not first.wait(timeout=600):
        raise AssertionError("serve_runtime kill: no batch completed")
    killed = RuntimeError("serve_runtime: killed under load")
    t_kill = time.perf_counter()
    system.scheduler.kill(killed)
    exact = failed = 0
    for i, f in zip(idx, futs):
        try:
            rec = f.result(timeout=60)
        except RuntimeError as e:
            if e is not killed:
                raise
            failed += 1
            continue
        if not check_records(rec, host_db[i]):
            raise AssertionError(f"serve_runtime kill: D[{i}] wrong")
        exact += 1
    stopped = wait_stopped(system.scheduler)
    try:
        system.submit(0)
        rejected = False
    except RuntimeError:
        rejected = True
    after = [t - t_kill for t in resolved_at if t is not None and t >= t_kill]
    out = {"queries": len(idx), "exact": exact, "failed_with_kill": failed,
           "resolved_after_kill": len(after),
           "max_resolve_after_kill_s": max(after) if after else 0.0,
           "stopped": stopped, "submit_rejected": rejected,
           "queue_depth": system.scheduler.queue_depth}
    if (exact + failed != len(idx) or not stopped or not rejected
            or out["queue_depth"]):
        raise AssertionError(f"serve_runtime kill: {out}")
    return out


def runtime_handoff(host_db, cfg, database, device, rng) -> dict:
    """128 queries (four batches of 32) on a running session; once the
    first batch completes, drain_handoff returns the undispatched pairs,
    which a second TwoServerPIR over the same Database serves under their
    own futures: every future exact, none lost."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    src = TwoServerPIR(database, cfg, device=device, n_queries=32,
                       n_clusters=2,
                       client_rng=np.random.default_rng(SEED + 240))
    dst = TwoServerPIR(database, cfg, device=device, n_queries=32,
                       client_rng=np.random.default_rng(SEED + 241))
    idx = rng.integers(0, cfg.n_items, size=4 * 32)
    items = src._query_items([int(i) for i in idx])
    first = threading.Event()
    src.start()
    futs = [src.scheduler.submit(it, future=src._deadline_future(None))
            for it in items]
    futs[0].add_done_callback(lambda f: first.set())
    if not first.wait(timeout=600):
        raise AssertionError("serve_runtime handoff: no batch completed")
    pairs = src.scheduler.drain_handoff()
    for item, fut in pairs:
        if dst.scheduler.submit(item, future=fut) is not fut:
            raise AssertionError("a handed-off query got a new future")
    dst.scheduler.pump()
    recs = np.stack([f.result(timeout=600) for f in futs])
    out = {"queries": len(idx), "handed_off": len(pairs),
           "answered_here": src.scheduler.stats.answered,
           "answered_there": dst.scheduler.stats.answered,
           "stopped": wait_stopped(src.scheduler),
           "exact": check_records(recs, host_db[idx])}
    if (not out["exact"] or not out["stopped"] or not pairs
            or out["answered_here"] + out["answered_there"] != len(idx)):
        raise AssertionError(f"serve_runtime handoff: {out}")
    return out


def runtime_integrity(host_chk, cfg, database, device, rng) -> dict:
    """checksum=True at PIR_1G: one word of one party's share of the first
    batch flipped. Session mode: the batch's futures carry bad_queries
    naming the flipped query, every outstanding future fails with the same
    exception, submit raises until start() reopens the session, and a
    fresh batch is exact. pump mode: pump raises, the batch launched behind
    the corrupted one fails with the same exception, the one not launched
    stays queued and the next pump serves it exactly."""
    from repro_torch.db import IntegrityError
    from repro_torch.runtime.serve_loop import TwoServerPIR

    def deployment(seed):
        return TwoServerPIR(database, cfg, device=device, n_queries=32,
                            n_clusters=2,
                            client_rng=np.random.default_rng(seed))

    system = deployment(SEED + 250)
    bad = int(rng.integers(32))
    idx = rng.integers(0, cfg.n_items, size=32 + 8)
    items = system._query_items([int(i) for i in idx])
    restore = first_dispatch_edited(system, flip_share(1, bad, 3, 0x5A))
    try:
        futs = [system.scheduler.submit(it,
                                        future=system._deadline_future(None))
                for it in items]
        system.start()
        errors = []
        for f in futs:
            try:
                f.result(timeout=600)
                errors.append(None)
            except IntegrityError as e:
                errors.append(e)
        stopped = wait_stopped(system.scheduler)
        try:
            system.submit(0)
            rejected = False
        except RuntimeError:
            rejected = True
    finally:
        restore()
    system.start()
    fresh_idx = rng.integers(0, cfg.n_items, size=8)
    try:
        fresh = check_records(system.query(fresh_idx), host_chk[fresh_idx])
    finally:
        system.close()
    session = {"flipped_query": bad, "futures": len(futs),
               "failed": sum(e is not None for e in errors),
               "one_exception": all(e is errors[0] for e in errors),
               "bad_queries": list(errors[0].bad_queries) if errors[0]
               else None, "stopped": stopped, "submit_rejected": rejected,
               "fresh_exact": fresh,
               "queue_depth": system.scheduler.queue_depth}
    if (session["failed"] != len(futs) or not session["one_exception"]
            or session["bad_queries"] != [bad] or not stopped
            or not rejected or not fresh or session["queue_depth"]):
        raise AssertionError(f"serve_runtime integrity (session): {session}")

    system = deployment(SEED + 251)
    bad = int(rng.integers(32))
    idx = rng.integers(0, cfg.n_items, size=32 + 32 + 8)
    items = system._query_items([int(i) for i in idx])
    restore = first_dispatch_edited(system, flip_share(0, bad, 5, 0x01))
    try:
        futs = [system.scheduler.submit(it,
                                        future=system._deadline_future(None))
                for it in items]
        try:
            system.scheduler.pump()
            raised = None
        except IntegrityError as e:
            raised = e
    finally:
        restore()
    launched, queued = futs[:64], futs[64:]
    pump = {"flipped_query": bad,
            "bad_queries": list(raised.bad_queries) if raised else None,
            "launched_resolved": sum(f.done() for f in launched),
            "launched_failed_with_it": sum(f.exception() is raised
                                           for f in launched),
            "queued_pending": sum(not f.done() for f in queued),
            "queue_depth": system.scheduler.queue_depth}
    system.scheduler.pump()
    pump["queued_exact"] = check_records(
        np.stack([f.result(timeout=600) for f in queued]), host_chk[idx[64:]])
    if (pump["bad_queries"] != [bad] or pump["launched_resolved"] != 64
            or pump["launched_failed_with_it"] != 64
            or pump["queued_pending"] != 8 or pump["queue_depth"] != 8
            or not pump["queued_exact"]):
        raise AssertionError(f"serve_runtime integrity (pump): {pump}")
    return {"session": session, "pump": pump}


def runtime_twins() -> dict:
    """The multi_server, single_server, serving_session, replicas and
    private_inference twins and the chaos smoke (``python -m
    repro_torch.chaos --smoke``) as subprocesses on the card, started
    together; each must exit with 0 and report, on its last line, its
    kernels' launches and plain calls."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.{name}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(src)) for name, args in RUNTIME_TWINS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"twin {name} exited {proc.returncode}:"
                                     f"\n{stdout[-2000:]}\n{stderr[-4000:]}")
            summary = json.loads(stdout.strip().splitlines()[-1])
            out[name] = {"seconds": time.perf_counter() - t0,
                         "launches": summary["launches"],
                         "plain_calls": summary["plain_calls"]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_serve_runtime(host_db, cfg, database, host_chk, cfg_chk,
                        database_chk, card, device) -> dict:
    """The serving runtime at PIR_1G on the resident databases: the
    PIRServeLoop per party, lanes under load (n_clusters 2 and 1 in turns),
    sessions on the plain and the checksum database in turns (the cost of
    verification), shedding off a flagged lane, kill and drain_handoff
    under load, a corrupted share with checksum=True in session and pump
    mode, and the six twins (three serving, the replica plane, the chaos
    smoke, the private-embedding LM) as subprocesses. The counters are
    zeroed before it and read after: B1 and B2 launched here, B5 in the
    single_server, replicas and chaos twins, B1 in the private_inference
    twin, no plain call anywhere. Returns the launches by kernel."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 200)
    t_phase = time.perf_counter()
    ops.reset_counts()
    loop = runtime_serve_loop(host_db, cfg, database, rng)
    emit({"phase": "serve_runtime_loop", "config": "pir-1g", "card": card,
          **loop})
    if not loop["equal"] or not loop["exact"]:
        raise AssertionError("serve_runtime: PIRServeLoop's drains differ "
                             "or its shares do not XOR to the rows")
    lanes = runtime_lanes(host_db, cfg, database, device, rng)
    emit({"phase": "serve_runtime_lanes", "config": "pir-1g", "card": card,
          "clients": RUNTIME_CLIENTS, "queries": RUNTIME_QUERIES,
          "turns": lanes})
    verify = runtime_verify_cost(host_db, cfg, database, host_chk, cfg_chk,
                                 database_chk, device, rng)
    emit({"phase": "serve_runtime_verify_cost", "config": "pir-1g",
          "card": card, **verify})
    shedding = runtime_shedding(host_db, cfg, database, device, rng)
    emit({"phase": "serve_runtime_shedding", **shedding})
    kill = runtime_kill(host_db, cfg, database, device, rng)
    emit({"phase": "serve_runtime_kill", "card": card, **kill})
    handoff = runtime_handoff(host_db, cfg, database, device, rng)
    emit({"phase": "serve_runtime_handoff", **handoff})
    integrity = runtime_integrity(host_chk, cfg_chk, database_chk, device,
                                  rng)
    emit({"phase": "serve_runtime_integrity", "config": "pir-1g+chk",
          **integrity})
    launches = main_path_launches("serve_runtime",
                                  ("dpxor", "fused_scan_xor"))
    twins = runtime_twins()
    for name, twin in twins.items():
        if any(twin["plain_calls"].values()):
            raise AssertionError(f"twin {name} ran plain versions: {twin}")
        for k, n in twin["launches"].items():
            launches[k] += n
    for name in ("single_server", "replicas", "chaos"):
        if twins[name]["launches"]["lwe_gemm"] < 1:
            raise AssertionError(f"the {name} twin did not launch B5")
    # the private-embedding twin's 2^10-row table takes materialize + B1
    # at every bucket (at most 2^chunk_log rows)
    if twins["private_inference"]["launches"]["dpxor"] < 1:
        raise AssertionError("the private_inference twin did not launch B1")
    emit({"phase": "serve_runtime", "card": card, "twins": twins,
          "verify_cost": verify["cost"],
          "verify_cost_spread": verify["cost_spread"],
          "verify_verdict": verify["verdict"], "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


#: the replicas phase: two PIR_1G replicas on carve_submeshes(2) ((1, 1)
#: meshes, both on cuda:0 on one card), buckets 1 and 32; a replica cuts an under-full
#: batch after REPL_MAX_WAIT_S, so that the query submitted last before a
#: kill or a leave is still queued when it comes
REPL_BUCKETS = (1, 32)
REPL_MAX_WAIT_S = 0.05
REPL_UPDATE_ROWS = 64
REPL_CLIENTS = 4
#: queries per load turn, from REPL_CLIENTS client threads: through the
#: fleet's router (P2C) or through the same router with every client's
#: session pinned to r1 (one replica), in turns, and per turn of keys made
#: before the window (256 until the hybrid's phases needed the time: the
#: load turns took 43 s on the H100's host)
REPL_QUERIES = 128
REPL_LOAD_TURNS = ("fleet", "one", "one", "fleet")
#: single-query keygens timed one after another and over REPL_CLIENTS
#: threads, the host work the router's load puts on its client threads
REPL_KEYGEN_KEYS = 32
REPL_KILL_QUERIES = 64
REPL_CORRUPT_QUERIES = 8
REPL_LEAVE_QUERIES = 128
#: a session thread beats once per turn of its loop and not while it waits
#: idle (as in the reference), and r0 idles while r1 alone serves a turn:
#: the registry's silence timeout outlasts the phase, so that only an
#: observed failure (a kill, an IntegrityError) quarantines a replica here
REPL_HEARTBEAT_TIMEOUT_S = 900.0


def repl_replica(rid, host, cfg, mesh, seed, buckets=REPL_BUCKETS, **kw):
    from repro_torch.replica import ServeReplica
    return ServeReplica(rid, host, cfg, mesh, n_queries=buckets[-1],
                        buckets=buckets, max_wait_s=REPL_MAX_WAIT_S,
                        client_rng=np.random.default_rng(seed), **kw)


def repl_router(seed, chaos=None):
    from repro_torch.replica import ReplicaRegistry, Router
    return Router(registry=ReplicaRegistry(timeout=REPL_HEARTBEAT_TIMEOUT_S),
                  rng=np.random.default_rng(seed), base_delay=0.01,
                  max_delay=0.5, chaos=chaos)


def fired_log(injector) -> list:
    return [(f.seam, f.target, f.action, f.visit) for f in injector.fired]


def release() -> None:
    """Give the memory of the databases no one holds any more back to the
    card (called once a replica has left and its holders are gone)."""
    gc.collect()
    torch.cuda.empty_cache()


class Oracle:
    """The fleet's records: the host words with the published rows
    applied (a dict of the updated rows, not a second 1 GiB copy)."""

    def __init__(self, host_db):
        self.host_db, self.rows = host_db, {}

    def update(self, rows, vals):
        self.rows.update((int(r), v) for r, v in zip(rows, vals))

    def __call__(self, idx) -> np.ndarray:
        want = self.host_db[np.asarray(idx)].copy()
        for j, i in enumerate(idx):
            if int(i) in self.rows:
                want[j] = self.rows[int(i)]
        return want


def routed(router, idx, *, sessions=None, clients: int = 1) -> tuple:
    """Submit ``idx`` through ``router`` from ``clients`` threads (client
    c takes indices c, c + clients, ...; ``sessions[c]`` pins it) and wait
    for every future: the futures, in ``idx`` order, and the seconds from
    the first submit to the last answer."""
    futs, errors = [None] * len(idx), []

    def client(c):
        session = sessions[c] if sessions else None
        try:
            mine = range(c, len(idx), clients)
            for i in mine:
                futs[i] = router.submit(int(idx[i]), session=session)
            for i in mine:
                futs[i].result(timeout=600)
        except Exception as e:       # noqa: BLE001 - re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"replicas: a client failed: {errors[:3]}")
    return futs, seconds


def check_routed(step: str, futs, want, epoch: int) -> dict:
    """Every future exact and tagged ``epoch``; returns the split of the
    answers by the replica that gave them."""
    recs = np.stack([f.result(timeout=600) for f in futs])
    tags = {f.epoch for f in futs}
    if not check_records(recs, want) or tags != {epoch}:
        raise AssertionError(f"replicas {step}: records exact "
                             f"{check_records(recs, want)}, epochs {tags}")
    split = {}
    for f in futs:
        split[f.context["rid"]] = split.get(f.context["rid"], 0) + 1
    return dict(sorted(split.items()))


def replicas_join(router, host_db, cfg, meshes, rng, oracle, card) -> dict:
    """Build and attach r0 and r1, each with its own 1 GiB Database; the
    seconds of each build and attach, and to the first exact answer."""
    t_start = time.perf_counter()
    out = {"phase": "replicas_join", "config": "pir-1g", "card": card,
           "devices": [str(m.device) for m in meshes], "replicas": {}}
    for i, mesh in enumerate(meshes):
        t0 = time.perf_counter()
        rep = repl_replica(f"r{i}", host_db, cfg, mesh, SEED + 310 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        router.attach(rep)
        out["replicas"][rep.id] = {
            "build_s": t1 - t0, "attach_s": time.perf_counter() - t1,
            "db_resident_bytes": rep.db.resident_bytes,
            "plans": {b: r["label"] for b, r in rep.plan_report().items()}}
    idx = [int(rng.integers(cfg.n_items))]
    t0 = time.perf_counter()
    futs, _ = routed(router, idx)
    check_routed("join", futs, oracle(idx), 0)
    now = time.perf_counter()
    out.update(first_query_s=now - t0, first_answer_s=now - t_start)
    emit(out)
    return out


def serve_counts(router) -> dict:
    return {rid: (r.stats.answered, r.stats.padded, r.stats.batches)
            for rid, r in router.replicas.items()}


def serve_delta(router, before) -> dict:
    """Each replica's answered queries, batches and pad fraction since
    ``before`` (``serve_counts``)."""
    out = {}
    for rid, (answered, padded, batches) in serve_counts(router).items():
        a, p, b = (x - y for x, y in zip((answered, padded, batches),
                                          before[rid]))
        if b:
            out[rid] = {"answered": a, "batches": b,
                        "pad_fraction": p / (a + p)}
    return out


def one_sessions(router, tag: str) -> list:
    """REPL_CLIENTS sessions of ``router`` pinned to r1: the load of a
    one-replica fleet, on the same router and the same replica."""
    sessions = [router.session(f"{tag}{c}") for c in range(REPL_CLIENTS)]
    for s in sessions:
        s.replica = "r1"
    return sessions


def replicas_load(router, oracle, rng, cfg, card) -> dict:
    """REPL_QUERIES queries from REPL_CLIENTS threads through the fleet's
    router and through r1 alone, in turns: records/s from the first submit
    to the last answer (each query keyed on its client thread, as a client
    of the fleet pays), the split between replicas, each replica's batches
    and pad fraction, the fleet's metrics snapshot."""
    from repro_torch.replica import metrics
    turns = []
    for turn, which in enumerate(REPL_LOAD_TURNS):
        idx = rng.integers(0, cfg.n_items, size=REPL_QUERIES)
        idx[:8] = list(oracle.rows)[:8]             # published rows
        sessions = one_sessions(router, f"one{turn}.") if which == "one" \
            else None
        before = serve_counts(router)
        futs, seconds = routed(router, idx, sessions=sessions,
                               clients=REPL_CLIENTS)
        split = check_routed(f"load turn {turn}", futs, oracle(idx), 1)
        turns.append({"router": which, "seconds": seconds,
                      "records_per_s": REPL_QUERIES / seconds,
                      "split": split,
                      "served": serve_delta(router, before)})
    rate = {w: [t["records_per_s"] for t in turns if t["router"] == w]
            for w in ("fleet", "one")}
    out = {"phase": "replicas_load", "card": card, "clients": REPL_CLIENTS,
           "queries": REPL_QUERIES, "turns": turns,
           "fleet_over_one": float(np.mean(rate["fleet"])
                                   / np.mean(rate["one"])),
           "snapshot": metrics.snapshot(router)}
    emit(out)
    return out


def replicas_prekeyed(router, oracle, rng, cfg, card) -> dict:
    """The load turns' serving alone: REPL_QUERIES keys made before the
    window, then submitted straight to the replicas (``resubmit``, the
    hand-off path) round-robin over r0 and r1, or all to r1, in turns;
    records/s from the first submit to the last answer, every record
    exact at epoch 1."""
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.runtime.serve_loop import AnswerFuture
    proto = protocol_mod.for_config(cfg)
    turns = []
    for turn, which in enumerate(REPL_LOAD_TURNS):
        idx = rng.integers(0, cfg.n_items, size=REPL_QUERIES)
        t0 = time.perf_counter()
        keys = [proto.query_gen(rng, int(i), cfg) for i in idx]
        keygen_s = time.perf_counter() - t0
        targets = ([router.replicas["r0"], router.replicas["r1"]]
                   if which == "fleet" else [router.replicas["r1"]])
        before = serve_counts(router)
        t0 = time.perf_counter()
        futs = [targets[i % len(targets)].resubmit(k, AnswerFuture())
                for i, k in enumerate(keys)]
        recs = np.stack([f.result(timeout=600) for f in futs])
        seconds = time.perf_counter() - t0
        tags = {f.epoch for f in futs}
        if not check_records(recs, oracle(idx)) or tags != {1}:
            raise AssertionError(f"replicas prekeyed turn {turn}: records "
                                 f"exact {check_records(recs, oracle(idx))}"
                                 f", epochs {tags}")
        turns.append({"replicas": which, "keygen_s": keygen_s,
                      "seconds": seconds,
                      "records_per_s": REPL_QUERIES / seconds,
                      "served": serve_delta(router, before)})
    rate = {w: [t["records_per_s"] for t in turns if t["replicas"] == w]
            for w in ("fleet", "one")}
    out = {"phase": "replicas_prekeyed", "card": card,
           "queries": REPL_QUERIES, "turns": turns,
           "fleet_over_one": float(np.mean(rate["fleet"])
                                   / np.mean(rate["one"]))}
    emit(out)
    return out


def replicas_keygen(cfg, card) -> dict:
    """REPL_KEYGEN_KEYS single-query DPF keygens (``query_gen``, as
    ``Router.submit`` makes them through a replica) one after another,
    then the same number split over REPL_CLIENTS threads."""
    from repro_torch.core import protocol as protocol_mod
    proto = protocol_mod.for_config(cfg)

    def keygens(n, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n):
            proto.query_gen(rng, int(rng.integers(cfg.n_items)), cfg)

    t0 = time.perf_counter()
    keygens(REPL_KEYGEN_KEYS, SEED + 350)
    serial_s = time.perf_counter() - t0
    per = REPL_KEYGEN_KEYS // REPL_CLIENTS
    threads = [threading.Thread(target=keygens, args=(per, SEED + 351 + c))
               for c in range(REPL_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    threaded_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("replicas keygen: a thread did not finish")
    out = {"phase": "replicas_keygen", "card": card,
           "keys": REPL_KEYGEN_KEYS, "serial_s": serial_s,
           "threads": REPL_CLIENTS, "threaded_s": threaded_s,
           "threaded_over_serial": threaded_s / serial_s}
    emit(out)
    return out


def replicas_kill(router, oracle, rng, cfg, card) -> dict:
    """REPL_KILL_QUERIES queries of a session pinned to r0, then r0.kill():
    every future exact at epoch 1 (the failed ones answered by r1), r0 a
    suspect, failovers >= 1; the seconds from the kill to the last
    future."""
    r0 = router.replicas["r0"]
    s = router.session("victim")
    s.replica = "r0"
    idx = rng.integers(0, cfg.n_items, size=REPL_KILL_QUERIES)
    resolved = []
    failovers0 = router.failovers
    futs = []
    for i in idx:
        f = router.submit(int(i), session=s)
        f.add_done_callback(lambda f: resolved.append(time.perf_counter()))
        futs.append(f)
    t_kill = time.perf_counter()
    r0.kill("chip_smoke: killed under load")
    kill_call_s = time.perf_counter() - t_kill
    split = check_routed("kill", futs, oracle(idx), 1)
    suspects = router.registry.suspects()
    out = {"phase": "replicas_kill", "card": card,
           "queries": REPL_KILL_QUERIES, "split": split,
           "failovers": router.failovers - failovers0,
           "kill_call_s": kill_call_s,
           "kill_to_last_future_s": max(resolved) - t_kill,
           "suspects": suspects, "lost": 0}
    emit(out)
    if "r0" not in suspects or out["failovers"] < 1:
        raise AssertionError(f"replicas kill: {out}")
    return out


def replicas_corrupt(host_chk, cfg_chk, meshes, rng, card) -> dict:
    """Two replicas on the checksum database (PIR_1G, checksum=True), and
    one ChaosInjector held by c0 and the router: a corrupt at c0's
    replica.serve_step seam, visit 0. c0 serves buckets of one, so that
    its first batch is one real query and the flip, drawn over the whole
    share, cannot land in a padding row. Every query of a session pinned
    to c0 comes back exact from c1, integrity_failures >= 1, c0 the one
    suspect, and the injector's log the one corrupt."""
    from repro_torch.chaos import ChaosInjector, FaultEvent, FaultPlan
    injector = ChaosInjector(FaultPlan(seed=SEED + 333, events=(
        FaultEvent("replica.serve_step", "corrupt", target="c0", at=0),)))
    router = repl_router(SEED + 330, chaos=injector)
    c0 = router.attach(repl_replica("c0", host_chk, cfg_chk, meshes[0],
                                    SEED + 331, buckets=(1,),
                                    chaos=injector))
    router.attach(repl_replica("c1", host_chk, cfg_chk, meshes[1],
                               SEED + 332))
    s = router.session("pinned")
    s.replica = "c0"
    idx = rng.integers(0, cfg_chk.n_items, size=REPL_CORRUPT_QUERIES)
    t0 = time.perf_counter()
    futs, _ = routed(router, idx, sessions=[s])
    split = check_routed("corrupt", futs, host_chk[idx], 0)
    out = {"phase": "replicas_corrupt", "config": "pir-1g+chk", "card": card,
           "queries": REPL_CORRUPT_QUERIES, "split": split,
           "c0_buckets": list(c0.pir.servers[0].buckets),
           "fired": fired_log(injector),
           "integrity_failures": router.integrity_failures,
           "failovers": router.failovers,
           "suspects": router.registry.suspects(),
           "seconds": time.perf_counter() - t0, "lost": 0}
    emit(out)
    if (out["fired"] != [("replica.serve_step", "c0", "corrupt", 0)]
            or out["integrity_failures"] < 1 or out["suspects"] != ["c0"]
            or split != {"c1": REPL_CORRUPT_QUERIES}
            or out["c0_buckets"] != [1]):
        raise AssertionError(f"replicas corrupt: {out}")
    router.detach("c0")
    router.detach("c1")
    return out


def replicas_chaos_kill(host_db, cfg, meshes, rng, card) -> dict:
    """Two fresh PIR_1G replicas, k0 and k1 (each its own 1 GiB Database),
    behind a router that holds one ChaosInjector, which k0 holds too: a
    kill at k0's scheduler.dispatch seam, visit 0. REPL_KILL_QUERIES
    queries of a session pinned to k0: every future exact from k1 at epoch
    0, failovers >= 1, the injector's log the one kill, k0's dead session
    rejecting new work; the seconds from the first submit to the last
    future. Then both leave and their databases are freed."""
    from repro_torch.chaos import ChaosInjector, FaultEvent, FaultPlan
    injector = ChaosInjector(FaultPlan(seed=SEED + 363, events=(
        FaultEvent("scheduler.dispatch", "kill", target="k0", at=0),)))
    router = repl_router(SEED + 360, chaos=injector)
    t0 = time.perf_counter()
    k0 = router.attach(repl_replica("k0", host_db, cfg, meshes[0],
                                    SEED + 361, chaos=injector))
    router.attach(repl_replica("k1", host_db, cfg, meshes[1], SEED + 362))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s = router.session("chaos-victim")
    s.replica = "k0"
    idx = rng.integers(0, cfg.n_items, size=REPL_KILL_QUERIES)
    try:
        futs, seconds = routed(router, idx, sessions=[s])
        split = check_routed("chaos kill", futs, host_db[idx], 0)
        try:
            k0.submit(0)
            rejected = False
        except RuntimeError:
            rejected = True
        out = {"phase": "replicas_chaos_kill", "config": "pir-1g",
               "card": card, "queries": REPL_KILL_QUERIES, "split": split,
               "fired": fired_log(injector), "failovers": router.failovers,
               "suspects": router.registry.suspects(),
               "k0_rejects_new_work": rejected, "build_s": build_s,
               "first_submit_to_last_future_s": seconds, "lost": 0}
        emit(out)
        if (out["fired"] != [("scheduler.dispatch", "k0", "kill", 0)]
                or out["failovers"] < 1 or not rejected
                or split != {"k1": REPL_KILL_QUERIES}):
            raise AssertionError(f"replicas chaos kill: {out}")
    finally:
        for rid in list(router.replicas):
            router.detach(rid)
        del k0, router
        release()
    return out


def replicas_rejoin(router, host_db, cfg, meshes, oracle, rng, card) -> dict:
    """detach("r0") (the killed replica; its database freed), then a fresh
    r0 built with r1's exported plans and attached: epoch 1 by the delta
    log's replay, no heuristic plan, the first query exact."""
    t0 = time.perf_counter()
    moved = router.detach("r0")
    release()
    peer = router.replicas["r1"]
    r0b = repl_replica("r0", host_db, cfg, meshes[0], SEED + 340,
                       warm_plans=peer.export_plans())
    router.attach(r0b)
    torch.cuda.synchronize()
    rejoin_s = time.perf_counter() - t0
    provenance = {b: r["provenance"] for b, r in r0b.plan_report().items()}
    s = router.session("rejoined")
    s.replica = "r0"
    idx = [int(rng.integers(cfg.n_items))]
    t1 = time.perf_counter()
    futs, _ = routed(router, idx, sessions=[s])
    split = check_routed("rejoin", futs, oracle(idx), 1)
    out = {"phase": "replicas_rejoin", "card": card, "handed_off": moved,
           "rejoin_s": rejoin_s, "first_query_s": time.perf_counter() - t1,
           "epoch": r0b.epoch, "provenance": provenance, "split": split}
    emit(out)
    if (r0b.epoch != 1 or split != {"r0": 1}
            or not set(provenance.values()) <= {"warm", "tuned"}):
        raise AssertionError(f"replicas rejoin: {out}")
    return out


def replicas_leave(router, oracle, rng, cfg, card) -> dict:
    """REPL_LEAVE_QUERIES queries from REPL_CLIENTS sessions pinned to r1,
    then detach("r1") as soon as the last one is submitted: the queries
    r1 had not dispatched are handed off (futures and all), every future
    exact at epoch 1."""
    leaver = router.replicas["r1"]
    answered0 = leaver.stats.answered
    sessions = [router.session(f"leave{c}") for c in range(REPL_CLIENTS)]
    for s in sessions:
        s.replica = "r1"
    idx = rng.integers(0, cfg.n_items, size=REPL_LEAVE_QUERIES)
    futs = [None] * len(idx)

    def client(c):
        for i in range(c, len(idx), REPL_CLIENTS):
            futs[i] = router.submit(int(idx[i]), session=sessions[c])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(REPL_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads) or any(f is None for f in futs):
        raise AssertionError("replicas leave: a client did not submit")
    t_detach = time.perf_counter()
    moved = router.detach("r1")
    detach_s = time.perf_counter() - t_detach
    split = check_routed("leave", futs, oracle(idx), 1)
    out = {"phase": "replicas_leave", "card": card,
           "queries": REPL_LEAVE_QUERIES, "submit_s": t_detach - t0,
           "handed_off": moved, "detach_s": detach_s,
           "answered_by_leaver": leaver.stats.answered - answered0,
           "routed_to": split, "resubmitted": router.resubmitted,
           "seconds": time.perf_counter() - t0, "lost": 0}
    emit(out)
    return out


def phase_replicas(host_db, cfg, host_chk, cfg_chk, card) -> dict:
    """The replica plane at PIR_1G: two ServeReplicas (each its own 1 GiB
    Database) behind a Router on carve_submeshes(2, model_axis=1) — join,
    a 64-row publish fanned out, load through the fleet and through r1
    alone in turns (keyed on the client threads, then keyed before the
    window), the host's single-query keygen alone and over threads, a kill
    under load, a corrupt through the replica.serve_step chaos seam on the
    checksum database, a kill through a fresh replica's scheduler.dispatch
    seam, a warm rejoin, a graceful leave under load.
    The counters are zeroed before it and read after: B1 and B2 launched,
    no plain call. The warm plan-cache entries it records stay in memory
    (the cache file is off) and are dropped after it. Returns the
    launches."""
    from repro_torch import engine
    from repro_torch.kernels import ops
    from repro_torch.runtime.elastic import carve_submeshes
    rng = np.random.default_rng(SEED + 300)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine.plan_cache(reload=True)
    ops.reset_counts()
    meshes = carve_submeshes(2, model_axis=1)
    oracle = Oracle(host_db)
    router = repl_router(SEED + 301)
    try:
        join = replicas_join(router, host_db, cfg, meshes, rng, oracle, card)

        rows, vals = fresh_rows(rng, cfg.n_items, REPL_UPDATE_ROWS,
                                cfg.item_bytes // 4)
        router.update(rows, vals)
        t0 = time.perf_counter()
        epoch = router.publish()
        torch.cuda.synchronize()
        publish_s = time.perf_counter() - t0
        oracle.update(rows, vals)
        epochs = {rid: r.epoch for rid, r in router.replicas.items()}
        emit({"phase": "replicas_publish", "card": card,
              "rows": REPL_UPDATE_ROWS, "epoch": epoch, "epochs": epochs,
              "publish_s": publish_s})
        if epoch != 1 or set(epochs.values()) != {1}:
            raise AssertionError(f"replicas publish: epochs {epochs}")

        load = replicas_load(router, oracle, rng, cfg, card)
        prekeyed = replicas_prekeyed(router, oracle, rng, cfg, card)
        keygen = replicas_keygen(cfg, card)

        kill = replicas_kill(router, oracle, rng, cfg, card)
        corrupt = replicas_corrupt(host_chk, cfg_chk, meshes, rng, card)
        release()
        chaos_kill = replicas_chaos_kill(host_db, cfg, meshes, rng, card)
        rejoin = replicas_rejoin(router, host_db, cfg, meshes, oracle, rng,
                                 card)
        leave = replicas_leave(router, oracle, rng, cfg, card)
        release()
    finally:
        for rep in list(router.replicas.values()):
            rep.close()
        engine.plan_cache(reload=True)
    launches = main_path_launches("replicas", ("dpxor", "fused_scan_xor"))
    out = {"phase": "replicas", "card": card, "launches": launches,
           "fleet_over_one": load["fleet_over_one"],
           "prekeyed_fleet_over_one": prekeyed["fleet_over_one"],
           "keygen_threaded_over_serial": keygen["threaded_over_serial"],
           "first_answer_s": join["first_answer_s"],
           "kill_to_last_future_s": kill["kill_to_last_future_s"],
           "rejoin_s": rejoin["rejoin_s"], "handed_off": leave["handed_off"],
           "integrity_failures": corrupt["integrity_failures"],
           "chaos_kill_s": chaos_kill["first_submit_to_last_future_s"],
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return launches


#: the sharded phase: four ranks of torch.distributed on this card, each
#: a process of its own (gloo: NCCL refuses two ranks on one card), over
#: the (1, 4) and (2, 2) meshes of A6b's serving path
SHARDED_RANKS = 4
SHARDED_MESHES = ((1, 4), (2, 2))
SHARDED_QS = (32, 1)
SHARDED_UPDATE_ROWS = 8
#: a rank that has not finished after this long fails the phase
SHARDED_TIMEOUT_S = 600
#: SingleServerPIR(mesh=) at PIR_128M_LWE: queries of one call
SHARDED_LWE_QUERIES = 8
#: BatchPIR(mesh=) at PIR_1G_BATCH: its mesh, and the rows one publish
#: writes (their slots land in every block of the buckets)
SHARDED_BATCH_MESH = (1, 4)
SHARDED_BATCH_UPDATE_ROWS = 64
#: streaming sessions through the controller (rank 0): PIR_1G batches of
#: a whole bucket, cut only when full (``max_wait_s`` far off), from
#: client threads; xor on (1, 4), two lanes on (2, 2), chaos on (1, 4)
SHARDED_SESSION_Q = 32
SHARDED_SESSION_THREADS = 4
SHARDED_SESSION_WAIT_S = 60.0
#: every rank's session ends within this of a chaos kill (s)
SHARDED_KILL_BOUND_S = 5.0
#: the collective timeout of the ranks' process group (s): a rank that
#: never joins a collective fails the others' after it
SHARDED_COLLECTIVE_TIMEOUT_S = 300.0


def sharded_expected(server, n: int) -> dict:
    """The launches one rank's answer of ``n`` queries must add: one of
    its bucket's plan's kernel for each party (every path of the port's
    answer step is one launch)."""
    plan = server.bucketed.plan_for_bucket(server.bucketed.bucket_for(n))
    return {_kernels_of(plan, server.protocol.share_kind)[0]: 1}


def sharded_probe(device) -> dict:
    """Whether gloo's all_gather and all_reduce take a CUDA tensor as it is
    (every rank tries each op the same way, so an op refused on one is
    refused on all). Point-to-point ops are not tried: gloo's send hands
    the tensor's pointer to its host transport, which is why the
    collectives run on the host under gloo."""
    import torch.distributed as dist
    x = torch.arange(8, dtype=torch.int32, device=device)
    ops_ = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(dist.get_world_size())], x),
        "all_reduce": lambda: dist.all_reduce(x.clone())}
    out = {}
    for name, fn in ops_.items():
        try:
            fn()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as e:   # noqa: BLE001 - the refusal is the result
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
        dist.barrier()
    return out


def sharded_time(server, view, keys) -> dict:
    """CUDA events around one batch's answer step (this rank's shard) and
    its collective (the reduce over the shard axis and the clusters'
    gather), after the counted run."""
    keys = server.protocol.pad(keys, server.bucketed.bucket_for(
        server.protocol.n_queries(keys))).to(view.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    part, plan = server.bucketed.local_answer(view, keys)
    ev[1].record()
    server.bucketed.combine(part, plan)
    ev[2].record()
    torch.cuda.synchronize()
    return {"answer_ms": ev[0].elapsed_time(ev[1]),
            "collective_ms": ev[1].elapsed_time(ev[2])}


def sharded_kernels(database, db_lwe, ct, device) -> dict:
    """B1-B5 at a shard's shapes (a quarter of PIR_1G, 2^23 rows; a quarter
    of PIR_128M_LWE) on this rank's block and ``start_block``, by CUDA
    events while the other ranks wait: the kernel alone on the card,
    beside its bound at that shape. Outside the counted runs."""
    from repro_torch.configs.pir import PIR_1G, PIR_1G_ADD
    from repro_torch.core import dpf
    from repro_torch.core.protocol import get, plan_for
    from repro_torch.kernels import (dpxor as kd, fused_scan as kf,
                                     lwe_matmul as kl, ops,
                                     pir_matmul as km)
    rng = np.random.default_rng(SEED + 506)
    words, raw = database.view("words"), database.view("bytes")
    rows, w = words.shape
    log_local = rows.bit_length() - 1
    start = database.shard_index
    out = {"rows": rows, "start_block": start}
    xor, add = get(PIR_1G.protocol), get(PIR_1G_ADD.protocol)
    pick = lambda n: rng.integers(0, PIR_1G.n_items, size=n)

    k1 = xor.query_gen_batch(rng, pick(1), PIR_1G)[0].to(device)
    bits = dpf.eval_bits_batch(k1, start, log_local)
    out["dpxor"] = {"q": 1, "ms": cuda_time_ms(lambda: kd.dpxor(words, bits),
                                               reps=20),
                    "bound_ms": dpxor_bound_ms(rows, w, 1),
                    "bound_by": "bytes"}
    k32 = xor.query_gen_batch(rng, pick(32), PIR_1G)[0].to(device)
    plan = plan_for(PIR_1G, 32, backend="cuda")
    _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log,
                                                    log_local))
    inputs = fused_inputs(k32, start, log_local, clog)
    bound, by = fused_xor_bound(rows, w, 32, clog, k32.rounds)
    out["fused_scan_xor"] = {
        "q": 32, "clog": clog, "bound_ms": bound, "bound_by": by,
        "ms": cuda_time_ms(lambda: kf.fused_scan_xor(
            words, *inputs, rounds=k32.rounds), reps=3)}

    a1 = add.query_gen_batch(rng, pick(1), PIR_1G_ADD)[0].to(device)
    shares = dpf.eval_bytes_batch(a1, start, log_local).view(torch.int8)
    out["pir_gemm"] = {"q": 1, "ms": cuda_time_ms(
        lambda: km.pir_gemm(shares, raw), reps=20),
        "bound_ms": gemm_bound_ms(rows, raw.shape[1], 1), "bound_by": "bytes"}
    a32 = add.query_gen_batch(rng, pick(32), PIR_1G_ADD)[0].to(device)
    plan = plan_for(PIR_1G_ADD, 32, backend="cuda")
    _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log,
                                                    log_local))
    inputs = fused_inputs(a32, start, log_local, clog) + (
        a32.cw_final[:, 0].contiguous(),)
    out["fused_scan_add"] = {
        "q": 32, "clog": clog, "bound_by": "operations",
        "bound_ms": fused_add_bound_ms(rows, 32, clog, a32.rounds),
        "ms": cuda_time_ms(lambda: kf.fused_scan_add(
            raw, *inputs, party=a32.party, rounds=a32.rounds), reps=3)}

    b32 = db_lwe.view("bytes32")
    lo = db_lwe.shard_index * b32.shape[0]
    ct_local = ct[:, lo:lo + b32.shape[0]].contiguous()
    bound, by = lwe_gemm_bound(ct.shape[0], b32.shape[0], b32.shape[1])
    out["lwe_gemm"] = {"q": ct.shape[0], "rows": b32.shape[0],
                       "bound_ms": bound, "bound_by": by,
                       "ms": cuda_time_ms(lambda: kl.lwe_gemm(ct_local, b32),
                                          reps=20)}
    return out


def sharded_serve(system, host, idx, counts) -> dict:
    """One synchronous query on every rank: the records exact, and this
    rank's counters advanced by exactly one launch a party of the plan's
    kernel, with no plain call."""
    from repro_torch.kernels import ops
    want = {}
    for server in system.servers:
        for k, v in sharded_expected(server, len(idx)).items():
            want[k] = want.get(k, 0) + v
    ops.reset_counts()
    t0 = time.perf_counter()
    recs = system.query(idx)
    seconds = time.perf_counter() - t0
    got = {k: v["launches"] for k, v in ops.counts().items() if v["launches"]}
    plain = sum(v["plain_calls"] for v in ops.counts().values())
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    return {"n": len(idx), "seconds": seconds,
            "exact": check_records(recs, expected_records(system, host, idx)),
            "launches": got, "want": want,
            "launches_ok": got == want and plain == 0}


def sharded_counted(fn) -> tuple:
    """``fn()`` with the counters zeroed before it and read after it:
    ``(result, seconds, B5 launches, plain calls)``."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.counts()
    return (result, seconds, counts["lwe_gemm"]["launches"],
            sum(v["plain_calls"] for v in counts.values()))


def session_submit(system, idx) -> list:
    """Submit ``idx`` from ``SHARDED_SESSION_THREADS`` client threads at
    once; returns ``(index, future)`` pairs in the order of ``idx``."""
    futs = [None] * len(idx)

    def client(k):
        for j in range(k, len(idx), SHARDED_SESSION_THREADS):
            futs[j] = system.submit(int(idx[j]))
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SHARDED_SESSION_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return list(zip((int(i) for i in idx), futs))


def session_ends(system, batches0: int = 0) -> dict:
    """What one rank's session left: its epoch, and the controller's
    batches (past ``batches0``, those before the session) and command
    channel, or the follower's loop."""
    out = {"epoch": system.epoch, "t_close": time.monotonic()}
    f = system.follower
    if f is None:
        ch = system.scheduler.channel
        out.update(batches=system.scheduler.stats.batches - batches0,
                   sent=ch.sent, channel_s=ch.seconds)
    else:
        out.update(dispatches=f.dispatches, publishes=f.publishes,
                   ended_by=f.ended_by, t_end=f.t_end,
                   exc=None if f.exc is None
                   else f"{type(f.exc).__name__}: {f.exc}")
    return out


def session_launches(system, batches: int, counts: dict) -> dict:
    """Each rank's counters over a session of ``batches`` full buckets:
    its bucket plan's kernel once a party and batch, no plain call."""
    want = {}
    for server in system.servers:
        for k, v in sharded_expected(server, SHARDED_SESSION_Q).items():
            want[k] = want.get(k, 0) + v * batches
    got = {k: v["launches"] for k, v in counts.items() if v["launches"]}
    plain = sum(v["plain_calls"] for v in counts.values())
    return {"launches": got, "want": want, "plain_calls": plain,
            "launches_ok": got == want and plain == 0}


def sharded_session(database, host, updated, mesh, idx_rng,
                    n_clusters: int) -> dict:
    """xor-dpf-2 at PIR_1G in a session through the controller: it submits
    a bucket of queries from client threads, and once they resolve stages
    and publishes rows in every block (``SHARDED_UPDATE_ROWS``), then a
    bucket that reads some of them. Every record must be the host's at the
    epoch its future is tagged with (``updated``: the rows an earlier
    publish wrote), every rank must end at one epoch, each follower must
    have dispatched the controller's batches, and each rank launched its
    plan's kernel once a party and batch, with no plain call. Every rank
    draws the same indices from ``idx_rng``."""
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_loop import TwoServerPIR
    client = mesh.is_controller
    system = TwoServerPIR(
        database, PIR_1G, mesh=mesh, n_queries=SHARDED_SESSION_Q,
        n_clusters=n_clusters, max_wait_s=SHARDED_SESSION_WAIT_S,
        client_rng=np.random.default_rng(SEED + 510) if client else None)
    n, quarter = PIR_1G.n_items, PIR_1G.n_items // 4
    first = idx_rng.integers(0, n, size=SHARDED_SESSION_Q)
    blocks = np.arange(SHARDED_UPDATE_ROWS) % 4
    rows = blocks * quarter + idx_rng.integers(0, quarter,
                                               size=SHARDED_UPDATE_ROWS)
    vals = idx_rng.integers(0, 2 ** 32, size=(len(rows), 8),
                            dtype=np.uint64).astype(np.uint32)
    second = np.concatenate([rows, idx_rng.integers(
        0, n, size=SHARDED_SESSION_Q - len(rows))])
    e0 = database.epoch
    ops.reset_counts()
    t0 = time.perf_counter()
    system.start()
    out = {"n_clusters": n_clusters}
    if client:
        futs = session_submit(system, first)
        recs = [(i, f.result(timeout=600), f.epoch) for i, f in futs]
        system.update(rows, vals)
        out["epoch_published"] = system.publish()
        futs = session_submit(system, second)
        recs += [(i, f.result(timeout=600), f.epoch) for i, f in futs]
        fresh = dict(zip(rows.tolist(), vals))
        out["records_exact"] = all(
            np.array_equal(rec, fresh[i] if epoch > e0 and i in fresh
                           else updated.get(i, host[i]))
            for i, rec, epoch in recs)
        out["epochs"] = sorted({epoch for _, _, epoch in recs})
        out["epochs_ok"] = out["epochs"] == [e0, e0 + 1]
    system.close()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    updated.update(zip(rows.tolist(), vals))
    ends = session_ends(system)
    batches = (ends["batches"] if client else ends["dispatches"])
    out.update(ends, **session_launches(system, batches, ops.counts()))
    if client:
        st = system.scheduler.stats
        out.update(latency_median_s=float(np.median(st.latencies)),
                   records_per_s=st.qps, bucket_counts=st.bucket_counts,
                   lanes=sorted(system.scheduler.monitor.ewma),
                   channel_s_per_dispatch=(out["channel_s"]["DISPATCH"]
                                           / out["sent"]["DISPATCH"]))
    return out


def sharded_chaos(database, host, updated, mesh, idx_rng) -> dict:
    """The chaos seams in a session on the controller, PIR_1G, whole
    buckets (a bucket submitted before ``start()``, then one after the
    first resolved, so that no pad slot exists): (a) a corrupt at
    ``replica.serve_step``'s visit 1 without checksums must change exactly
    one word of one record of the second batch; (b) a kill at
    ``scheduler.dispatch``'s visit 1 must resolve the first batch, fail
    every later future with ``InjectedFault`` and end every rank's loop.
    Every rank builds the facade with the same plan; only the controller
    visits it. The kill's instant is stamped where the seam raises."""
    from repro_torch.chaos import ChaosInjector, FaultEvent, FaultPlan
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.runtime.serve_loop import TwoServerPIR
    client = mesh.is_controller
    out = {}
    for part, seam, action in (("corrupt", "replica.serve_step", "corrupt"),
                               ("kill", "scheduler.dispatch", "kill")):
        chaos = ChaosInjector(FaultPlan(SEED + 511, (
            FaultEvent(seam, action, at=1),)))
        stamp = {}
        visit = chaos.visit

        def stamped(*args, visit=visit, stamp=stamp):
            try:
                return visit(*args)
            except Exception:
                stamp["t_kill"] = time.monotonic()
                raise
        chaos.visit = stamped
        system = TwoServerPIR(
            database, PIR_1G, mesh=mesh, n_queries=SHARDED_SESSION_Q,
            max_wait_s=SHARDED_SESSION_WAIT_S, chaos=chaos,
            client_rng=np.random.default_rng(SEED + 512) if client else None)
        idx = [idx_rng.integers(0, PIR_1G.n_items, size=SHARDED_SESSION_Q)
               for _ in range(2)]
        want = [np.stack([updated.get(int(i), host[i]) for i in ix])
                for ix in idx]
        t0 = time.perf_counter()
        res = {}
        futs = ([system.submit(int(i)) for i in idx[0]] if client else [])
        system.start()
        if client:
            first = np.stack([f.result(timeout=600) for f in futs])
            futs = [system.submit(int(i)) for i in idx[1]]
            got, errors = [], set()
            for f in futs:
                try:
                    got.append(f.result(timeout=600))
                except Exception as e:   # noqa: BLE001 - the outcome
                    errors.add(f"{type(e).__name__}: {e}")
            res["first_exact"] = check_records(first, want[0])
            res["errors"] = sorted(errors)
            if part == "corrupt":
                diff = np.stack(got) != want[1]
                res["records_changed"] = int(diff.any(axis=1).sum())
                res["words_changed"] = int(diff.sum())
            res["fired"] = [[f.seam, f.target, f.action, f.visit]
                            for f in chaos.fired]
            res.update(stamp)
        system.close()
        res["seconds"] = time.perf_counter() - t0
        res.update(session_ends(system))
        out[part] = res
    return out


def sharded_lwe_single(db_lwe, whole, host_lwe, mesh, idx_rng,
                       device) -> dict:
    """SingleServerPIR(mesh=) at PIR_128M_LWE over this rank's block of
    ``db_lwe``: a query of ``SHARDED_LWE_QUERIES`` indices drawn and
    encrypted on the mesh's first rank (the whole of A there, one block of
    A on every other rank), the hint built per block and summed, then an
    update of rows in every block, its hint delta, and a query of those
    rows. Every rank's records exact and its B5 launches exactly the
    design's (the client's A.s on the first rank, one answer a batch, one
    block build, one delta), no plain call; the first rank (``whole``:
    the unsharded database there) holds the replicated hint to one
    unsharded B5 build before and after the publish, and times the block
    build, B5 at the block's shape and the delta by CUDA events, alone on
    the card. Every rank times the hint's all-reduce."""
    import torch.distributed as dist
    from repro_torch.configs.pir import PIR_128M_LWE as cfg
    from repro_torch.core import lwe
    from repro_torch.crypto.packing import words_to_bytes_i32
    from repro_torch.kernels import lwe_matmul as kl
    from repro_torch.runtime.serve_loop import SingleServerPIR
    client = mesh.rank == mesh.ranks[0]
    system = SingleServerPIR(
        db_lwe, cfg, mesh=mesh, n_queries=SHARDED_LWE_QUERIES,
        client_rng=np.random.default_rng(SEED + 507) if client else None)
    name, params = system.protocol.name, lwe.params_for(cfg.n_items)
    build = lwe.hint_build_fn(params, cfg.n_items)
    lo, hi = db_lwe.rows
    out = {"rows": [lo, hi], "client": client}

    idx = idx_rng.integers(0, cfg.n_items, size=SHARDED_LWE_QUERIES)
    recs, secs, n, plain = sharded_counted(lambda: system.query(idx))
    # the client's A.s (first rank), the batch's answer, the block build
    out["query"] = {"seconds": secs, "launches": n, "plain_calls": plain,
                    "want": 3 if client else 2,
                    "exact": check_records(recs, host_lwe[idx].view(
                        np.uint8))}
    hint = system.db.hint(name)
    out["hint_shape"] = list(hint.shape)
    if client:
        out["hint_exact"] = bool(torch.equal(hint, build(
            whole.view("words"))))
        words = db_lwe.view("words")
        d_t = words_to_bytes_i32(words).t().contiguous()
        a = lwe.matrix_a_device(params, cfg.n_items, device, rows=(lo, hi))
        bound, by = lwe_gemm_bound(d_t.shape[0], hi - lo, params.n)
        out["hint_build"] = {
            "m": d_t.shape[0], "k": hi - lo, "n": params.n,
            "ms": cuda_time_ms(lambda: build(words, row0=lo), reps=5),
            "kernel_ms": cuda_time_ms(lambda: kl.lwe_gemm(d_t, a), reps=5),
            "bound_ms": bound, "bound_by": by}
        del d_t, a
    dist.barrier()

    # an update with rows in every block of four, then those rows served
    blocks = np.arange(SHARDED_UPDATE_ROWS) % 4
    quarter = cfg.n_items // 4
    rows = blocks * quarter + idx_rng.integers(0, quarter,
                                               size=SHARDED_UPDATE_ROWS)
    vals = idx_rng.integers(0, 2 ** 32, size=(len(rows), 8),
                            dtype=np.uint64).astype(np.uint32)
    deltas = db_lwe.stats.n_hint_deltas
    system.update(rows, vals)
    epoch, secs, n, plain = sharded_counted(system.publish)
    out["publish"] = {"epoch": epoch, "seconds": secs, "launches": n,
                      "plain_calls": plain, "want": 1,
                      "hint_deltas": db_lwe.stats.n_hint_deltas - deltas}
    recs, secs, n, plain = sharded_counted(lambda: system.query(rows))
    out["query_after"] = {"seconds": secs, "launches": n,
                          "plain_calls": plain, "want": 2 if client else 1,
                          "exact": check_records(recs, vals.view(np.uint8))}
    hint = system.db.hint(name)
    if client:
        whole.stage(rows, vals)
        whole.publish()
        out["hint_after_exact"] = bool(torch.equal(hint, build(
            whole.view("words"))))
        mine = rows[(rows >= lo) & (rows < hi)]
        local = torch.as_tensor(mine - lo, device=device)
        new = db_lwe.view("words")[local]
        zero = torch.zeros_like(hint)
        delta = lwe.hint_delta_fn(params, cfg.n_items)
        out["hint_delta"] = {"rows": len(mine), "ms": cuda_time_ms(
            lambda: delta(zero, mine, new, new, row0=lo, n_rows=hi - lo),
            reps=20)}
    dist.barrier()
    part = torch.zeros_like(hint)
    out["reduce_ms"] = cuda_time_ms(lambda: db_lwe._shard_sum(part), reps=5)
    return out


def sharded_lwe_session(host_lwe, mesh, idx_rng) -> dict:
    """SingleServerPIR at PIR_128M_LWE in a session through the controller,
    on a database placed for it: ``start()`` builds the hint on every rank,
    the controller encrypts ``SHARDED_LWE_QUERIES`` submits with the whole
    of A (one B5 launch each), then stages and publishes rows in every
    block (the delta applied on every rank inside ``PUBLISH``), then as
    many submits of them and others. Every record exact; one hint build and
    one delta on every rank; B5 launched 2 (answers) + 1 (build) + 1
    (delta) times on every rank, and 2 x SHARDED_LWE_QUERIES more
    (encryptions) on the controller, with no plain call."""
    from repro_torch.configs.pir import PIR_128M_LWE as cfg
    from repro_torch.db import Database
    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_loop import SingleServerPIR
    client = mesh.is_controller
    db = Database(host_lwe, cfg, mesh=mesh)
    system = SingleServerPIR(
        db, cfg, mesh=mesh, n_queries=SHARDED_LWE_QUERIES,
        max_wait_s=SHARDED_SESSION_WAIT_S,
        client_rng=np.random.default_rng(SEED + 513) if client else None)
    quarter = cfg.n_items // 4
    first = idx_rng.integers(0, cfg.n_items, size=SHARDED_LWE_QUERIES)
    blocks = np.arange(SHARDED_UPDATE_ROWS) % 4
    rows = blocks * quarter + idx_rng.integers(0, quarter,
                                               size=SHARDED_UPDATE_ROWS)
    vals = idx_rng.integers(0, 2 ** 32, size=(len(rows), 8),
                            dtype=np.uint64).astype(np.uint32)
    second = rows[:SHARDED_LWE_QUERIES]
    ops.reset_counts()
    t0 = time.perf_counter()
    system.start()
    out = {}
    if client:
        got = np.stack([f.result(timeout=600) for f in
                        [system.submit(int(i)) for i in first]])
        out["exact"] = check_records(got, host_lwe[first].view(np.uint8))
        system.update(rows, vals)
        out["epoch_published"] = system.publish()
        got = np.stack([f.result(timeout=600) for f in
                        [system.submit(int(i)) for i in second]])
        out["exact_after"] = check_records(
            got, vals[:SHARDED_LWE_QUERIES].view(np.uint8))
    system.close()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    counts = ops.counts()
    out.update(session_ends(system),
               n_hint_builds=db.stats.n_hint_builds,
               n_hint_deltas=db.stats.n_hint_deltas,
               launches=counts["lwe_gemm"]["launches"],
               want=4 + (2 * SHARDED_LWE_QUERIES if client else 0),
               plain_calls=sum(v["plain_calls"] for v in counts.values()))
    if client:
        out["latency_median_s"] = float(np.median(
            system.scheduler.stats.latencies))
    return out


def sharded_batch(host, layout, mesh, idx_rng, device) -> dict:
    """BatchPIR(mesh=) at PIR_1G_BATCH (2^25 records, m = 256, B = 512
    buckets of 2^18 rows, xor-dpf-2): the parent's layout, each rank's
    block of every bucket read from the memory-mapped records, one round
    of m distinct indices, a publish of rows whose slots land in every
    block, then a round with them. Every rank's records exact, every
    dispatch 512 wide, B1 launched B times a party and round, one reduce a
    party and dispatch, no plain call; the first rank times B1 on one
    bucket's block alone on the card."""
    import torch.distributed as dist
    from repro_torch.configs.pir import PIR_1G_BATCH as cfg
    from repro_torch.core import dpf
    from repro_torch.db import BucketedDatabase
    from repro_torch.kernels import dpxor as kd, ops
    from repro_torch.runtime.batch import BatchPIR
    client = mesh.rank == mesh.ranks[0]
    t0 = time.perf_counter()
    bdb = BucketedDatabase(host, cfg, layout=layout, mesh=mesh)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "rows": list(bdb.buckets[0].rows),
           "resident_bytes": bdb.resident_bytes}
    system = BatchPIR(bdb, cfg, mesh=mesh, client_rng=np.random.default_rng(
        SEED + 508) if client else None)
    parties, n_buckets = system.n_parties, bdb.n_buckets
    out["plan"] = system.serve[0].plan_for_bucket(1).name
    reduces = []
    proto = system.protocol
    reduce = proto.reduce

    def counting(*args, **kwargs):
        reduces.append(1)
        return reduce(*args, **kwargs)

    proto.reduce = counting           # this rank's process only
    rounds = []
    updated: dict = {}

    def serve_round(kind, idx, want_epoch):
        # SPMD: every rank calls query_batch, the rounds planned on the
        # controller and broadcast
        ops.reset_counts()
        r0, log0 = len(reduces), len(system.dispatch_log)
        t0 = time.perf_counter()
        recs = system.query_batch(idx)
        seconds = time.perf_counter() - t0
        epoch, log = system.epoch, system.dispatch_log[log0:]
        counts = ops.counts()
        want = np.stack([updated.get(int(i), host[i]) for i in idx])
        rounds.append({
            "kind": kind, "n": len(idx), "seconds": seconds,
            "dispatch_log": log, "epoch": epoch,
            "want_epoch": want_epoch,
            "dpxor_launches": counts["dpxor"]["launches"],
            "want_launches": n_buckets * parties * len(log),
            "reduces": len(reduces) - r0, "want_reduces": parties * len(log),
            "plain_calls": sum(v["plain_calls"] for v in counts.values()),
            "exact": check_records(recs, want)})

    try:
        m = cfg.batch_m
        first = idx_rng.choice(cfg.n_items, size=m, replace=False)
        serve_round("distinct", first, 0)
        rows, vals = fresh_rows(idx_rng, cfg.n_items,
                                SHARDED_BATCH_UPDATE_ROWS, 8)
        # random rows fill slots below the buckets' loads (about 3/4 of
        # the capacity), so the last block holds pad rows but in the
        # fullest buckets: the first rows are the fullest bucket's records
        # at each block's first slot
        block = layout.capacity // mesh.shape["model"]
        fullest = layout.bucket_rows[int(np.argmax(layout.loads))]
        edge = fullest[::block][:mesh.shape["model"]]
        rows[:len(edge)] = edge
        out["publish_blocks"] = sorted({
            slot // block for r in rows
            for _, slot in layout.occurrences(int(r))})
        system.update(rows, vals)
        t0 = time.perf_counter()
        out["epoch"] = system.publish()
        torch.cuda.synchronize()
        out["publish_s"] = time.perf_counter() - t0
        updated.update(zip(rows.tolist(), vals))
        serve_round("after_publish", np.concatenate(
            [rows, first[:m - len(rows)]]), 1)
        # a session: the controller plans and submits one round of m
        # distinct indices, and every rank dispatches it
        idx = idx_rng.choice(cfg.n_items, size=m, replace=False)
        ops.reset_counts()
        log0 = len(system.dispatch_log)
        batches0 = system.scheduler.stats.batches
        t0 = time.perf_counter()
        system.start()
        session = {}
        if client:
            fut = submit_placed(system, idx)
            session["plan_s"] = time.perf_counter() - t0
            recs = fut.result(timeout=600)
            session["exact"] = check_records(recs, np.stack(
                [updated.get(int(i), host[i]) for i in idx]))
            session["epoch"] = fut.epoch
        system.close()
        torch.cuda.synchronize()
        counts = ops.counts()
        session.update(
            session_ends(system, batches0), seconds=time.perf_counter() - t0,
            dispatch_log=system.dispatch_log[log0:],
            dpxor_launches=counts["dpxor"]["launches"],
            want_launches=n_buckets * parties,
            plain_calls=sum(v["plain_calls"] for v in counts.values()))
        out["session"] = session
    finally:
        del proto.reduce
    out["rounds"] = rounds
    if client:
        view = bdb.buckets[0].view("words")
        keys = proto.query_gen_batch(np.random.default_rng(SEED + 509), [5],
                                     system.inner_cfg)[0].to(device)
        log_local = view.shape[0].bit_length() - 1
        bits = dpf.eval_bits_batch(keys, bdb.buckets[0].shard_index,
                                   log_local)
        out["dpxor_block"] = {
            "rows": view.shape[0], "q": 1, "bound_by": "bytes",
            "bound_ms": dpxor_bound_ms(view.shape[0], view.shape[1], 1),
            "ms": cuda_time_ms(lambda: kd.dpxor(view, bits), reps=20)}
    dist.barrier()
    return out


#: the fleet on sub-meshes (A6b-serve-2's replicas): two PIR_1G replicas on
#: the (1, 2) sub-meshes of the four ranks (carve_submeshes(2,
#: model_axis=2)), each rank holding half of its replica's database; rank 0
#: is the fleet's controller (inside r0's grid, outside r1's) and the
#: others follow the fleet. Buckets 1 and 32, batches cut after
#: FLEET_MAX_WAIT_S; the rejoined replica waits SHARDED_SESSION_WAIT_S, so
#: that a leave finds its queries queued
FLEET_MODEL_AXIS = 2
FLEET_KW = dict(n_queries=32, buckets=(1, 32), path=None)
FLEET_MAX_WAIT_S = 0.05
FLEET_CLIENTS = 4
FLEET_LOAD = 64
FLEET_UPDATE_ROWS = 64
FLEET_KILL_QUERIES = 32
FLEET_REJOIN_QUERIES = 32
FLEET_LEAVE_QUERIES = 8
#: the fleet's replicas in the order the controller builds them (their
#: fleet serials 1, 2, 3), each one's mesh, and how its followers' loops end
FLEET_REPLICAS = (("A", 0, "ABORT"), ("B", 1, "STOP"), ("C", 0, "STOP"))


def fleet_controller(host, meshes) -> dict:
    """Rank 0's part of the fleet: the Router over r0 and r1, a publish of
    FLEET_UPDATE_ROWS rows, FLEET_LOAD queries through the router from
    FLEET_CLIENTS threads, a kill of r0 under FLEET_KILL_QUERIES pinned
    queries, a warm rejoin of r0 on meshes[0] from r1's plans with a whole
    bucket pinned to it, a graceful leave of the rejoined r0 with
    FLEET_LEAVE_QUERIES queued (handed off to r1). Every record exact at
    epoch 1; returns the timings, each replica's dispatched batch sizes,
    commands and replies, and each rank's launches its plans call for."""
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.replica import ServeReplica, close_fleet
    cfg = PIR_1G
    rng = np.random.default_rng(SEED + 520)
    oracle = Oracle(host)
    router = repl_router(SEED + 521)

    def replica(rid, mesh, seed, *, max_wait_s=FLEET_MAX_WAIT_S, **kw):
        return ServeReplica(rid, host, cfg, mesh, max_wait_s=max_wait_s,
                            client_rng=np.random.default_rng(seed),
                            **FLEET_KW, **kw)
    out = {}
    t0 = time.perf_counter()
    r0 = router.attach(replica("r0", meshes[0], SEED + 522))
    r1 = router.attach(replica("r1", meshes[1], SEED + 523))
    out["join_s"] = time.perf_counter() - t0
    rows, vals = fresh_rows(rng, cfg.n_items, FLEET_UPDATE_ROWS,
                            cfg.item_bytes // 4)
    router.update(rows, vals)
    t0 = time.perf_counter()
    epoch = router.publish()
    out["publish_s"] = time.perf_counter() - t0
    oracle.update(rows, vals)
    out["epochs"] = {rid: r.epoch for rid, r in router.replicas.items()}
    if epoch != 1 or set(out["epochs"].values()) != {1}:
        raise AssertionError(f"fleet publish: epochs {out['epochs']}")

    seen = {r.id: len(r.stats.latencies) for r in (r0, r1)}
    idx = rng.integers(0, cfg.n_items, size=FLEET_LOAD)
    futs, load_s = routed(router, idx, clients=FLEET_CLIENTS)
    lats = [x for r in (r0, r1) for x in r.stats.latencies[seen[r.id]:]]
    out["load"] = {"queries": FLEET_LOAD, "seconds": load_s,
                   "records_per_s": FLEET_LOAD / load_s,
                   "latency_median_s": float(np.median(lats)),
                   "batches": len(lats),
                   "split": check_routed("fleet load", futs, oracle(idx), 1)}

    s = router.session("victim")
    s.replica = "r0"
    idx = rng.integers(0, cfg.n_items, size=FLEET_KILL_QUERIES)
    futs = [router.submit(int(i), session=s) for i in idx]
    t_kill = time.monotonic()
    r0.kill("chip_smoke: killed under load")
    kill_call_s = time.monotonic() - t_kill     # the failovers it ran
    split = check_routed("fleet kill", futs, oracle(idx), 1)
    out["kill"] = {"queries": FLEET_KILL_QUERIES, "t_kill": t_kill,
                   "kill_call_s": kill_call_s, "split": split,
                   "failovers": router.failovers,
                   "suspects": router.registry.suspects()}
    if "r0" not in out["kill"]["suspects"] or router.failovers < 1:
        raise AssertionError(f"fleet kill: {out['kill']}")

    t0 = time.perf_counter()
    router.detach("r0")
    r0b = replica("r0", meshes[0], SEED + 524, warm_plans=r1.export_plans(),
                  max_wait_s=SHARDED_SESSION_WAIT_S)
    router.attach(r0b)
    out["rejoin_s"] = time.perf_counter() - t0
    s = router.session("rejoined")
    s.replica = "r0"
    idx = rng.integers(0, cfg.n_items, size=FLEET_REJOIN_QUERIES)
    futs, first_s = routed(router, idx, sessions=[s])
    out["rejoin"] = {
        "epoch": r0b.epoch, "first_bucket_s": first_s,
        "provenance": sorted({r["provenance"]
                              for r in r0b.plan_report().values()}),
        "split": check_routed("fleet rejoin", futs, oracle(idx), 1)}
    if out["rejoin"]["provenance"] != ["warm"] or \
            out["rejoin"]["split"] != {"r0": FLEET_REJOIN_QUERIES}:
        raise AssertionError(f"fleet rejoin: {out['rejoin']}")

    s = router.session("leaver")
    s.replica = "r0"
    idx = rng.integers(0, cfg.n_items, size=FLEET_LEAVE_QUERIES)
    futs = [router.submit(int(i), session=s) for i in idx]
    handed = router.detach("r0")
    check_routed("fleet leave", futs, oracle(idx), 1)
    out["leave"] = {"handed_off": handed,
                    "rejoined_answered": r0b.stats.answered}
    if handed != FLEET_LEAVE_QUERIES or \
            r0b.stats.answered != FLEET_REJOIN_QUERIES:
        raise AssertionError(f"fleet leave: {out['leave']}")
    r1.close()
    close_fleet(meshes)

    want: dict = {str(r): {} for r in range(SHARDED_RANKS)}
    out["replicas"] = {}
    for (label, mesh, _), rep in zip(FLEET_REPLICAS, (r0, r1, r0b)):
        ch = rep.scheduler.channel
        sizes = [f[0] for f in ch.dispatched]
        out["replicas"][label] = {
            "id": rep.id, "dispatched": len(sizes), "sent": dict(ch.sent),
            "batches": rep.stats.batches,
            "reply_s": ch.reply_s["ANSWER"], "reply_wait_s": ch.wait_s}
        for rank in meshes[mesh].ranks:
            for n in sizes:
                for server in rep.pir.servers:
                    for k, v in sharded_expected(server, n).items():
                        want[str(rank)][k] = want[str(rank)].get(k, 0) + v
    out["want_launches"] = want
    return out


def fleet_chaos_corrupt(meshes) -> dict:
    """Rank 0's part of the chaos smoke's scenario B on the sub-meshes, with
    a minute's max_wait_s (r0's first batch a whole bucket of real
    queries): what ``scenario_corrupt`` returns (it raises unless the
    corrupt was detected and every record recovered from r1), and what
    r0's ``replica.serve_step`` seam changed in each batch's answer shares
    (the rows, one a query, and the words that differ)."""
    from repro_torch import replica
    from repro_torch.chaos import smoke
    changed = []
    serve_replica = replica.ServeReplica

    class Watched(serve_replica):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if self.id != "r0":
                return
            serve_step = self.pir._serve_step

            def watched(answers):
                out = serve_step(answers)
                diff = [a != b for a, b in zip(answers, out)]
                changed.append([sum(int(d.any(dim=-1).sum()) for d in diff),
                                sum(int(d.sum()) for d in diff)])
                return out
            self.pir._serve_step = watched
    replica.ServeReplica = Watched
    try:
        out = smoke.scenario_corrupt(meshes=meshes,
                                     max_wait_s=SHARDED_SESSION_WAIT_S)
    finally:
        replica.ServeReplica = serve_replica
    out["changed"] = changed
    return out


def sharded_fleet(host) -> dict:
    """The fleet on (1, 2) sub-meshes, on every rank: the controller's part
    (``fleet_controller``) on rank 0, ``follow_fleet`` elsewhere; each
    rank's kernel counters and peak device memory over it. Then the chaos
    smoke's scenario B on (1, 2) sub-meshes (``fleet_chaos_corrupt``; the
    others ``smoke.follow``)."""
    import torch.distributed as dist
    from repro_torch import engine
    from repro_torch.chaos import smoke
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.kernels import ops
    from repro_torch.replica import follow_fleet
    from repro_torch.runtime.elastic import carve_submeshes
    rank = dist.get_rank()
    engine.plan_cache(reload=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meshes = carve_submeshes(2, model_axis=FLEET_MODEL_AXIS)
    ops.reset_counts()
    out = (fleet_controller(host, meshes) if rank == 0 else
           {"followed": follow_fleet(meshes, host, PIR_1G, **FLEET_KW)})
    torch.cuda.synchronize()
    counts = ops.counts()
    out.update(
        seconds=time.perf_counter() - t0,
        meshes=[[list(m.sizes), list(m.ranks), m.controller]
                for m in meshes],
        launches={k: v["launches"] for k, v in counts.items()
                  if v["launches"]},
        plain_calls=sum(v["plain_calls"] for v in counts.values()),
        peak_device_bytes=torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    engine.plan_cache(reload=True)
    t0 = time.perf_counter()
    meshes = carve_submeshes(2, model_axis=FLEET_MODEL_AXIS)
    out["chaos"] = (fleet_chaos_corrupt(meshes) if rank == 0 else
                    {"followed": smoke.follow("corrupt", meshes)})
    out["chaos"]["seconds"] = time.perf_counter() - t0
    engine.plan_cache(reload=True)
    return out


def sharded_rank(rank: int, tmp: str) -> None:
    """One rank of the sharded phase, in a process of its own: join the
    process group through a file under ``tmp``, load the kernels the
    parent built, and serve the parent's memory-mapped databases on each
    mesh. Writes its results (or its error) to ``tmp/rank{rank}.json``."""
    out = {"rank": rank}
    try:
        out.update(sharded_rank_run(rank, tmp))
        out["ok"] = True
    except Exception as e:   # noqa: BLE001 - reported to the parent
        import traceback
        out.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_rank_run(rank: int, tmp: str) -> dict:
    import torch.distributed as dist
    from repro_torch.config import MeshConfig
    from repro_torch.configs.pir import (PIR_1G, PIR_1G_ADD, PIR_1G_K3,
                                         PIR_128M_LWE)
    from repro_torch.core import lwe
    from repro_torch.core.server import PIRServer
    from repro_torch.db import Database
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.runtime.serve_loop import MultiServerPIR, TwoServerPIR
    # a rank runs no nvcc: the parent's build must be on disk
    missing = [n for n in build.LIBRARIES
               if not build.library_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: no built library for {missing}")
    for name in build.LIBRARIES:
        build.library(name)
    backend = init_distributed(rank, SHARDED_RANKS, f"file://{tmp}/store",
                               timeout=SHARDED_COLLECTIVE_TIMEOUT_S)
    host = np.load(os.path.join(tmp, "db.npy"), mmap_mode="c")
    host_lwe = np.load(os.path.join(tmp, "db_lwe.npy"), mmap_mode="c")
    ct = np.load(os.path.join(tmp, "ct.npy"), mmap_mode="c")
    out = {"backend": backend, "meshes": {}}
    try:
        meshes = {shape: make_mesh(MeshConfig(shape=shape,
                                              axes=("data", "model")))
                  for shape in SHARDED_MESHES}
        device = meshes[SHARDED_MESHES[0]].device
        out["device"] = str(device)
        out["transport"] = meshes[SHARDED_MESHES[0]].transport
        out["gloo_cuda"] = sharded_probe(device) if backend == "gloo" else {}
        idx_rng = np.random.default_rng(SEED + 500)     # the same on all
        for shape, mesh in meshes.items():
            tag = f"{shape[0]}x{shape[1]}"
            counts: dict = {}
            t0 = time.perf_counter()
            database = Database(host, PIR_1G, mesh=mesh)
            row = {"rows": list(database.rows),
                   "start_block": database.shard_index,
                   "cluster": mesh.coord("data"),
                   "place_s": time.perf_counter() - t0, "batches": []}
            view = database.view("words")
            for coll in ("gather", "butterfly"):
                rng = np.random.default_rng(SEED + 501) if rank == 0 \
                    else None
                system = TwoServerPIR(database, PIR_1G, mesh=mesh,
                                      collective=coll, client_rng=rng,
                                      n_queries=32)
                for n in SHARDED_QS:
                    idx = idx_rng.integers(0, PIR_1G.n_items, size=n)
                    row["batches"].append({
                        "config": "pir-1g", "collective": coll,
                        **sharded_serve(system, host, idx, counts)})
                keys = system.protocol.query_gen_batch(
                    np.random.default_rng(SEED + 502),
                    idx_rng.integers(0, PIR_1G.n_items, size=32), PIR_1G)
                row[f"timing_{coll}"] = sharded_time(system.servers[0],
                                                     view, keys[0])
            for cfg, cls, name in ((PIR_1G_ADD, TwoServerPIR, "pir-1g-add"),
                                   (PIR_1G_K3, MultiServerPIR, "pir-1g-k3")):
                rng = np.random.default_rng(SEED + 503) if rank == 0 \
                    else None
                system = cls(database, cfg, mesh=mesh, client_rng=rng,
                             n_queries=32)
                idx = idx_rng.integers(0, cfg.n_items, size=32)
                row["batches"].append({"config": name, "collective": "gather",
                                       **sharded_serve(system, host, idx,
                                                       counts)})
            # one update of rows in every block, then those rows served
            system = TwoServerPIR(database, PIR_1G, mesh=mesh,
                                  client_rng=np.random.default_rng(SEED + 504)
                                  if rank == 0 else None, n_queries=32)
            blocks = np.arange(SHARDED_UPDATE_ROWS) % 4
            rows = blocks * (PIR_1G.n_items // 4) + idx_rng.integers(
                0, PIR_1G.n_items // 4, size=SHARDED_UPDATE_ROWS)
            vals = idx_rng.integers(0, 2 ** 32, size=(len(rows), 8),
                                    dtype=np.uint64).astype(np.uint32)
            system.update(rows, vals)
            row["epoch"] = system.publish()
            ops.reset_counts()
            got = system.query(rows)
            row["update_exact"] = bool(np.array_equal(got, vals))
            row["update_plain_calls"] = sum(
                v["plain_calls"] for v in ops.counts().values())
            for k, v in ops.counts().items():
                counts[k] = counts.get(k, 0) + v["launches"]
            del system, view
            # sessions through the controller: xor and chaos on (1, 4),
            # two lanes on (2, 2)
            updated = dict(zip(rows.tolist(), vals))
            if tag == "1x4":
                row["session"] = sharded_session(database, host, updated,
                                                 mesh, idx_rng, 1)
                row["chaos"] = sharded_chaos(database, host, updated, mesh,
                                             idx_rng)
            else:
                row["lanes"] = sharded_session(database, host, updated,
                                               mesh, idx_rng, 2)
            # lwe-simple-1: B5 on each block of seeded ciphertexts, then
            # the int32 all-reduce; rank 0 holds it to one unsharded B5
            # answer over the whole database
            db_lwe = Database(host_lwe, PIR_128M_LWE, mesh=mesh)
            server = PIRServer(0, database=db_lwe, cfg=PIR_128M_LWE,
                               mesh=mesh, n_queries=ct.shape[0])
            keys = lwe.LWECiphertext(
                ct=torch.from_numpy(ct).to(device), log_n=PIR_128M_LWE.log_n,
                n=lwe.params_for(PIR_128M_LWE.n_items).n)
            want = sharded_expected(server, ct.shape[0])
            ops.reset_counts()
            t0 = time.perf_counter()
            ans = server.answer(keys)
            torch.cuda.synchronize()
            lwe_s = time.perf_counter() - t0
            got = {k: v["launches"] for k, v in ops.counts().items()
                   if v["launches"]}
            plain = sum(v["plain_calls"] for v in ops.counts().values())
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
            row["lwe"] = {"seconds": lwe_s, "launches": got, "want": want,
                          "launches_ok": got == want and plain == 0,
                          **sharded_time(server, db_lwe.view("bytes32"),
                                         keys)}
            whole = None
            if rank == 0:
                whole = Database(host_lwe, PIR_128M_LWE, device)
                one = ops.lwe_gemm(keys.ct, whole.view("bytes32"))
                row["lwe"]["exact"] = bool(torch.equal(ans, one))
                del one
                if tag == "1x4":        # each kernel at a quarter's shape
                    row["kernels"] = sharded_kernels(database, db_lwe,
                                                     keys.ct, device)
            dist.barrier()
            del server, keys, ans, database
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            row["lwe_single"] = sharded_lwe_single(
                db_lwe, whole, host_lwe, mesh, idx_rng, device)
            row["lwe_single"]["seconds"] = time.perf_counter() - t0
            if tag == "1x4":
                row["lwe_session"] = sharded_lwe_session(host_lwe, mesh,
                                                         idx_rng)
            del db_lwe, whole
            if rank != 0:   # rank 0 keeps the client's whole A for the next
                lwe.clear_matrix_cache()
            gc.collect()
            torch.cuda.empty_cache()
            row["launches"] = counts
            out["meshes"][tag] = row
            dist.barrier()
        lwe.clear_matrix_cache()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["batch"] = sharded_batch(host, load_layout(tmp),
                                     meshes[SHARDED_BATCH_MESH], idx_rng,
                                     device)
        out["batch"]["seconds"] = time.perf_counter() - t0
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        gc.collect()
        torch.cuda.empty_cache()
        out["fleet"] = sharded_fleet(host)
    finally:
        dist.destroy_process_group()
    return out


def save_layout(layout, tmp: str) -> None:
    """The cuckoo layout as arrays on disk, built once by the parent: the
    ranks map them (``load_layout``) instead of building it four times."""
    np.save(os.path.join(tmp, "layout_hashes.npy"), layout.hashes)
    np.save(os.path.join(tmp, "layout_slot_of.npy"), layout.slot_of)
    np.save(os.path.join(tmp, "layout_rows.npy"),
            np.concatenate(layout.bucket_rows))
    with open(os.path.join(tmp, "layout.json"), "w") as f:
        json.dump({"n_items": layout.n_items, "capacity": layout.capacity,
                   "params": vars(layout.params),
                   "loads": [len(r) for r in layout.bucket_rows]}, f)


def load_layout(tmp: str):
    """The parent's layout (``save_layout``), its arrays memory-mapped."""
    from repro_torch.core.batch import CuckooLayout, CuckooParams
    with open(os.path.join(tmp, "layout.json")) as f:
        meta = json.load(f)
    load = lambda name: np.load(os.path.join(tmp, f"layout_{name}.npy"),
                                mmap_mode="r")
    rows, ends = load("rows"), np.cumsum(meta["loads"])
    return CuckooLayout(
        n_items=meta["n_items"], params=CuckooParams(**meta["params"]),
        capacity=meta["capacity"], hashes=load("hashes"),
        slot_of=load("slot_of"),
        bucket_rows=tuple(rows[e - n:e] for e, n in zip(ends,
                                                        meta["loads"])))


def sharded_session_checks(ranks) -> tuple:
    """The checks of the sessions' parts over every rank's results, and a
    summary: each part's seconds, the controller's median batch latency
    and records/s, the command channel's host time a dispatch, each
    follower's dispatches, the seconds from the chaos kill to the last
    rank leaving its session, each rank's peak device memory."""
    ones = [r["meshes"]["1x4"] for r in ranks]
    twos = [r["meshes"]["2x2"] for r in ranks]
    parts = {"session": [m["session"] for m in ones],
             "lanes": [m["lanes"] for m in twos],
             "lwe_session": [m["lwe_session"] for m in ones],
             "batch_session": [r["batch"]["session"] for r in ranks]}

    def followed(part, publishes=None):
        ctl = part[0]
        return all(p["dispatches"] == ctl["batches"] and p["exc"] is None
                   and p["ended_by"] == "STOP"
                   and (publishes is None or p["publishes"] == publishes)
                   for p in part[1:])
    xor = [parts["session"], parts["lanes"]]
    corrupt = [m["chaos"]["corrupt"] for m in ones]
    kill = [m["chaos"]["kill"] for m in ones]
    c0, k0 = corrupt[0], kill[0]
    kill_to_exit = (max([k0["t_close"]] + [p["t_end"] for p in kill[1:]])
                    - k0["t_kill"]) if "t_kill" in k0 else None
    lwe, bat = parts["lwe_session"], parts["batch_session"]
    checks = {
        "session_records_exact": all(p[0]["records_exact"]
                                     and p[0]["epochs_ok"] for p in xor),
        "session_epochs_equal": all(len({r["epoch"] for r in p}) == 1
                                    for p in xor),
        "session_followers_dispatched": all(
            p[0]["batches"] == 2 and followed(p, 1) for p in xor),
        "session_launches_exact": all(r["launches_ok"] for p in xor
                                      for r in p),
        "session_lanes": parts["lanes"][0]["lanes"] == ["cluster0",
                                                        "cluster1"],
        "chaos_one_word": (c0["first_exact"] and c0["errors"] == []
                           and c0["records_changed"] == 1
                           and c0["words_changed"] == 1
                           and c0["fired"] == [["replica.serve_step", None,
                                                "corrupt", 1]]
                           and followed(corrupt)),
        "chaos_kill": (k0["first_exact"] and k0["errors"] == [
            "InjectedFault: chaos kill at scheduler.dispatch"]
            and k0["fired"] == [["scheduler.dispatch", None, "kill", 1]]
            and all(p["ended_by"] == "ABORT" and p["dispatches"] == 1
                    for p in kill[1:])),
        "chaos_kill_bounded": (kill_to_exit is not None
                               and kill_to_exit <= SHARDED_KILL_BOUND_S),
        "lwe_session_exact": lwe[0]["exact"] and lwe[0]["exact_after"],
        "lwe_session_hint": all(p["n_hint_builds"] == 1
                                and p["n_hint_deltas"] == 1 for p in lwe),
        "lwe_session_launches_exact": all(
            p["launches"] == p["want"] and p["plain_calls"] == 0
            for p in lwe),
        "lwe_session_followed": lwe[0]["batches"] == 2 and followed(lwe, 1),
        "batch_session_exact": bat[0]["exact"],
        "batch_session_dispatch_log": all(p["dispatch_log"] == [[1, 512]]
                                          for p in bat),
        "batch_session_launches_exact": all(
            p["dpxor_launches"] == p["want_launches"]
            and p["plain_calls"] == 0 for p in bat),
        "batch_session_followed": bat[0]["batches"] == 1 and followed(bat)}
    summary = {
        name: {"seconds": [p["seconds"] for p in part],
               "latency_median_s": part[0].get("latency_median_s"),
               "records_per_s": part[0].get("records_per_s"),
               "bucket_counts": part[0].get("bucket_counts"),
               "channel_s_per_dispatch": (part[0]["channel_s"]["DISPATCH"]
                                          / part[0]["sent"]["DISPATCH"]),
               "follower_dispatches": [p["dispatches"] for p in part[1:]]}
        for name, part in parts.items()}
    summary["chaos"] = {"seconds": [c0["seconds"], k0["seconds"]],
                        "kill_to_last_exit_s": kill_to_exit,
                        "kill_bound_s": SHARDED_KILL_BOUND_S}
    summary["peak_device_bytes"] = [r["peak_device_bytes"] for r in ranks]
    return checks, summary


def sharded_fleet_checks(ranks, card) -> tuple:
    """The fleet part's checks over every rank's results, and its line:
    records exact (the controller raises otherwise), each rank's launches
    those its replicas' dispatched batches call for with no plain call,
    every follower's dispatches the controller's DISPATCH commands, the
    killed replica's followers gone by ABORT and the others' by STOP;
    scenario B's corrupt one word of one record's answer share, detected
    (an IntegrityError for each query of the batch) and recovered. The
    line: the load's records/s and median batch latency, a reply's time on
    the channel (send to arrival, median over r1's answers), the seconds
    from the kill to r0's followers leaving its session (and of the kill
    call itself, which runs the failovers of its pending queries), the
    rejoin's, and each rank's peak device memory."""
    fleets = [r["fleet"] for r in ranks]
    ctl = fleets[0]
    reps = ctl["replicas"]
    followed_ok, ends = True, {}
    for rank, fleet in enumerate(fleets[1:], start=1):
        for f in fleet["followed"]:
            label, mesh, ended_by = FLEET_REPLICAS[f["serial"] - 1]
            ends.setdefault(label, []).append(f["t_end"])
            followed_ok &= (rank in ranks[0]["fleet"]["meshes"][mesh][1]
                            and f["dispatches"] == reps[label]["dispatched"]
                            and f["ended_by"] == ended_by
                            and f["exc"] is None and f["epoch"] == 1)
    held = sorted(len(f["followed"]) for f in fleets[1:])
    # the killed session's last act is its ABORT: its followers leave last
    kill_to_last_exit = max(ends["A"]) - ctl["kill"]["t_kill"]
    chaos = ctl["chaos"]
    chaos_followers = [f for fleet in fleets[1:]
                       for f in fleet["chaos"]["followed"]]
    checks = {
        "fleet_meshes": ctl["meshes"] == [[[1, 2], [0, 1], 0],
                                          [[1, 2], [2, 3], 0]],
        "fleet_launches_exact": all(
            fleet["launches"] == ctl["want_launches"][str(rank)]
            and fleet["plain_calls"] == 0
            for rank, fleet in enumerate(fleets)),
        "fleet_followers_dispatched": followed_ok and held == [1, 1, 2],
        "fleet_handed_off": ctl["leave"]["handed_off"] == FLEET_LEAVE_QUERIES,
        "fleet_chaos_one_record": (
            chaos["fired"] == ["corrupt"] and chaos["suspects"] == ["r0"]
            and chaos["integrity_failures"] == 4
            and chaos["changed"] == [[1, 1]]
            and len(chaos_followers) == 3
            and sorted(f["ended_by"] for f in chaos_followers)
            == ["ABORT", "STOP", "STOP"])}
    reply = reps["B"]["reply_s"]
    line = {"phase": "sharded_fleet", "card": card,
            "note": "four ranks time-sliced on one card: not a scaling "
                    "figure",
            "records_per_s": ctl["load"]["records_per_s"],
            "latency_median_s": ctl["load"]["latency_median_s"],
            "load_batches": ctl["load"]["batches"],
            "reply_median_s": float(np.median(reply)) if reply else None,
            "replies": len(reply),
            "reply_wait_s": reps["B"]["reply_wait_s"],
            "kill_to_last_exit_s": kill_to_last_exit,
            "kill_call_s": ctl["kill"]["kill_call_s"],
            "rejoin_s": ctl["rejoin_s"],
            "rejoin_first_bucket_s": ctl["rejoin"]["first_bucket_s"],
            "join_s": ctl["join_s"], "publish_s": ctl["publish_s"],
            "failovers": ctl["kill"]["failovers"],
            "handed_off": ctl["leave"]["handed_off"],
            "dispatched": {k: v["dispatched"] for k, v in reps.items()},
            "launches": [fleet["launches"] for fleet in fleets],
            "peak_device_bytes": [fleet["peak_device_bytes"]
                                  for fleet in fleets],
            "seconds": [fleet["seconds"] for fleet in fleets],
            "chaos_seconds": [fleet["chaos"]["seconds"] for fleet in fleets],
            "checks": checks}
    return checks, line


def phase_sharded(host_db, host_lwe, layout, card) -> dict:
    """A6b's serving path on this card: four ranks (``SHARDED_RANKS``
    processes started with torch.multiprocessing, one FileStore under a
    temporary directory) share it under gloo, the collectives through the
    host. On the (1, 4) and (2, 2) meshes each rank holds its row block of
    PIR_1G and serves xor-dpf-2 through TwoServerPIR(mesh=) at 32 and 1
    queries under both collectives, additive-dpf-2 and xor-dpf-k (k = 3)
    at 32 (gather), then an update of rows in every block; and one
    lwe-simple-1 answer of 32 seeded ciphertexts at PIR_128M_LWE (B5 on
    each block, then the int32 all-reduce) held to one unsharded B5 answer
    on rank 0. Records exact, each rank's counters advanced by exactly one
    launch of its plan's kernel a party and batch with no plain call,
    every rank at the same epoch. On both meshes SingleServerPIR(mesh=)
    serves PIR_128M_LWE (``sharded_lwe_single``: the hint built per block
    and summed, equal to an unsharded build before and after a publish);
    on (1, 4) BatchPIR(mesh=) serves PIR_1G_BATCH from ``layout``, built
    once here (``sharded_batch``). The kernels' times are from four ranks
    time-sliced on one card: not a scaling figure. Returns the line."""
    import torch.multiprocessing as mp
    from repro_torch.configs.pir import PIR_128M_LWE
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro_sharded_")
    try:
        np.save(os.path.join(tmp, "db.npy"), host_db)
        np.save(os.path.join(tmp, "db_lwe.npy"), host_lwe)
        ct = np.random.default_rng(SEED + 505).integers(
            -2 ** 31, 2 ** 31, size=(32, PIR_128M_LWE.n_items),
            dtype=np.int64).astype(np.int32)
        np.save(os.path.join(tmp, "ct.npy"), ct)
        del ct
        save_layout(layout, tmp)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=sharded_rank, args=(r, tmp))
                 for r in range(SHARDED_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        ranks = []
        for r in range(SHARDED_RANKS):
            path = os.path.join(tmp, f"rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {"rank": r, "ok": False,
                               "error": "no result (killed or crashed)"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [r for r in ranks if not r.get("ok")]
    checks = {}
    if not failed:
        batches = [b for r in ranks for m in r["meshes"].values()
                   for b in m["batches"]]
        meshes = [m for r in ranks for m in r["meshes"].values()]
        checks = {
            "records_exact": all(b["exact"] for b in batches)
            and all(m["update_exact"] for m in meshes),
            "launches_exact": all(b["launches_ok"] for b in batches)
            and all(m["lwe"]["launches_ok"] for m in meshes)
            and all(m["update_plain_calls"] == 0 for m in meshes),
            "lwe_exact": all(r["meshes"][t]["lwe"]["exact"]
                             for r in ranks if r["rank"] == 0
                             for t in r["meshes"]),
            "epochs_equal": len({m["epoch"] for m in meshes}) == 1,
            "start_blocks_1x4": sorted(r["meshes"]["1x4"]["start_block"]
                                       for r in ranks)
            == list(range(SHARDED_RANKS))}
        singles = [m["lwe_single"] for m in meshes]
        steps = [p for one in singles
                 for p in (one["query"], one["publish"], one["query_after"])]
        checks.update({
            "lwe_single_exact": all(one["query"]["exact"]
                                    and one["query_after"]["exact"]
                                    for one in singles),
            "lwe_hint_exact": all(one["hint_exact"]
                                  and one["hint_after_exact"]
                                  for one in singles if one["client"]),
            "lwe_hint_deltas": all(one["publish"]["hint_deltas"] == 1
                                   and one["publish"]["epoch"] == 1
                                   for one in singles),
            "lwe_single_launches_exact": all(
                p["launches"] == p["want"] and p["plain_calls"] == 0
                for p in steps)})
        rounds = [rd for r in ranks for rd in r["batch"]["rounds"]]
        checks.update({
            "batch_exact": all(rd["exact"] and rd["epoch"] == rd["want_epoch"]
                               for rd in rounds),
            "batch_dispatch_log": all(rd["dispatch_log"] == [[1, 512]]
                                      for rd in rounds),
            "batch_launches_exact": all(
                rd["dpxor_launches"] == rd["want_launches"]
                and rd["reduces"] == rd["want_reduces"]
                and rd["plain_calls"] == 0 for rd in rounds),
            "batch_publish_every_block": all(
                r["batch"]["publish_blocks"]
                == list(range(SHARDED_BATCH_MESH[1])) for r in ranks)})
        sessions, summary = sharded_session_checks(ranks)
        checks.update(sessions)
        fleet_checks, fleet_line = sharded_fleet_checks(ranks, card)
        checks.update(fleet_checks)
        emit(fleet_line)
    devices = {r.get("device") for r in ranks}
    out = {"phase": "sharded", "card": card,
           "note": "four ranks time-sliced on one card: times are not a "
                   "scaling figure",
           "backend": ranks[0].get("backend"),
           "transport": ranks[0].get("transport"),
           "ranks_per_card": SHARDED_RANKS // max(1, len(devices)),
           "gloo_cuda": ranks[0].get("gloo_cuda"), "checks": checks,
           "sessions": summary if not failed else None,
           "ranks": [{k: r.get(k) for k in ("rank", "device", "ok", "error",
                                            "meshes", "batch",
                                            "peak_device_bytes")}
                     for r in ranks],
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if failed:
        raise AssertionError(
            "sharded: ranks failed: " + "; ".join(
                f"rank {r['rank']}: {r.get('error')}\n"
                f"{r.get('traceback', '')}" for r in failed))
    if not all(checks.values()):
        raise AssertionError(f"sharded: checks failed: {checks}")
    return out


#: the private_lm phase: qwen3-4b at full width and depth (PERF.md §4):
#: the serve step's prefill (two attention chunks) and cached decodes, then
#: private generation through xor-dpf-2 over the padded embedding table
LM_ARCH = "qwen3-4b"
LM_STREAMS = 4
LM_PREFILL = 2048
LM_DECODE = 32
LM_PROMPT = 16
LM_NEW = 16
#: the last decode's float32 logits against a forward over the same tokens
#: (a bf16 model; logits of std about 1.0): at most a quarter of that std.
#: The same code at qwen3-4b's width on the CPU, 2 and 6 layers, differs
#: by 0.031-0.038 (chunked attention rounds its probabilities to bf16
#: before the value product, the decode path keeps them in float32). A
#: stream whose forward top-2 gap is within twice the measured difference
#: is a near-tie: its greedy token must be one of the forward's tokens
#: within that margin of the top; every other stream's must be equal.
LM_LOGIT_TOL = 0.25
#: the kernels at the table's record width: B1 at the solo step's batch,
#: B2 at the decode steps' and the prompt's
LM_DPXOR_QS = (1,)
LM_FUSED_QS = (4, 32)


#: the MoE phases (PERF.md section 4): (arch, layers), each at full width
#: with its depth cut. grok-1-314b 64 -> 4 layers, all MoE, whose decode at
#: LM_STREAMS streams takes the batch-global dispatch (4 x top-2 >= 8
#: experts); deepseek-v3-671b 61 -> 5: the 3 dense layers and 2 MoE, whose
#: decode takes the per-token gather (4 x 8 < 256 experts)
MOE_SERVE = ("grok-1-314b", 4)
MOE_PRIVATE = ("deepseek-v3-671b", 5)
#: the first MoE layer of one decode step: the branch that ran against the
#: other branch on the same bf16 hidden states, |ran - other| <= atol +
#: rtol |other|: four bf16 ulps at the outputs' largest magnitudes (0.3 to
#: 0.5 at these widths; on the CPU the two branches differ by at most
#: 9.8e-4 at deepseek-v3's widths and 0 at grok-1's). No slot can drop:
#: the capacity, 8, is at least the streams
MOE_BRANCH_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
#: the VLM phases (PERF.md section 4): llava-next-34b at full width, each
#: stream 2,880 prefix rows (its n_frontend_tokens) + 1,216 text tokens =
#: train_4k's VLM_SEQ positions. Serving cuts the depth 60 -> 16 (9.84 B
#: parameters, 19.7 GB in bf16); training 60 -> 4 (3.15 B, 6.3 GB), 2
#: sequences in 2 microbatches of 1, so that each microbatch takes its
#: slice of prefix_embeds (the policy's 8 cut with the batch), with the
#: policy's optimizer (launch/dryrun.py ARCH_POLICY: Adafactor)
VLM_SERVE = ("llava-next-34b", 16)
VLM_TRAIN = ("llava-next-34b", 4)
VLM_SEQ = 4096
VLM_TRAIN_BATCH = 2
VLM_TRAIN_OPTIMIZER = ARCH_POLICY[VLM_TRAIN[0]]["opt"]
#: the audio phases (PERF.md section 4): whisper-small uncut (12 + 12
#: layers, full width). Serving at LM_STREAMS streams, each encoder_len =
#: 1,500 seeded frames and LM_PREFILL decoder tokens; training at
#: train_4k's 4,096 decoder tokens behind the 1,500 frames, the global batch
#: of 256 cut to 8 in the policy's 2 microbatches, of 4, with its
#: optimizer (ARCH_POLICY: AdamW)
AUDIO_ARCH = "whisper-small"
AUDIO_TRAIN_BATCH = 8
AUDIO_TRAIN_MICROBATCHES = ARCH_POLICY[AUDIO_ARCH]["micro"]
AUDIO_TRAIN_OPTIMIZER = ARCH_POLICY[AUDIO_ARCH]["opt"]
#: the SSM phases (PERF.md section 4): xlstm-350m uncut (24 blocks, 21
#: mLSTM and 3 sLSTM, d_model 1,024, chunk 256). Serving at LM_STREAMS x
#: LM_PREFILL tokens; long_500k (batch 1) from an init_cache of 524,288
#: positions, a SSM_LONG_PROMPT-token prompt and SSM_LONG_DECODE decodes;
#: training at SSM_TRAIN_LAYERS blocks, train_4k's 4,096 tokens, the
#: global batch of 256 cut to 8 in one microbatch (ARCH_POLICY's 4 cut:
#: the sLSTM's loop over time steps makes a step's launches follow the
#: microbatches), the policy's optimizer (AdamW), one timed step after the
#: warm-up (each step runs the sLSTM's 2 x 4,096 time steps forward, again
#: in the recompute and backward)
SSM_ARCH = "xlstm-350m"
SSM_TRAIN_OPTIMIZER = ARCH_POLICY[SSM_ARCH]["opt"]
SSM_LONG_PROMPT = 256
SSM_LONG_DECODE = 8
SSM_TRAIN_BATCH = 8
#: ssm_train's depth, cut 24 -> 16 blocks (14 mLSTM, 2 sLSTM) when the
#: hybrid's phases needed the time: the sLSTM's loop sets its step
SSM_TRAIN_LAYERS = 16
SSM_TRAIN_TIMED_STEPS = 1
#: the hybrid phases (PERF.md section 4): zamba2-7b at full width. Serving
#: uncut (81 Mamba2 layers, 13 shared invocations) at LM_STREAMS x
#: LM_PREFILL tokens; long_500k (batch 1) cut to HYBRID_LONG_LAYERS (6
#: invocations: 6 KV caches of 524,288 rows are 45.1 GB, 13 would be 97.7
#: GB), a HYBRID_LONG_PROMPT-token prompt and HYBRID_LONG_DECODE decodes;
#: training cut to HYBRID_TRAIN_LAYERS (2 invocations; at full depth the
#: weights and AdamW state alone are 94.5 GB, the step's peak 234.7 GB, by
#: the dry run; at 12 layers it predicts 44.9 GB) at train_4k's 4,096 tokens,
#: the global batch of 256 cut to 8 in ARCH_POLICY's 8 microbatches with
#: its optimizer (AdamW)
HYBRID_ARCH = "zamba2-7b"
HYBRID_LONG_LAYERS = 36
HYBRID_LONG_PROMPT = 256
HYBRID_LONG_DECODE = 8
HYBRID_TRAIN_LAYERS = 12
HYBRID_TRAIN_BATCH = 8
HYBRID_TRAIN_MICROBATCHES = ARCH_POLICY[HYBRID_ARCH]["micro"]
HYBRID_TRAIN_OPTIMIZER = ARCH_POLICY[HYBRID_ARCH]["opt"]
HYBRID_TRAIN_TIMED_STEPS = 1
#: zamba2-7b's last bf16 decode is reported against the forward, not held
#: to LM_LOGIT_TOL: over its 94 blocks at random weights the bf16
#: arithmetic alone parts two passes by more (on the H100 two forwards that
#: differ only in the scan's chunk, 16 and 32, by 0.241, at logits of
#: std 1.198; the bf16 forward lies further still from a float32 one:
#: bf16_forward_vs_float32_forward in the phase's line). The decode's
#: identity is held in float32 instead, at full width and depth, one
#: stream, within HYBRID_F32_TOL (measured 8.1e-5); and the bf16 forward at
#: HYBRID_FLOOR_CHUNK is reported beside the decode's difference, as the
#: bf16 noise floor
HYBRID_F32_TOL = 1e-3
HYBRID_FLOOR_CHUNK = 16


def lm_serve_step(ss, cfg, card, device, phase="private_lm_serve") -> dict:
    """make_serve_step's prefill on the batch its input_structs name, made
    from a seed (LM_STREAMS x LM_PREFILL tokens at private_lm's shape; a
    VLM's streams each a prefix of patch embeddings, normal x 0.02, ahead
    of its text tokens; an audio model's each its frames, normal x 0.02,
    through the encoder), twice (the first call warms the card), and
    LM_DECODE decode steps with write=True (each timed to its
    synchronize). Held: the prefill's last logits against a forward over
    the same prefix and tokens (within LM_LOGIT_TOL: an identity in the
    reference) and, for the dense, VLM, audio and SSM families, the last
    decode's logits against a forward over every position, the decoded
    ones included (within LM_LOGIT_TOL, greedy tokens equal but for
    near-ties; an SSM forward at :func:`ssm_chunk_for`'s chunk). The
    cache's bytes are reported (an SSM's: its recurrent state). For MoE
    that second difference and the slots the forwards' dispatch
    dropped are reported, not held (a decode step never drops a slot, the
    forward's capacity may), and the first MoE layer's two branches are
    held against each other (:func:`moe_branch_check`). For the hybrid
    the bf16 decode's difference is reported beside the bf16 forward's own
    at HYBRID_FLOOR_CHUNK, and the decode's identity is held in float32
    (:func:`hybrid_f32_decode`, within HYBRID_F32_TOL) with the greedy
    tokens."""
    moe = cfg.moe is not None
    structs = ss.input_structs
    streams, text = structs["tokens"].shape
    gen = torch.Generator(device).manual_seed(SEED + 401)
    tokens = torch.randint(0, cfg.vocab, (streams, text + LM_DECODE),
                           generator=gen, device=device)
    batch = {"tokens": tokens[:, :text]}
    # the family's side input: a VLM's prefix rows take decoder positions,
    # an audio model's frames go through the encoder and take none
    side = next((k for k in structs if k != "tokens"), None)
    prefix = None
    if side is not None:
        spec = structs[side]
        prefix = (torch.randn(spec.shape, generator=gen, device=device)
                  * 0.02).to(spec.dtype)
        batch[side] = prefix
    n_prefix = prefix.shape[1] if side == "prefix_embeds" else 0
    total = n_prefix + text + LM_DECODE
    prefill_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = ss.prefill(batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    pre_got = logits[:, :cfg.vocab].clone()
    first_ok = bool(torch.isfinite(pre_got).all())
    decode_s = []
    for i in range(LM_DECODE):
        t0 = time.perf_counter()
        logits, cache = ss.decode(cache, tokens[:, text + i:text + i + 1])
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    length = int(cache.length)
    state_bytes = (cache.nbytes() if cfg.family == "ssm" else
                   sum(t.numel() * t.element_size() for t in cache
                       if t.dim()))
    # a hybrid's decode state a stream: the Mamba states, which do not
    # grow, and the shared block's KV caches, which do
    parts = (None if cfg.family != "hybrid" else
             {k: v // streams for k, v in hybrid_bytes(cache).items()})
    trace = lm_decode_trace(ss.model, cache, tokens[:, -1:])
    branch = moe_branch_check(ss.model, cache, tokens[:, -1:]) if moe \
        else None
    del cache
    t0 = time.perf_counter()
    pre_want, pre_dropped = last_logits(ss.model, batch["tokens"], prefix)
    # an SSM forward holds one stream's state, not its attention scores:
    # all streams in one pass. So does a hybrid's: its 13 shared-block
    # invocations hold one [4, 32, 2,080, 2,080] float32 score block (2.2
    # GB) at a time, and one pass launches a quarter of the Mamba loop's
    # kernels at chunk 32
    want, dropped = last_logits(ss.model, tokens, prefix,
                                per_stream=cfg.family not in ("ssm",
                                                              "hybrid"))
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    pre_diff = float((pre_got - pre_want).abs().max())
    got = logits[:, :cfg.vocab]
    diff = float((got - want).abs().max())
    hybrid = cfg.family == "hybrid"
    if hybrid:
        # the bf16 noise floor, and the decode's identity in float32
        with at_chunk(ss.model, HYBRID_FLOOR_CHUNK):
            floor_want, _ = last_logits(ss.model, tokens)
        floor = float((floor_want - want).abs().max())
        del floor_want
        f32, f32_want = hybrid_f32_decode(cfg, tokens[:1], text, device)
        # how far the bf16 forward itself lies from the float32 one
        f32["bf16_forward_vs_float32_forward"] = float(
            (want[:1] - f32_want).abs().max())
    top2 = want.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    g_tok, w_tok = got.argmax(-1).tolist(), want.argmax(-1).tolist()
    margin = 2 * diff
    near = [i for i, g in enumerate(gaps) if g <= margin]
    greedy_ok = all(
        g_tok[i] == w_tok[i] if i not in near
        else float(want[i, g_tok[i]]) >= float(top2[i, 0]) - margin
        for i in range(streams))
    dec = float(np.median(decode_s))
    out = {"phase": phase, "card": card, "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "streams": streams,
           "prefill_tokens": text, "prefix_rows": n_prefix,
           "side_input": side,
           "side_rows": None if prefix is None else prefix.shape[1],
           "decode_steps": LM_DECODE, "prefill_s": prefill_s,
           # every position the prefill runs, a prefix row included
           "prefill_tokens_per_s": streams * (n_prefix + text)
           / prefill_s[-1],
           "decode_ms_per_token": dec * 1e3,
           "decode_ms_runs": [t * 1e3 for t in decode_s],
           "decode_tokens_per_s": streams / dec, "forward_s": forward_s,
           "cache_length": length, "cache_bytes": state_bytes,
           "cache_bytes_per_stream": parts,
           "logits_finite": first_ok and bool(
               torch.isfinite(got).all()),
           "prefill_max_abs_diff_vs_forward": pre_diff,
           "max_abs_diff_vs_forward": diff, "tolerance": LM_LOGIT_TOL,
           "decode_vs_forward_held": not (moe or hybrid),
           "logit_std": float(want.std()), "greedy_decode": g_tok,
           "greedy_forward": w_tok, "top2_gaps": gaps, "near_ties": near,
           "greedy_equal": sum(a == b for a, b in zip(g_tok, w_tok)),
           "greedy_ok": greedy_ok, "decode_trace": trace}
    if moe:
        out.update(moe_branch=branch, dropped_slots_prefill=pre_dropped,
                   dropped_slots_forward=dropped)
    if hybrid:
        out.update(forward_chunk_noise_max_abs_diff=floor,
                   forward_chunks=(math.gcd(total, cfg.ssm.chunk),
                                   HYBRID_FLOOR_CHUNK),
                   float32_decode=f32)
    emit(out)
    if moe:
        decode_ok = branch["ok"]
    elif hybrid:
        decode_ok = (f32["max_abs_diff_vs_forward"] <= HYBRID_F32_TOL
                     and greedy_ok)
    else:
        decode_ok = diff <= LM_LOGIT_TOL and greedy_ok
    held = (out["logits_finite"] and length == total
            and pre_diff <= LM_LOGIT_TOL and decode_ok)
    if not held:
        raise AssertionError(f"{phase}: {out}")
    return out


def hybrid_bytes(cache) -> dict:
    """A HybridCache's bytes: the Mamba layers' conv tails and SSD states
    ("mamba", whatever the capacity) and the shared block's KV caches
    ("kv", 2 g C KV hd x the element size)."""
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    return {"mamba": size(cache.conv, cache.state),
            "kv": size(cache.attn_k, cache.attn_v)}


def last_logits(model, tokens, prefix=None, *,
                per_stream: bool = False) -> tuple:
    """The forward's last-position logits ``[B, vocab]`` over ``tokens``
    with ``prefix`` (a VLM's patch embeddings, an audio model's frames,
    given as its alias ``prefix_embeds``, or None) and the slots
    its MoE layers' dispatch dropped (a pre-hook on each MoE FFN counts
    them). ``per_stream`` runs one forward per stream: the same function
    (attention and the MoE dispatch are per sequence) in a quarter of the
    memory. At 2,080 or 4,128 positions, not a multiple of the 1,024
    attention chunk, one block spans the sequence: deepseek-v3's 128 heads
    at 4 streams would make 8.25 GiB float32 score tensors. An SSM model
    runs at :func:`ssm_chunk_for`'s chunk."""
    from repro_torch.models import moe as M
    if per_stream:
        groups = zip(tokens.split(1), (None,) * len(tokens) if prefix is None
                     else prefix.split(1))
    else:
        groups = ((tokens, prefix),)
    last = []
    with at_moe_inputs(model, M.dropped_slots) as dropped, \
            ssm_chunk_for(model, tokens.shape[1]):
        for group, pre in groups:
            full, _ = model.forward(group, prefix_embeds=pre)
            last.append(full[:, -1, :model.cfg.vocab].clone())
            del full
    return torch.cat(last), sum(dropped)


@contextlib.contextmanager
def at_chunk(model, chunk: int):
    """Inside the block an SSM or hybrid model's scans run at ``chunk``
    (its config swapped for the block)."""
    cfg = model.cfg
    model.cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=chunk))
    try:
        yield
    finally:
        model.cfg = cfg


@contextlib.contextmanager
def ssm_chunk_for(model, n: int):
    """Inside the block an SSM or hybrid model's passes over ``n``
    positions run at the largest chunk that divides both n and the
    config's chunk (its config swapped for the block): ssd_scan raises
    unless the chunk divides the length, as the reference's, and 2,080
    positions are no multiple of xlstm's or zamba2's 256 (2,080 = 65 x
    32). The chunk changes how the scan groups its sums, not the function.
    Other models run as they are."""
    cfg = model.cfg
    if cfg.ssm is None or n % min(cfg.ssm.chunk, n) == 0:
        yield
        return
    with at_chunk(model, math.gcd(n, cfg.ssm.chunk)):
        yield


def hybrid_f32_decode(cfg, tokens, text: int, device) -> tuple:
    """The serve path's decode identity in float32: ``cfg`` (zamba2-7b at
    full width and depth) with dtype float32, its weights drawn from the
    serve phase's seed (27 GB), on ``tokens`` [1, text + LM_DECODE]: a
    prefill over ``text`` tokens, LM_DECODE decodes with write=True, the
    last logits against a forward over all the tokens at
    :func:`ssm_chunk_for`'s chunk. Returns (the difference and seconds,
    the float32 forward's last logits); everything else is freed before
    it returns."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(replace(cfg, dtype="float32"), device=device)
    model.init_params(torch.Generator(device).manual_seed(SEED + 400))
    _, cache = model.prefill(tokens[:, :text],
                             capacity=tokens.shape[1])
    for i in range(text, tokens.shape[1]):
        logits, cache = model.decode(cache, tokens[:, i:i + 1], write=True)
    got = logits[:, :cfg.vocab].clone()
    del cache
    want, _ = last_logits(model, tokens)
    diff = float((got - want).abs().max())
    del model
    release()
    return {"streams": tokens.shape[0], "max_abs_diff_vs_forward": diff,
            "tolerance": HYBRID_F32_TOL, "logit_std": float(want.std()),
            "seconds": time.perf_counter() - t0}, want


@contextlib.contextmanager
def at_moe_inputs(model, fn):
    """Yield a list that gets ``fn(params, cfg, x)`` of each MoE layer's
    input ``x`` on every forward inside the ``with`` block (a pre-hook on
    each MoE FFN, removed at its end; an encoder-decoder has none)."""
    seen = []
    hooks = [b.ffn.register_forward_pre_hook(
        lambda mod, args: seen.append(fn(mod.params(), mod.cfg, args[0])))
        for b in getattr(model, "moe_layers", ())]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def moe_branch_check(model, cache, tokens) -> dict:
    """One decode step (write=False, on the full cache) with the first MoE
    layer's FFN input captured: the branch moe_apply ran there (batch-
    global dispatch where streams x top_k >= experts, else the per-token
    gather) against the other branch on the same hidden states, within
    MOE_BRANCH_TOL, with no slot dropped."""
    from repro_torch.models import moe as M
    cfg = model.cfg
    ffn = model.moe_layers[0].ffn
    seen = []
    hook = ffn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        model.decode(cache, tokens, write=False)
    finally:
        hook.remove()
    h = seen[0]                                             # [B, 1, d]
    b, _, d = h.shape
    params = ffn.params()
    with torch.no_grad():
        ran, _ = ffn(h)
        via_dispatch = M.moe_apply_dispatch(params, cfg, h.reshape(
            1, b, d))[0].reshape(b, 1, d)
        via_gather, _ = M.moe_apply_gather(params, cfg, h)
    branch = ("dispatch" if b * cfg.moe.top_k >= cfg.moe.n_experts
              else "gather")
    ran_as, other = ((via_dispatch, via_gather) if branch == "dispatch"
                     else (via_gather, via_dispatch))
    diff = (ran.float() - other.float()).abs()
    tol = MOE_BRANCH_TOL
    within = bool((diff <= tol["atol"] + tol["rtol"]
                   * other.float().abs()).all())
    dropped = M.dropped_slots(params, cfg, h.reshape(1, b, d))
    return {"branch": branch, "ran_equals_branch": torch.equal(ran, ran_as),
            "max_abs_diff": float(diff.max()),
            "max_abs_out": float(other.float().abs().max()),
            "tolerance": tol, "dropped": dropped,
            "ok": within and dropped == 0}


def lm_decode_trace(model, cache, tokens) -> dict:
    """One decode step (write=False, on the full cache) under
    torch.profiler after an untraced one: wall, device busy time (the union
    of CUDA kernel and copy intervals), the device's idle share, the
    number of device events, and the kernels with the most device time.
    The profiler's own host cost per op is inside the wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.serve_trace import device_intervals, union_us
    model.decode(cache, tokens, write=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode(cache, tokens, write=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev = device_intervals(prof)
    busy_s = union_us(dev) / 1e6
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
            "device_idle_share": 1 - busy_s / wall_s if dev else None,
            "device_events": len(dev),
            "top_kernels": [{"name": n[:80], "device_ms": us / 1e3}
                            for n, us in top]}


def lm_private(model, cfg, card, phase="private_lm") -> tuple:
    """The private_inference twin on the model: LM_STREAMS streams, an
    LM_PROMPT-token prompt, LM_NEW new tokens, every embedding retrieved
    through TwoServerPIR over the padded table (prompt lookups in buckets
    of 32, each step's LM_STREAMS in a bucket of 4: B2; one step for a
    stream alone: B1). Rows bit-exact and tokens equal to the same loop on
    plain lookups (the twin raises otherwise). The counters are zeroed
    inside (before the lookups) and read right after."""
    from repro_torch import private_inference as pi
    from repro_torch.core.protocol import plan_for
    prompt = np.random.default_rng(SEED + 402).integers(
        0, cfg.vocab, (LM_STREAMS, LM_PROMPT))
    t0 = time.perf_counter()
    res = pi.run(model=model, tokens=LM_NEW, streams=LM_STREAMS,
                 prompt=prompt, seed=SEED + 403, verbose=False)
    seconds = time.perf_counter() - t0
    launches = main_path_launches(phase, ("dpxor", "fused_scan_xor"))
    calls = res["pir_calls"]
    steps = res["steps"][1:]            # the decode steps (prompt apart)
    shares = [s["embed_s"] / (s["embed_s"] + s["trunk_s"]) for s in steps]
    pir_cfg = lm_table_config(cfg)
    plans = {}
    for q in (1, LM_STREAMS, 32):
        plan = plan_for(pir_cfg, q, backend="cuda")
        plans[str(q)] = {"name": plan.name, "chunk_log": plan.chunk_log,
                         "tile_r": plan.tile_r}
    out = {"phase": phase, "card": card, "arch": cfg.name,
           "table_rows": pir_cfg.n_items, "record_bytes": pir_cfg.item_bytes,
           "table_bytes": pir_cfg.db_bytes, "streams": LM_STREAMS,
           "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "queries": res["queries"], "prefix_rows": res["prefix_rows"],
           "rows_exact": res["rows_exact"],
           "plain_equal": res["plain_equal"],
           "tokens": res["streams"], "solo_token": res["solo_token"],
           "setup_s": res["setup_s"],
           "pir_prompt_s": calls[0]["seconds"],
           "pir_prompt_batches": -(-calls[0]["queries"] // 32),
           "pir_step_s": [c["seconds"] for c in calls[1:-1]],
           "pir_step_s_median": float(np.median(
               [c["seconds"] for c in calls[1:-1]])),
           "pir_solo_s": calls[-1]["seconds"],
           "trunk_step_s_median": float(np.median(
               [s["trunk_s"] for s in steps])),
           "pir_share_per_token": shares,
           "pir_share_median": float(np.median(shares)),
           "plans": plans, "launches": launches, "seconds": seconds}
    emit(out)
    return out, launches


def lm_table_config(cfg):
    """The PIR database the private lookups serve: the padded table."""
    from repro_torch import private_inference as pi
    from repro_torch.config import PIRConfig
    return PIRConfig(n_items=pi.padded_rows(cfg.vocab),
                     item_bytes=cfg.d_model * 2, batch_queries=32)


def lm_kernels(model, cfg, card, device, phase="private_lm_kernels"
               ) -> dict:
    """B1 and B2 on the padded table's words ([2^18, 1280] at qwen3-4b,
    [2^17, 3584] at deepseek-v3-671b, [2^16, 3584] at llava-next-34b,
    [2^16, 384] at whisper-small, [2^16, 512] at xlstm-350m, [2^15, 1792]
    at zamba2-7b; each launch's
    device time alone beside
    the CUDA events', :func:`kernel_device_ms`) at
    the path's batches, each against
    its plain version on the same inputs (max_abs_err 0), then timed by
    CUDA events beside its bound and the
    plain version (B2's plain version by the host clock over its one
    checking run, seconds long). Returns each kernel's largest error and
    timings."""
    from repro_torch import private_inference as pi
    from repro_torch.core import dpf
    from repro_torch.core.protocol import plan_for
    from repro_torch.kernels import build, dpxor as kd, fused_scan as kf
    from repro_torch.kernels import ops
    db = pi.table_as_words(pi.padded_table(model))
    rows, words = db.shape
    lg = (rows - 1).bit_length()
    pir_cfg = lm_table_config(cfg)
    rng = np.random.default_rng(SEED + 404)
    gen = torch.Generator(device=device).manual_seed(SEED + 405)
    out = {"phase": phase, "card": card, "rows": rows,
           "words": words, "dpxor": {}, "fused_scan_xor": {}}
    worst = {"dpxor": 0, "fused_scan_xor": 0}
    for q in LM_DPXOR_QS:
        bits = torch.randint(0, 2, (q, rows), generator=gen, device=device,
                             dtype=torch.int32)
        got, want = kd.dpxor(db, bits), kd.dpxor_plain(db, bits)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst["dpxor"] = max(worst["dpxor"], err)
        bound = dpxor_bound_ms(rows, words, q)
        ms = cuda_time_ms(lambda: kd.dpxor(db, bits), reps=20)
        dev = kernel_device_ms(lambda: kd.dpxor(db, bits), "dpxor")
        dev_ms = dev["ms"]
        out["dpxor"][str(q)] = {
            "max_abs_err": err, "ms": ms,
            "plain_ms": cuda_time_ms(lambda: kd.dpxor_plain(db, bits), 3),
            "bound_ms": bound, "bound_by": "bytes",
            "share_of_bound": bound / ms, "kernel_device_ms": dev_ms,
            "kernel_records": dev["records"],
            "kernel_launches": dev["launches"],
            "kernel_share_of_bound": bound / dev_ms if dev_ms else None}
    for q in LM_FUSED_QS:
        plan = plan_for(pir_cfg, q, backend="cuda")
        _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log, lg))
        keys = dpf.gen_keys_batch(rng, rng.integers(0, rows, size=q),
                                  lg)[q % 2].to(device)
        inputs = fused_inputs(keys, 0, lg, clog)
        # the plain version takes seconds at Q = 32: its one run is timed
        plain_s, want = host_time_s(lambda: kf.fused_scan_xor_plain(
            db, *inputs, rounds=keys.rounds), sync=True)
        got = kf.fused_scan_xor(db, *inputs, rounds=keys.rounds)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst["fused_scan_xor"] = max(worst["fused_scan_xor"], err)
        bound, by = fused_xor_bound(rows, words, q, clog, keys.rounds)
        ms = cuda_time_ms(lambda: kf.fused_scan_xor(
            db, *inputs, rounds=keys.rounds), reps=5)
        dev = kernel_device_ms(lambda: kf.fused_scan_xor(
            db, *inputs, rounds=keys.rounds), "fused_scan_xor", reps=5)
        dev_ms = dev["ms"]
        instance = kf.instance_xor(words, queries=q)
        ptxas = next((v for k, v in build.ptxas_report(
            "fused_scan_xor").items() if instance in k), {})
        # the select-XOR's own Q R W operations (one LOP3 per query and
        # word), outside the bound, beside it
        select_ops = q * rows * words
        out["fused_scan_xor"][str(q)] = {
            "clog": clog, "instance": instance,
            "registers": ptxas.get("registers"),
            "spill_stores": ptxas.get("spill_stores"),
            "grid": kf.wide_geometry(words, q, rows >> clog, clog),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
            "kernel_device_ms": dev_ms, "kernel_records": dev["records"],
            "kernel_launches": dev["launches"],
            "kernel_share_of_bound": bound / dev_ms if dev_ms else None,
            "select_ops": select_ops,
            "select_ms": select_ops / INT32_OPS_PER_S * 1e3}
    out["worst"] = worst
    emit(out)
    if any(worst.values()):
        raise AssertionError(f"{phase}: kernels differ from their plain "
                             f"versions at {words} words: {worst}")
    return out


def phase_lm(arch, card, device, *, phase="private_lm", layers=None,
             private=True, seq_len=LM_PREFILL) -> tuple:
    """``arch`` FULL on the card (``layers`` cuts its depth, every width
    as published), its weights drawn from a seeded generator there: the
    serve step at LM_STREAMS x ``seq_len`` positions
    (:func:`lm_serve_step`; the kernel counters zeroed before it and read
    after: none of the six launched), then with ``private`` private
    generation through xor-dpf-2 over the padded table
    (:func:`lm_private`; the counters zeroed before and read after: B1 and
    B2 launched, no plain call) and B1 and B2 at the table's width against
    their plain versions (:func:`lm_kernels`).
    Everything is freed before it returns (worst errors, launches of the
    private lookups). private_lm: qwen3-4b at full depth; moe_serve and
    private_moe: the MoE archs at MOE_SERVE's and MOE_PRIVATE's depth;
    vlm_serve: llava-next-34b at VLM_SERVE's depth and VLM_SEQ positions;
    audio_serve: whisper-small uncut, LM_PREFILL decoder tokens behind
    its encoder_len frames; ssm_serve: xlstm-350m uncut; hybrid_serve:
    zamba2-7b uncut."""
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_serve_step
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    shape = ShapeConfig(name=f"prefill_{seq_len}", seq_len=seq_len,
                        global_batch=LM_STREAMS, kind="prefill")
    t0 = time.perf_counter()
    ss = make_serve_step(cfg, shape, device=device, decode_write=True,
                         capacity=seq_len + LM_DECODE)
    model = ss.model.init_params(torch.Generator(device).manual_seed(
        SEED + 400))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ops.reset_counts()
    serve = lm_serve_step(ss, cfg, card, device, phase=f"{phase}_serve")
    serve_counts = ops.counts()
    if any(v["launches"] or v["plain_calls"] for v in serve_counts.values()):
        raise AssertionError(f"{phase}: the serve step ran a PIR kernel or "
                             f"its plain version: {serve_counts}")
    out = {"phase": f"{phase}_done", "card": card, "arch": cfg.name,
           "layers": cfg.n_layers, "init_s": init_s, "params": n_params,
           "n_params_config": cfg.n_params(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "prefill_s": serve["prefill_s"][-1],
           "decode_ms_per_token": serve["decode_ms_per_token"]}
    worst, launches = {}, {}
    if private:
        priv, launches = lm_private(model, cfg, card, phase)
        worst = lm_kernels(model, cfg, card, device,
                           phase=f"{phase}_kernels")["worst"]
        out.update(pir_share_median=priv["pir_share_median"],
                   launches=launches)
    out.update(peak_device_bytes=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t_phase)
    del ss, model
    release()
    emit(out)
    return worst, launches


def phase_ssm_long(card, device) -> dict:
    """The long_500k cell that xlstm-350m runs (cell_is_skipped is false
    for the archs of LONG_CONTEXT_ARCHS, xlstm-350m and zamba2-7b, and
    true for every other; phase_hybrid_long runs zamba2's): its serve step
    at batch
    1, the decode state from init_cache(1, 524,288) (its bytes those at
    capacity LM_PREFILL: the state does not grow), a SSM_LONG_PROMPT-token
    prompt prefilled, then SSM_LONG_DECODE decode steps through the step
    from the prompt's state and from the long cache, each timed to its
    synchronize. Held: the bytes equal, every logit finite, the long
    cache's first decode bit-equal to the one from a capacity-LM_PREFILL
    cache, and the prompt's decodes within LM_LOGIT_TOL of a forward over
    the prompt and the decoded tokens."""
    from repro_torch.configs import (ARCHS, LONG_CONTEXT_ARCHS, SHAPES,
                                     cell_is_skipped, get_arch)
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_serve_step
    t_phase = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    skipped = {a: cell_is_skipped(a, "long_500k") for a in ARCHS}
    if SSM_ARCH not in LONG_CONTEXT_ARCHS or skipped != {
            a: a not in LONG_CONTEXT_ARCHS for a in ARCHS}:
        raise AssertionError(f"ssm_long: cell_is_skipped {skipped}")
    cfg, shape = get_arch(SSM_ARCH), SHAPES["long_500k"]
    ss = make_serve_step(cfg, shape, device=device)
    model = ss.model.init_params(torch.Generator(device).manual_seed(
        SEED + 600))
    gen = torch.Generator(device).manual_seed(SEED + 601)
    tokens = torch.randint(0, cfg.vocab, (1, SSM_LONG_PROMPT
                                          + SSM_LONG_DECODE),
                           generator=gen, device=device)
    long_cache = model.init_cache(shape.global_batch, shape.seq_len)
    short_cache = model.init_cache(shape.global_batch, LM_PREFILL)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill(tokens[:, :SSM_LONG_PROMPT])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    runs = {}
    for name, c in (("prompt", cache), ("long", long_cache)):
        times, finite = [], True
        for i in range(SSM_LONG_DECODE):
            step = tokens[:, SSM_LONG_PROMPT + i:SSM_LONG_PROMPT + i + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, c = ss.decode(c, step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            finite &= bool(torch.isfinite(logits).all())
        runs[name] = {"decode_s": times, "finite": finite,
                      "last": logits[:, :cfg.vocab].clone(),
                      "length": int(c.length)}
    step0 = tokens[:, SSM_LONG_PROMPT:SSM_LONG_PROMPT + 1]
    first_long, _ = ss.decode(long_cache, step0)
    first_short, _ = ss.decode(short_cache, step0)
    want, _ = last_logits(model, tokens)
    diff = float((runs["prompt"]["last"] - want).abs().max())
    counts = ops.counts()
    out = {"phase": "ssm_long", "card": card, "arch": cfg.name,
           "shape": shape.name, "seq_len": shape.seq_len,
           "batch": shape.global_batch, "cell_is_skipped": skipped,
           "state_bytes_at_seq_len": long_cache.nbytes(),
           "state_bytes_at_prefill": short_cache.nbytes(),
           "state_bytes_after_prompt": cache.nbytes(),
           "prompt_tokens": SSM_LONG_PROMPT, "prefill_s": prefill_s,
           "decode_steps": SSM_LONG_DECODE,
           "decode_ms_per_token": {k: float(np.median(v["decode_s"])) * 1e3
                                   for k, v in runs.items()},
           "decode_ms_runs": {k: [t * 1e3 for t in v["decode_s"]]
                              for k, v in runs.items()},
           "lengths": {k: v["length"] for k, v in runs.items()},
           "logits_finite": all(v["finite"] for v in runs.values()),
           "long_equals_short_cache": torch.equal(first_long, first_short),
           "max_abs_diff_vs_forward": diff, "tolerance": LM_LOGIT_TOL,
           "pir_kernel_calls": {k: v["launches"] + v["plain_calls"]
                                for k, v in counts.items()},
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    del ss, model, cache, long_cache, short_cache
    release()
    emit(out)
    if not (out["state_bytes_at_seq_len"] == out["state_bytes_at_prefill"]
            == out["state_bytes_after_prompt"] and out["logits_finite"]
            and out["long_equals_short_cache"] and diff <= LM_LOGIT_TOL
            and not any(out["pir_kernel_calls"].values())):
        raise AssertionError(f"ssm_long: {out}")
    return out


def phase_hybrid_long(card, device) -> dict:
    """The long_500k cell of zamba2-7b at batch 1, its depth cut to
    HYBRID_LONG_LAYERS (every width as published): a HYBRID_LONG_PROMPT-
    token prompt prefilled into KV caches of 524,288 rows, then
    HYBRID_LONG_DECODE decodes with write=True through the serve step, each
    timed to its synchronize. Held: cell_is_skipped false for the arch,
    the Mamba states' bytes equal to those of a prefill at capacity
    LM_PREFILL, the KV caches' bytes 2 g C KV hd 2 B, every logit finite,
    the last decode within LM_LOGIT_TOL of a forward over the prompt and
    the decoded tokens, no PIR kernel run. Reported: the first decode's
    difference from the one on the capacity-LM_PREFILL cache (and whether
    it is bit-equal), the peak device memory."""
    from repro_torch.configs import SHAPES, cell_is_skipped, get_arch
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_serve_step
    t_phase = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    if cell_is_skipped(HYBRID_ARCH, "long_500k"):
        raise AssertionError("hybrid_long: zamba2-7b skips long_500k")
    full, shape = get_arch(HYBRID_ARCH), SHAPES["long_500k"]
    cfg = replace(full, n_layers=HYBRID_LONG_LAYERS)
    ss = make_serve_step(cfg, shape, device=device, decode_write=True,
                         capacity=shape.seq_len)
    model = ss.model.init_params(torch.Generator(device).manual_seed(
        SEED + 700))
    gen = torch.Generator(device).manual_seed(SEED + 701)
    n = HYBRID_LONG_PROMPT + HYBRID_LONG_DECODE
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, n),
                           generator=gen, device=device)
    prompt = tokens[:, :HYBRID_LONG_PROMPT]
    step0 = tokens[:, HYBRID_LONG_PROMPT:HYBRID_LONG_PROMPT + 1]
    ops.reset_counts()
    _, short = model.prefill(prompt, capacity=LM_PREFILL)
    short_bytes = hybrid_bytes(short)
    first_short, _ = model.decode(short, step0, write=True)
    del short
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill(prompt, capacity=shape.seq_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    long_bytes = hybrid_bytes(cache)
    times, finite, first_long = [], True, None
    for i in range(HYBRID_LONG_DECODE):
        step = tokens[:, HYBRID_LONG_PROMPT + i:HYBRID_LONG_PROMPT + i + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = ss.decode(cache, step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(logits).all())
        if first_long is None:
            first_long = logits.clone()
    length = int(cache.length)
    got = logits[:, :cfg.vocab].clone()
    del cache
    release()
    want, _ = last_logits(model, tokens)
    diff = float((got - want).abs().max())
    first_diff = float((first_long - first_short).abs().max())
    counts = ops.counts()
    hd = cfg.resolved_head_dim
    kv_want = (2 * model.n_groups * shape.seq_len * cfg.n_kv_heads * hd
               * 2 * shape.global_batch)
    out = {"phase": "hybrid_long", "card": card, "arch": cfg.name,
           "layers": cfg.n_layers, "layers_config": full.n_layers,
           "shared_invocations": model.n_groups,
           "params": sum(p.numel() for p in model.parameters()),
           "shape": shape.name, "seq_len": shape.seq_len,
           "batch": shape.global_batch,
           "mamba_bytes_at_seq_len": long_bytes["mamba"],
           "mamba_bytes_at_prefill": short_bytes["mamba"],
           "kv_bytes_at_seq_len": long_bytes["kv"],
           "kv_bytes_want": kv_want,
           "kv_bytes_at_prefill": short_bytes["kv"],
           "prompt_tokens": HYBRID_LONG_PROMPT, "prefill_s": prefill_s,
           "decode_steps": HYBRID_LONG_DECODE,
           "decode_ms_per_token": float(np.median(times)) * 1e3,
           "decode_ms_runs": [t * 1e3 for t in times], "length": length,
           "logits_finite": finite,
           "first_decode_vs_short_cache_max_abs_diff": first_diff,
           "first_decode_bit_equal": torch.equal(first_long, first_short),
           "max_abs_diff_vs_forward": diff, "tolerance": LM_LOGIT_TOL,
           "pir_kernel_calls": {k: v["launches"] + v["plain_calls"]
                                for k, v in counts.items()},
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    del ss, model
    release()
    emit(out)
    if not (long_bytes["mamba"] == short_bytes["mamba"]
            and long_bytes["kv"] == kv_want and finite and length == n
            and diff <= LM_LOGIT_TOL
            and not any(out["pir_kernel_calls"].values())):
        raise AssertionError(f"hybrid_long: {out}")
    return out


# -- the training half ----------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_SEQ = 4096            # train_4k's sequence length
TRAIN_BATCH = 4             # train_4k's global batch of 256, cut to 4
# the policy's 4 microbatches (one sequence each) and optimizer (AdamW)
TRAIN_MICROBATCHES = ARCH_POLICY[TRAIN_ARCH]["micro"]
TRAIN_OPTIMIZER = ARCH_POLICY[TRAIN_ARCH]["opt"]
TRAIN_LR = 1e-4             # warmup 0: one fixed batch must fall
TRAIN_TIMED_STEPS = 3       # after one warm-up step
# train_step's own (granite-3-2b's steps take 12-15 s each; 3 until the
# hybrid's phases needed the time); the other train phases keep theirs
TRAIN_STEP_TIMED_STEPS = 1
TRAIN_FIRST_LOSS_TOL = 0.5  # the first loss within this of its want
# the MoE family's train step: grok-1-314b cut to one layer (6.53 B
# parameters, 13.06 GB in bf16), 2 sequences of train_4k in one
# microbatch (ARCH_POLICY's 8 cut: a second one's float32 accumulators
# would add 26 GB), the policy's Adafactor (AdamW's float32 state would be
# 78 GB)
MOE_TRAIN = ("grok-1-314b", 1)
MOE_TRAIN_BATCH = 2
MOE_TRAIN_OPTIMIZER = ARCH_POLICY[MOE_TRAIN[0]]["opt"]
PARITY_ARCHS = ("granite-3-2b", "qwen3-4b", "deepseek-v3-671b",
                "grok-1-314b", "llava-next-34b", "whisper-small",
                "xlstm-350m", "zamba2-7b")
PARITY_STEPS = 3
PARITY_LR = 1e-3
# card against CPU, float32: every loss within PARITY_LOSS_TOL; every
# parameter within PARITY_PARAM_ATOL + PARITY_PARAM_RTOL x |p|, except,
# with compress_grads, at most PARITY_FLIPS of the elements (an element
# whose gradient lands one int8 quantum apart), which stay within
# 2 x lr per step
PARITY_LOSS_TOL = 1e-4
PARITY_PARAM_ATOL = 1e-4
PARITY_PARAM_RTOL = 1e-4
PARITY_FLIPS = 2e-3
# run A, B1 and B2 together: 18 steps and 6 checkpoint writes, so that the
# whole run stays inside its time budget (PERF.md section 5)
LOOP_STEPS = 9
LOOP_CKPT_EVERY = 3
LOOP_SPLIT = 3
# run B resumed against the uninterrupted run A, per logged loss: the two
# runs are separate CUDA runs, whose atomic accumulations need not sum in
# one order (on the H100 they have been equal bit for bit)
LOOP_RESUME_TOL = 5e-3


def one_card_run(model, shape, optimizer, **kw):
    from repro_torch.config import RunConfig
    from repro_torch.launch.train import ONE_DEVICE
    return RunConfig(model=model, shape=shape, mesh=ONE_DEVICE,
                     optimizer=optimizer, **kw)


def train_run(arch, layers, optimizer, batch, microbatches) -> tuple:
    """``(full config, config, shape, RunConfig)`` of a train phase:
    ``arch``'s FULL config, its depth cut to ``layers`` if given, at
    train_4k's sequence length with the global batch cut to ``batch``
    sequences in ``microbatches`` microbatches, remat "block"."""
    from repro_torch.config import OptimizerConfig, ShapeConfig
    from repro_torch.configs import get_arch
    full = get_arch(arch)
    cfg = full if layers is None else replace(full, n_layers=layers)
    shape = ShapeConfig(name=f"train_4k_b{batch}", seq_len=TRAIN_SEQ,
                        global_batch=batch, kind="train")
    run = one_card_run(cfg, shape, OptimizerConfig(
        name=optimizer, lr=TRAIN_LR, warmup_steps=0, total_steps=100),
        microbatches=microbatches, remat="block", seed=SEED)
    return full, cfg, shape, run


def train_trace(ts, params, opt, ef, batch) -> tuple:
    """One train step under torch.profiler (device activity only: the
    host's op records would add their cost to the wall): the wall to a
    synchronize, the device's busy time (the union of kernel and copy
    intervals), its idle share, the number of device events, the kernels
    with the most device time, and the seconds it took to read the
    events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.serve_trace import device_intervals, union_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, ef, m = ts.step(params, opt, ef, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = device_intervals(prof)
    busy_s = union_us(dev) / 1e6
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    out = {"wall_s": wall_s, "device_busy_s": busy_s,
           "device_idle_share": 1 - busy_s / wall_s if dev else None,
           "device_events": len(dev),
           "top_kernels": [{"name": n[:80], "device_s": us / 1e6}
                           for n, us in top],
           "events_s": time.perf_counter() - t0}
    return (params, opt, ef), loss, out


def phase_train_step(card, device, *, phase="train_step", arch=TRAIN_ARCH,
                     layers=None, optimizer=TRAIN_OPTIMIZER,
                     batch=TRAIN_BATCH,
                     microbatches=TRAIN_MICROBATCHES,
                     timed_steps=TRAIN_TIMED_STEPS) -> dict:
    """``arch``'s FULL config (its depth cut to ``layers`` if given; its
    weights drawn from a seeded generator on the card) trained by
    make_train_step at train_4k's sequence length with the global batch
    cut to ``batch`` sequences in ``microbatches`` microbatches,
    ``optimizer``, remat="block": one warm-up step, ``timed_steps``
    timed ones (host clock to a synchronize) and one under
    torch.profiler, all on the pipeline's batch 0 (a VLM's with its
    prefix_embeds stub, an audio model's with its frame_embeds). Fails
    unless every loss is finite, the first is
    within TRAIN_FIRST_LOSS_TOL of its want and the last is below the
    first, and no PIR kernel ran. The want is ln(vocab); for a MoE or VLM
    config, whose random logits spread wider (d_model 6,144 and 7,168), ln
    V + s^2 / 2 (the cross-entropy of logits of std s), s measured on a
    no-grad forward over the batch's first sequence, whose dropped slots
    are reported for a MoE. The model-FLOPs share counts the active
    parameters (cfg.n_active_params(): the routed top-k experts) for a
    MoE, every parameter otherwise, times every position (a VLM's prefix
    rows run the trunk too); for an encoder-decoder, the encoder's
    parameters times the frames plus the decoder's and the tied
    unembedding's times the tokens (the learned positions are a lookup);
    for a hybrid model every parameter, the shared block's once per
    invocation, times the tokens; for an SSM model every parameter, each
    block at its own size (the
    config's n_params() counts every block as an mLSTM), times the
    tokens."""
    from repro_torch.analysis.roofline import PEAK_BF16_FLOPS_PER_S
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    from repro_torch.runtime.steps import make_train_step
    t_phase = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    ops.reset_counts()
    full, cfg, shape, run = train_run(arch, layers, optimizer, batch,
                                      microbatches)
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    ts = make_train_step(run, device=device)
    state = ts.init_state(torch.Generator(device).manual_seed(SEED + 500))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated()
    raw = TokenPipeline(cfg, shape, seed=SEED).batch(0)
    batch_in = {k: torch.as_tensor(v.reshape(ts.input_structs[k].shape),
                                   device=device) for k, v in raw.items()}
    batch_bytes = sum(v.numel() * v.element_size()
                      for v in batch_in.values())
    first_want = float(np.log(cfg.vocab))
    spread = {}
    if cfg.family != "dense":
        first = {k: torch.as_tensor(v[:1], device=device)
                 for k, v in raw.items()}
        side = {k: v for k, v in first.items() if k != "tokens"}
        with at_moe_inputs(ts.model, M.dropped_slots) as dropped:
            logits, _ = ts.model.forward(first["tokens"], **side)
        std = float(logits[..., :cfg.vocab].std())
        del logits, first
        first_want += std ** 2 / 2
        spread = {"logit_std": std}
        if moe:
            spread.update(dropped_slots_first_forward=sum(dropped),
                          slots_first_forward=cfg.moe.top_k * TRAIN_SEQ
                          * (cfg.n_layers - cfg.moe.first_dense))
    losses, step_s = [], []
    for _ in range(1 + timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m = ts.step(*state, batch_in)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    state, loss, trace = train_trace(ts, *state, batch_in)
    losses.append(loss)
    n_params = sum(p.numel() for p in ts.model.parameters())
    n_active = cfg.n_active_params() if moe else n_params
    tokens_per_step = batch * TRAIN_SEQ
    timed = float(np.median(step_s[1:]))
    # analysis/roofline.model_flops_for: 6 N D (int: the JSON line keeps
    # its integer figures)
    train_flops = lambda n, d: int(model_flops_for(n, d, training=True))
    flops = train_flops(n_active, tokens_per_step)
    basis = "6 x parameters (active for MoE) x positions"
    if cfg.family == "audio":
        sizes = {n: p.numel() for n, p in ts.model.named_parameters()}
        n_enc = sum(v for n, v in sizes.items()
                    if n.startswith(("enc_layers.", "enc_norm.")))
        n_dec = sum(v for n, v in sizes.items()
                    if n.startswith(("dec_layers.", "dec_norm.")))
        n_unembed = sizes["embed"]
        frames = batch * cfg.encoder_len
        flops = (train_flops(n_enc, frames)
                 + train_flops(n_dec + n_unembed, tokens_per_step))
        basis = ("6 x (encoder parameters x frames + (decoder + tied "
                 "unembedding parameters) x tokens); pos_dec is a lookup")
        spread.update(encoder_params=n_enc, decoder_params=n_dec,
                      unembed_params=n_unembed, frames_per_step=frames)
    if cfg.family == "ssm":
        basis = ("6 x parameters x tokens, each block at its own size (the "
                 "config's n_params() counts every block as an mLSTM); the "
                 "mLSTM's intra-chunk [Q, Q] products are outside it")
    if cfg.family == "hybrid":
        n_shared = sum(p.numel() for p in ts.model.shared.parameters())
        flops = train_flops(n_params + (ts.model.n_groups - 1) * n_shared,
                            tokens_per_step)
        basis = ("6 x (parameters + (invocations - 1) x the shared block's "
                 "parameters) x tokens: the shared block counted once per "
                 "invocation; Mamba2's intra-chunk [Q, Q] products are "
                 "outside it")
        spread.update(shared_params=n_shared,
                      shared_invocations=ts.model.n_groups)
    launches = {k: v["launches"] + v["plain_calls"]
                for k, v in ops.counts().items()}
    out = {"phase": phase, "card": card, "arch": cfg.name,
           "layers": cfg.n_layers, "layers_config": full.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
           "n_params_config": cfg.n_params(), "n_active_params": n_active,
           "seq_len": TRAIN_SEQ, "global_batch": batch,
           "text_tokens_per_step": int(raw["tokens"].size),
           "global_batch_config": 256, "microbatches": microbatches,
           "remat": run.remat, "optimizer": optimizer, "lr": TRAIN_LR,
           "init_s": init_s, "losses": losses, "first_loss_want": first_want,
           **spread, "warmup_step_s": step_s[0], "step_s": step_s[1:],
           "step_s_median": timed,
           # positions: a VLM's prefix rows included, as in the FLOPs
           "tokens_per_s": tokens_per_step / timed,
           "model_flops_per_step": flops, "model_flops_basis": basis,
           "model_flops_share": flops / timed / PEAK_BF16_FLOPS_PER_S["cuda"],
           "peak_flops_per_s": PEAK_BF16_FLOPS_PER_S["cuda"],
           "state_bytes": state_bytes, "peak_device_bytes": peak,
           "base_device_bytes": base_bytes, "batch_bytes": batch_bytes,
           "trace": trace, "pir_kernel_calls": launches,
           "seconds": time.perf_counter() - t_phase}
    del ts, state, batch_in, m
    release()
    emit(out)
    if not (all(np.isfinite(losses))
            and abs(losses[0] - first_want) <= TRAIN_FIRST_LOSS_TOL
            and losses[-1] < losses[0] and not any(launches.values())):
        raise AssertionError(f"{phase}: {out}")
    return out


def route_diff(sides, tokens) -> dict:
    """The top-k expert ids of every MoE layer on a no-grad forward over
    ``tokens`` on each side: how many (token, k) slots the card's part
    from the CPU's."""
    from repro_torch.models import moe as M
    ids = {}
    for side, ts in sides.items():
        with at_moe_inputs(ts.model, lambda params, cfg, x: M._route(
                params, cfg, x)[1].cpu()) as seen:
            ts.model.forward(torch.as_tensor(tokens, device=ts.device))
        ids[side] = seen
    return {"route_slots": sum(t.numel() for t in ids["cpu"]),
            "routes_differ": sum(int((a != b).sum())
                                 for a, b in zip(ids["cpu"], ids["cuda"]))}


def parity_case(arch, name, microbatches, compress, device) -> dict:
    """PARITY_STEPS steps of one float32 smoke model on the card and on
    the CPU from the same weights (drawn on the CPU) and batches; for a
    MoE model also the routes the two sides part on at step 0, and the
    case's seconds."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SMOKE_TRAIN
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.runtime.steps import make_train_step
    t0 = time.perf_counter()
    run = one_card_run(
        replace(get_arch(arch, smoke=True), dtype="float32"), SMOKE_TRAIN,
        OptimizerConfig(name=name, lr=PARITY_LR, warmup_steps=1,
                        total_steps=10, compress_grads=compress),
        microbatches=microbatches)
    sides = {"cpu": make_train_step(run, device="cpu"),
             "cuda": make_train_step(run, device=device)}
    sides["cpu"].model.init_params(torch.Generator().manual_seed(SEED + 510))
    sides["cuda"].model.load_state_dict(sides["cpu"].model.state_dict())
    states = {k: ts.init_state(None) for k, ts in sides.items()}
    pipe = TokenPipeline(run.model, run.shape, seed=SEED)
    routes = (route_diff(sides, pipe.batch(0)["tokens"])
              if run.model.family == "moe" else {})
    structs = sides["cpu"].input_structs
    losses = {"cpu": [], "cuda": []}
    for step in range(PARITY_STEPS):
        batch = {k: v.reshape(structs[k].shape)
                 for k, v in pipe.batch(step).items()}
        for k, ts in sides.items():
            *states[k], m = ts.step(*states[k], batch)
            losses[k].append(float(m["loss"]))
    worst, outliers, total = 0.0, 0, 0
    bound = 2 * PARITY_LR * PARITY_STEPS
    for pname, want in states["cpu"][0].items():
        got = states["cuda"][0][pname].detach().cpu()
        diff = (got - want.detach()).abs()
        worst = max(worst, float(diff.max()))
        outliers += int((diff > PARITY_PARAM_ATOL + PARITY_PARAM_RTOL
                         * want.detach().abs()).sum())
        total += diff.numel()
    loss_diff = max(abs(a - b) for a, b in zip(losses["cuda"],
                                               losses["cpu"]))
    ok = (loss_diff <= PARITY_LOSS_TOL and worst <= bound
          and outliers <= (PARITY_FLIPS * total if compress else 0))
    return {"arch": arch, "optimizer": name, "microbatches": microbatches,
            "compress_grads": compress, "losses_cuda": losses["cuda"],
            "losses_cpu": losses["cpu"], "max_loss_diff": loss_diff,
            "max_param_diff": worst, "param_outliers": outliers,
            "params": total, **routes, "ok": ok,
            "seconds": time.perf_counter() - t0}


def phase_train_parity(card, device) -> dict:
    """The PARITY_ARCHS' SMOKE configs in float32 (the dense granite-3-2b
    and qwen3-4b, the MoE deepseek-v3-671b and grok-1-314b, the VLM
    llava-next-34b with its prefix_embeds stub, the audio whisper-small
    with its frame_embeds stub, the SSM xlstm-350m, the hybrid
    zamba2-7b): PARITY_STEPS
    AdamW steps, and PARITY_STEPS Adafactor steps with compress_grads and
    two microbatches, on the card against the same steps on the CPU; the
    MoE cases' routes that part at step 0 are counted and reported."""
    t_phase = time.perf_counter()
    cases = [parity_case(arch, name, mb, compress, device)
             for arch in PARITY_ARCHS
             for name, mb, compress in (("adamw", 1, False),
                                        ("adafactor", 2, True))]
    out = {"phase": "train_parity", "card": card, "steps": PARITY_STEPS,
           "lr": PARITY_LR, "loss_tol": PARITY_LOSS_TOL,
           "param_atol": PARITY_PARAM_ATOL, "param_rtol": PARITY_PARAM_RTOL,
           "flip_share": PARITY_FLIPS, "cases": cases,
           "routes_differ": sum(c.get("routes_differ", 0) for c in cases),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if not all(c["ok"] for c in cases):
        raise AssertionError(f"train_parity: {out}")
    return out


def phase_train_loop(card, device) -> dict:
    """The train_lm twin's recipe (model_100m, 16 x 512, two microbatches,
    AdamW) through TrainLoop and CheckpointManager under a temporary
    directory: run A, LOOP_STEPS steps with a checkpoint every
    LOOP_CKPT_EVERY; run B, LOOP_SPLIT steps, then a fresh loop resumed to
    LOOP_STEPS. A's last loss below its first, three checkpoints kept, B's
    resumed losses A's within LOOP_RESUME_TOL; the seconds of A's host
    copies and file writes, and of B's restore (the managers' timings)."""
    from repro_torch import train_lm
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    t_phase = time.perf_counter()
    release()
    ops.reset_counts()
    model = train_lm.model_100m()
    shape = ShapeConfig(name="example", seq_len=512, global_batch=16,
                        kind="train")
    run = train_lm.make_run(model, shape, LOOP_STEPS, seed=SEED)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    logs = []

    def loop(name, total):
        return TrainLoop(run, TrainLoopConfig(
            total_steps=total, ckpt_every=LOOP_CKPT_EVERY, log_every=0,
            ckpt_dir=os.path.join(root, name)), device=device,
            log=logs.append)

    try:
        t0 = time.perf_counter()
        a = loop("a", LOOP_STEPS)
        res_a = a.run_loop()
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        kept = a.ckpt.all_steps()
        a_times = a.ckpt.timings
        last = os.path.join(root, "a", f"step_{LOOP_STEPS:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(last, f))
                         for f in os.listdir(last))
        del a
        shutil.rmtree(os.path.join(root, "a"))
        release()
        t0 = time.perf_counter()
        res_b1 = loop("b", LOOP_SPLIT).run_loop()
        b1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b2 = loop("b", LOOP_STEPS)
        res_b2 = b2.run_loop(resume=True)
        b2_s = time.perf_counter() - t0
        restore_s = b2.ckpt.timings["restore_s"]
        del b2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    diffs = [abs(x - y) for x, y in zip(res_b2.losses,
                                        res_a.losses[LOOP_SPLIT:])]
    launches = {k: v["launches"] + v["plain_calls"]
                for k, v in ops.counts().items()}
    out = {"phase": "train_loop", "card": card, "arch": model.name,
           "params": model.n_params(), "batch": shape.global_batch,
           "seq_len": shape.seq_len, "microbatches": run.microbatches,
           "steps": LOOP_STEPS, "ckpt_every": LOOP_CKPT_EVERY,
           "a_losses": res_a.losses, "a_final_step": res_a.final_step,
           "a_seconds": a_s, "a_steps_per_s": LOOP_STEPS / a_s,
           "kept_checkpoints": kept, "checkpoint_bytes": ckpt_bytes,
           "checkpoint_snapshot_s": a_times["snapshot_s"],
           "checkpoint_write_s": a_times["write_s"],
           "checkpoint_write_s_median": float(np.median(a_times["write_s"])),
           "checkpoint_restore_s": restore_s,
           "b_split": LOOP_SPLIT, "b1_final_step": res_b1.final_step,
           "b1_seconds": b1_s, "b2_losses": res_b2.losses,
           "b2_final_step": res_b2.final_step, "b2_seconds": b2_s,
           "b2_steps_per_s": (LOOP_STEPS - LOOP_SPLIT) / b2_s,
           "resume_max_diff": max(diffs) if diffs else None,
           "resume_tol": LOOP_RESUME_TOL, "logs": logs,
           "pir_kernel_calls": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    want_kept = [LOOP_STEPS - LOOP_CKPT_EVERY * i for i in (2, 1, 0)]
    if not (res_a.final_step == LOOP_STEPS == res_b2.final_step
            and res_a.losses[-1] < res_a.losses[0] and kept == want_kept
            and len(diffs) == LOOP_STEPS - LOOP_SPLIT
            and max(diffs) <= LOOP_RESUME_TOL
            and res_b1.final_step == LOOP_SPLIT
            and not any(launches.values())):
        raise AssertionError(f"train_loop: {out}")
    return out


# -- the dry run ----------------------------------------------------------------

#: the dryrun phase's holds: the predicted arguments within this share of
#: the card's resident bytes after init, the predicted peak within this
#: share of torch.cuda.max_memory_allocated()
DRYRUN_STATE_TOL = 0.01
DRYRUN_PEAK_TOL = 0.10
#: the PIR cell it predicts: the timing phase's xor-dpf-2 batch of 32
DRYRUN_PIR = ("pir-1g", "fused-cuda", 32)
#: the longest the phase waits for the dry run's child (66-81 s of host
#: time on the card's machine, started some 700 s before the phase)
DRYRUN_WAIT_S = 600


def dryrun_cells(path: str) -> None:
    """The dryrun phase's two cells on the meta device, written to
    ``path`` as JSONL (``launch/dryrun.py``): train_step's own RunConfig
    (``train_run``) and DRYRUN_PIR's answer step of one party. Runs in a
    process of its own, started beside the card's phases."""
    from repro_torch.launch import dryrun
    _, _, _, run = train_run(TRAIN_ARCH, None, TRAIN_OPTIMIZER, TRAIN_BATCH,
                             TRAIN_MICROBATCHES)
    pir, path_name, queries = DRYRUN_PIR
    with open(path, "w") as f:
        for cell in (lambda: dryrun.lower_cell(TRAIN_ARCH, "train_4k",
                                               run=run),
                     lambda: dryrun.lower_pir_cell(pir, path=path_name,
                                                   n_queries=queries)):
            t0 = time.perf_counter()
            rec = cell()
            rec["seconds"] = time.perf_counter() - t0
            f.write(json.dumps(rec) + "\n")


def start_dryrun() -> tuple:
    """Start :func:`dryrun_cells` in a child process with no card visible
    (the meta device allocates nothing); it takes host seconds the card's
    phases do not wait for. Returns (the process, its output path, the
    temporary directory, the start time); the process is killed at exit if
    it is still running."""
    import atexit
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    path = os.path.join(tmp, "dryrun.jsonl")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([root, os.path.join(root, "src")]))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.dryrun_cells({path!r})"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, tmp, time.perf_counter()


def opcheck_kernels(device) -> dict:
    """``torch.library.opcheck`` of the six custom ops (the schema, and the
    fake against the kernel on the card: output shapes, dtypes and
    strides) at the check phase's shapes: PIR_1G's words and bytes (B1 at
    Q = 1, B2 at Q = 32 over chunk-11 roots, B3 at Q = 1, B4 at Q = 32
    over chunk-10 roots), B5 at PIR_128M_LWE's answer ([32, 2^22] x
    [2^22, 32]) and B6 at n = 2^24. Operands are seeded random words: the
    checks read shapes, not values. ``{op: {test: "SUCCESS" or error}}``."""
    from repro_torch.configs.pir import PIR_1G, PIR_128M_LWE
    from repro_torch.kernels import ops  # noqa: F401 (registers the ops)
    gen = torch.Generator(device=device).manual_seed(SEED + 900)

    def ints(*shape, hi=1 << 30):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    rows, lrows = PIR_1G.n_items, PIR_128M_LWE.n_items
    db = ints(rows, PIR_1G.item_bytes // 4)
    db_bytes = db.view(torch.int8).reshape(rows, PIR_1G.item_bytes)

    def fused(clog):
        c = rows >> clog
        return (ints(32, c, 4), ints(32, c, hi=2), ints(32, clog, 4),
                ints(32, clog, 2, hi=2))

    n = GGM_N
    cases = {
        "dpxor": (db, ints(1, rows, hi=2)),
        "fused_scan_xor": (db, *fused(11), 12),
        "fused_scan_add": (db_bytes, *fused(10), ints(32), 0, 12),
        "pir_gemm": (ints(1, rows, hi=256).to(torch.int8), db_bytes),
        "lwe_gemm": (ints(32, lrows), ints(lrows, PIR_128M_LWE.item_bytes)),
        "ggm_expand": (ints(n, 4), ints(n, hi=2), ints(4), ints(2, hi=2),
                       12, 256),
    }
    out = {}
    for name, args in cases.items():
        res = torch.library.opcheck(
            getattr(torch.ops.repro_torch, name), args,
            test_utils=("test_schema", "test_faketensor"),
            raise_exception=False)
        out[name] = {k: v if v == "SUCCESS" else str(v)[:300]
                     for k, v in res.items()}
    del cases, db, db_bytes
    torch.cuda.synchronize()
    release()
    return out


def cublas_workspace_bytes(device) -> int:
    """Bytes the caching allocator gives one cuBLAS handle's workspace
    (allocated at its first GEMM, outside any op's outputs, so the cost
    counter cannot see it): the allocated bytes a bf16 product adds beyond
    its output, after the workspaces are cleared."""
    a = torch.ones((64, 64), dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    before = torch.cuda.memory_allocated()
    b = a @ a
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before - b.untyped_storage() \
        .nbytes()


def phase_dryrun(card, device, train, timing, started) -> dict:
    """The dry run against the card. The six custom ops' fakes are
    opchecked against their kernels (all must pass); then the records of
    :func:`dryrun_cells`, computed on the meta device in a child process
    since the build (``started``), are read and held against what
    train_step and timing measured on the card:

    * train_step's cell (granite-3-2b uncut, TRAIN_BATCH x 4,096 tokens in
      TRAIN_MICROBATCHES microbatches, AdamW): the predicted arguments
      (parameters, AdamW state, the batch) within DRYRUN_STATE_TOL of the
      card's resident bytes after init plus the batch, and the predicted
      peak of live bytes within DRYRUN_PEAK_TOL of max_memory_allocated;
      both predictions add what was allocated before the phase began
      (``base_device_bytes``), and the difference that remains is
      reported beside one cuBLAS handle's workspace
      (:func:`cublas_workspace_bytes`), which no op's output holds.
      Reported: op_cost's FLOPs beside the phase's model FLOPs
      (useful / counted), the roofline step time at the data sheet's
      constants, and its share of the measured step.
    * timing's PIR_1G xor-dpf-2 batch of 32 on fused-cuda, one party's
      answer step: op_cost's bytes beside the engine's modeled bytes, and
      the roofline memory term beside the measured B2 launch and the
      end-to-end batch (two parties, keygen and transfers included).
    """
    proc, path, tmp, t_start = started
    t0 = time.perf_counter()
    opcheck = opcheck_kernels(device)
    workspace = cublas_workspace_bytes(device)
    opcheck_s = time.perf_counter() - t0
    t_wait = time.perf_counter()
    _, stderr = proc.communicate(timeout=DRYRUN_WAIT_S)
    waited_s = time.perf_counter() - t_wait
    if proc.returncode:
        raise AssertionError(f"dryrun: the dry run's process failed "
                             f"({proc.returncode}): {stderr[-3000:]}")
    with open(path) as f:
        lm, pir = [json.loads(line) for line in f]
    shutil.rmtree(tmp)
    base = train["base_device_bytes"]
    mem = lm["memory"]
    state_meas = train["state_bytes"] + train["batch_bytes"]
    state_pred = mem["argument_size_in_bytes"] + base
    peak_meas = train["peak_device_bytes"]
    peak_pred = lm["peak_live_bytes"] + base
    step_s = train["step_s_median"]
    model_flops = train["model_flops_per_step"]
    b2_ms = timing["fused_scan_xor"]["ms"]
    e2e_s = timing["e2e_32"]["median_s"]
    out = {
        "phase": "dryrun", "card": card,
        "opcheck": opcheck,
        "opcheck_passed": all(v == "SUCCESS" for r in opcheck.values()
                              for v in r.values()),
        "train": {
            "cell": lm["name"], "global_batch": lm["global_batch"],
            "microbatches": lm["microbatches"],
            "optimizer": lm["optimizer"], "n_ops": lm["n_ops"],
            "meta_seconds": lm["seconds"],
            "memory": mem, "fits_one_card": lm["fits_one_card"],
            "base_device_bytes": base,
            "state_bytes_measured": state_meas,
            "state_bytes_predicted": state_pred,
            "state_error": state_pred / state_meas - 1,
            "peak_bytes_measured": peak_meas,
            "peak_bytes_predicted": peak_pred,
            "peak_error": peak_pred / peak_meas - 1,
            "peak_gap_bytes": peak_meas - peak_pred,
            "cublas_workspace_bytes": workspace,
            "op_cost_flops": lm["hlo_flops"],
            "op_cost_elem_flops": lm["hlo_elem_flops"],
            "op_cost_bytes": lm["hlo_bytes"],
            "model_flops": model_flops,
            "useful_flop_ratio": model_flops / lm["hlo_flops"],
            "t_compute_s": lm["t_compute_s"], "t_memory_s": lm["t_memory_s"],
            "bottleneck": lm["bottleneck"],
            "roofline_step_s": lm["roofline_step_s"],
            "step_s_measured": step_s,
            "roofline_share_of_step": lm["roofline_step_s"] / step_s},
        "pir": {
            "cell": pir["name"], "plan": pir["plan"],
            "n_queries": pir["n_queries"], "n_ops": pir["n_ops"],
            "meta_seconds": pir["seconds"],
            "op_cost_bytes": pir["hlo_bytes"],
            "plan_predicted_bytes": pir["plan_predicted_bytes"],
            "op_cost_over_plan_bytes":
                pir["hlo_bytes"] / pir["plan_predicted_bytes"],
            "peak_live_bytes": pir["peak_live_bytes"],
            "t_memory_s": pir["t_memory_s"],
            "b2_ms_measured": b2_ms,
            "t_memory_share_of_b2": pir["t_memory_s"] * 1e3 / b2_ms,
            "e2e_32_s_measured": e2e_s,
            "t_memory_share_of_e2e": pir["t_memory_s"] / e2e_s},
        # the child's head start: it ran beside the card's phases since
        "child_started_s_before": t0 - t_start,
        "waited_s": waited_s, "opcheck_s": opcheck_s,
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    held = (out["opcheck_passed"]
            and abs(out["train"]["state_error"]) <= DRYRUN_STATE_TOL
            and abs(out["train"]["peak_error"]) <= DRYRUN_PEAK_TOL)
    if not held:
        raise AssertionError(f"dryrun: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    # the plans of every phase but serve_tuned are plan_for's, whatever
    # cache file the machine holds
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "off"
    # the port must import before anything is printed: a copy of this
    # script without the repo fails here, with no result
    from repro_torch import quickstart
    from repro_torch.configs.pir import (PIR_1G, PIR_1G_ADD, PIR_1G_BATCH,
                                         PIR_1G_K3, PIR_128M_LWE)
    from repro_torch.core import lwe
    from repro_torch.core import pir
    from repro_torch.db import Database
    from repro_torch.kernels import build  # noqa: F401

    t_start = time.perf_counter()
    device = torch.device("cuda")
    info = phase_device()
    phase_build()
    # the dryrun phase's meta-device cells, computed beside the card's
    # phases in a child process (host seconds only)
    dryrun = start_dryrun()

    cfg = PIR_1G
    t0 = time.perf_counter()
    host_db = pir.make_database(np.random.default_rng(SEED), cfg.n_items,
                                cfg.item_bytes)
    database = Database(host_db, cfg, device)
    db = database.view("words")
    torch.cuda.synchronize()
    emit({"phase": "database", "rows": cfg.n_items, "words": db.shape[1],
          "bytes": database.resident_bytes,
          "seconds": time.perf_counter() - t0})

    worst = phase_check(db, cfg, PIR_1G_K3, device)
    worst_add, kept = phase_check_add(database.view("bytes"), PIR_1G_ADD,
                                      device)
    worst.update(worst_add)
    qs = quickstart.run(device="cuda", verbose=False)
    emit({"phase": "quickstart", "config": "pir-smoke", **qs})
    if not all(qs["exact"]):
        raise AssertionError("quickstart returned a wrong record")

    launches = phase_serve(host_db, cfg, database, device)
    launches_add = phase_serve_add(host_db, PIR_1G_ADD, database, device)
    phase_serve_k3(host_db, PIR_1G_K3, database, device)
    timing = phase_timing(database, cfg, info["card"], device)
    timing_add = phase_timing_add(database, PIR_1G_ADD, PIR_1G_K3,
                                  info["card"], device, kept)
    # the reference's single-shard functions on the same resident views
    launches_api = phase_reference_api(host_db, database, cfg, PIR_1G_ADD,
                                       timing, info["card"], device)

    # the engine plane: B6, the smoke gate, the tuner, tuned serving
    ggm = phase_check_ggm(cfg, device)
    worst["ggm_expand"] = ggm["max_abs_err"]
    phase_engine_smoke(device)
    cache_file, ggm_row, tuned = phase_tune(info["card"], device, ggm)
    ggm_row["launches"] += ggm["launches"]
    del ggm
    phase_serve_tuned(host_db, database, cache_file, tuned, timing,
                      timing_add, info["card"], device)
    shutil.rmtree(os.path.dirname(cache_file))
    launches_ggm = {"ggm_expand": ggm_row["launches"]}

    # every record width, and verified reconstruction: the same records
    # stored with their checksum word (36 bytes), and 128-byte records
    database_chk, host128, database_w128 = phase_database_widths(
        host_db, cfg, device)
    host_chk = host_db.copy()       # the checksum database's records
    widths = phase_check_widths(
        {32: db, 36: database_chk.view("words"),
         128: database_w128.view("words")}, cfg, info["card"], device)
    for name, err in widths.items():
        worst[name] = max(worst[name], err)
    xor_k, add_k = ("dpxor", "fused_scan_xor"), ("pir_gemm", "fused_scan_add")
    launches_chk = phase_serve_chk(host_db, (
        ("pir-1g+chk", replace(cfg, checksum=True), xor_k),
        ("pir-1g-add+chk", replace(PIR_1G_ADD, checksum=True), add_k)),
        database_chk, device)
    cfg128 = replace(cfg, n_items=ROWS_128, item_bytes=128)
    launches_w128 = phase_serve_w128(host128, (
        ("pir-1g-128b", cfg128, xor_k),
        ("pir-1g-128b-add", replace(cfg128, protocol=PIR_1G_ADD.protocol),
         add_k)), database_w128, device)
    # online updates on the 1 GiB database (the last phase to read host_db)
    launches_upd = phase_updates(host_db, cfg, PIR_1G_ADD, database,
                                 info["card"], device)

    # the batch plane on its own (4 GiB of buckets), then the single-server
    # LWE scheme on its own database: the 128-byte one and the multi-server
    # phases' temporaries go first, A takes 16 GiB; the 1 GiB and checksum
    # databases stay for serve_runtime
    del db, kept, database_w128, host128
    gc.collect()
    torch.cuda.empty_cache()
    launches_batch, layout = phase_batch(PIR_1G_BATCH, info["card"], device)
    gc.collect()
    torch.cuda.empty_cache()
    host_lwe, database_lwe, a = phase_database_lwe(PIR_128M_LWE, device)
    worst_lwe, plain_lwe = phase_check_lwe(database_lwe, a, device)
    worst.update(worst_lwe)
    launches_lwe = phase_serve_lwe(host_lwe, PIR_128M_LWE, database_lwe,
                                   device)
    launches_enc = phase_encrypt_lwe(database_lwe, a, PIR_128M_LWE, device)
    timing_lwe = phase_timing_lwe(host_lwe, database_lwe, a, PIR_128M_LWE,
                                  info["card"], device, plain_lwe)
    err_upd, launches_upd_lwe = phase_updates_lwe(
        host_lwe, database_lwe, PIR_128M_LWE, info["card"], device)
    worst["lwe_gemm"] = max(worst["lwe_gemm"], err_upd)
    del database_lwe
    gc.collect()
    torch.cuda.empty_cache()
    err_chk, launches_lwe_chk = phase_serve_chk_lwe(
        host_lwe, replace(PIR_128M_LWE, checksum=True), a, info["card"],
        device)
    worst["lwe_gemm"] = max(worst["lwe_gemm"], err_chk)
    del a
    lwe.clear_matrix_cache()
    timing_lwe["lwe_gemm"] = timing_lwe["lwe_gemm_q32"]
    launches_twins = phase_twins(device)
    launches_runtime = phase_serve_runtime(
        host_db, cfg, database, host_chk, replace(cfg, checksum=True),
        database_chk, info["card"], device)
    # the replica plane last, so that its warm plan-cache entries reach no
    # other phase; every replica places its own copy of the records
    del database, database_chk
    release()
    launches_replicas = phase_replicas(
        host_db, cfg, host_chk, replace(cfg, checksum=True), info["card"])
    # A6b's serving path: the database sharded over four ranks on this card
    phase_sharded(host_db, host_lwe, layout, info["card"])
    del host_db, host_chk, host_lwe, layout
    # the dense LM last, once the fleets are released: qwen3-4b's weights
    # (8.8 GB) and its 1.25 GiB embedding table served through xor-dpf-2
    worst_lm, launches_lm = phase_lm(LM_ARCH, info["card"], device)
    # the MoE family, each model alone on the card: grok-1 cut to 4 layers
    # (42.6 GB), then deepseek-v3 cut to 5 (54.6 GB) with its 1.75 GiB
    # table served through xor-dpf-2
    phase_lm(MOE_SERVE[0], info["card"], device, phase="moe_serve",
             layers=MOE_SERVE[1], private=False)
    worst_moe, launches_moe = phase_lm(
        MOE_PRIVATE[0], info["card"], device, phase="private_moe",
        layers=MOE_PRIVATE[1])
    # the VLM family: llava-next-34b cut to 16 layers (19.7 GB), 2,880
    # prefix rows + 1,216 text tokens a stream, private text-token lookups
    # over its 0.94 GB table
    worst_vlm, launches_vlm = phase_lm(
        VLM_SERVE[0], info["card"], device, phase="vlm_serve",
        layers=VLM_SERVE[1], seq_len=VLM_SEQ)
    # the audio family: whisper-small uncut (0.263 B parameters), 1,500
    # frames a stream through the encoder and 2,048 decoder tokens, private
    # decoder-token lookups over its 96 MiB table of 1,536-byte rows
    worst_audio, launches_audio = phase_lm(
        AUDIO_ARCH, info["card"], device, phase="audio_serve")
    # the SSM family: xlstm-350m uncut (0.529 B parameters), 2,048 tokens a
    # stream through 21 mLSTM and 3 sLSTM blocks, private lookups over its
    # 128 MiB table of 2,048-byte rows; then its long_500k cell
    worst_ssm, launches_ssm = phase_lm(SSM_ARCH, info["card"], device,
                                       phase="ssm_serve")
    phase_ssm_long(info["card"], device)
    # the hybrid family: zamba2-7b uncut (6.75 B parameters, 13.5 GB), 81
    # Mamba2 layers and 13 invocations of one shared attention block,
    # private lookups over its 224 MiB table of 7,168-byte rows; then its
    # long_500k cell at 36 layers
    worst_hybrid, launches_hybrid = phase_lm(HYBRID_ARCH, info["card"],
                                             device, phase="hybrid_serve")
    phase_hybrid_long(info["card"], device)
    for name, err in (list(worst_lm.items()) + list(worst_moe.items())
                      + list(worst_vlm.items())
                      + list(worst_audio.items())
                      + list(worst_ssm.items())
                      + list(worst_hybrid.items())):
        worst[name] = max(worst[name], err)
    # the LM's training half, alone on the card: granite-3-2b at full
    # width and depth, the card against the CPU, the train_lm twin
    train = phase_train_step(info["card"], device,
                             timed_steps=TRAIN_STEP_TIMED_STEPS)
    # the dry run of that step and of timing's PIR_1G batch, held against
    # what the card measured
    phase_dryrun(info["card"], device, train, timing, dryrun)
    # the MoE family's train step at full width: grok-1-314b cut to one
    # layer, Adafactor over its moe_layers leaves
    phase_train_step(info["card"], device, phase="moe_train",
                     arch=MOE_TRAIN[0], layers=MOE_TRAIN[1],
                     optimizer=MOE_TRAIN_OPTIMIZER, batch=MOE_TRAIN_BATCH,
                     microbatches=1)
    # the VLM family's train step: llava-next-34b cut to four layers, the
    # prefix split over two microbatches
    phase_train_step(info["card"], device, phase="vlm_train",
                     arch=VLM_TRAIN[0], layers=VLM_TRAIN[1],
                     optimizer=VLM_TRAIN_OPTIMIZER, batch=VLM_TRAIN_BATCH,
                     microbatches=VLM_TRAIN_BATCH)
    # the audio family's train step: whisper-small uncut, the frames split
    # over two microbatches, AdamW
    phase_train_step(info["card"], device, phase="audio_train",
                     arch=AUDIO_ARCH, optimizer=AUDIO_TRAIN_OPTIMIZER,
                     batch=AUDIO_TRAIN_BATCH,
                     microbatches=AUDIO_TRAIN_MICROBATCHES)
    # the SSM family's train step: xlstm-350m uncut at chunk 256, one
    # microbatch of 8, AdamW
    phase_train_step(info["card"], device, phase="ssm_train",
                     arch=SSM_ARCH, layers=SSM_TRAIN_LAYERS,
                     optimizer=SSM_TRAIN_OPTIMIZER,
                     batch=SSM_TRAIN_BATCH, microbatches=1,
                     timed_steps=SSM_TRAIN_TIMED_STEPS)
    # the hybrid family's train step: zamba2-7b cut to 12 layers at chunk
    # 256, 8 microbatches of one sequence, AdamW
    phase_train_step(info["card"], device, phase="hybrid_train",
                     arch=HYBRID_ARCH, layers=HYBRID_TRAIN_LAYERS,
                     optimizer=HYBRID_TRAIN_OPTIMIZER,
                     batch=HYBRID_TRAIN_BATCH,
                     microbatches=HYBRID_TRAIN_MICROBATCHES,
                     timed_steps=HYBRID_TRAIN_TIMED_STEPS)
    phase_train_parity(info["card"], device)
    phase_train_loop(info["card"], device)

    def total(*runs):               # each path's launches, read after it
        return {k: sum(r.get(k, 0) for r in runs) for k in worst}

    rows = []
    for name, source, replaces, path_launches, times in (
            ("dpxor", "src/repro_torch/csrc/dpxor.cu",
             "src/repro/kernels/dpxor.py:56",
             total(launches, launches_api, launches_chk, launches_w128,
                   launches_upd, launches_batch, launches_twins,
                   launches_runtime, launches_replicas, launches_lm,
                   launches_moe, launches_vlm, launches_audio,
                   launches_ssm, launches_hybrid), timing),
            ("fused_scan_xor", "src/repro_torch/csrc/fused_scan_xor.cu",
             "src/repro/kernels/fused_scan.py:94",
             total(launches, launches_chk, launches_w128, launches_upd,
                   launches_runtime, launches_replicas, launches_lm,
                   launches_moe, launches_vlm, launches_audio,
                   launches_ssm, launches_hybrid), timing),
            ("pir_gemm", "src/repro_torch/csrc/pir_gemm.cu",
             "src/repro/kernels/pir_matmul.py:35",
             total(launches_add, launches_api, launches_chk, launches_w128,
                   launches_upd), timing_add),
            ("fused_scan_add", "src/repro_torch/csrc/fused_scan_add.cu",
             "src/repro/kernels/fused_scan.py:131",
             total(launches_add, launches_chk, launches_w128, launches_upd),
             timing_add),
            ("lwe_gemm", "src/repro_torch/csrc/lwe_gemm.cu",
             "src/repro/kernels/pir_matmul.py:35",
             total(launches_lwe, launches_enc, launches_lwe_chk,
                   {"lwe_gemm": launches_upd_lwe}, launches_runtime),
             timing_lwe),
            ("ggm_expand", "src/repro_torch/csrc/ggm_expand.cu",
             "src/repro/kernels/ggm_expand.py:90", launches_ggm,
             {"ggm_expand": ggm_row})):
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": path_launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t.get("library_ms")})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(info["card"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
