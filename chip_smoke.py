"""Chip smoke test of the PyTorch/CUDA port: StarVector-1B im2svg inference
(bf16, and int8 weights with an int8 KV cache), text2svg, beam search,
num_return_sequences, speculative decoding, continuous-batching serving
(the engine, its REST worker and controller), the eval harness (the
in-process and REST validators, LPIPS-VGG and InceptionV3), offline
pipelined generation, the other vision towers (vqgan, convnext, open-clip,
SigLIP at 512 and 256) behind the 1B decoder, GRPO and training (also on
a tensor mesh, with the 8B), the entry points (both quickstarts, the web
UI, the GRPO driver), and StarVector-8B im2svg
inference (bf16, and int8 weights with an int8 KV cache), text2svg, beam
search, speculative decoding, pipelined generation, serving (also over a
tensor mesh: its two tensor-parallel serve configs, one with int8 weights,
and the 1B's, one with int8 weights and one with a use_speculative
request; and over fsdp, sequence and stage meshes: the decoder's weights
as ZeRO shards and stage blocks gathered at use) and training, on one
NVIDIA H100, end to end through the hand-written kernels. Generation's
decode loop, the single-process serving engine's tick, the pipelined
streams' steps and speculative decoding's verify rounds run as captured
CUDA graphs (generation/graphs.py), as the JAX package runs them as one
jitted device loop; each graphed path is held to the same static steps run
uncaptured, and each loop's uncaptured and graphed wall a step (or round)
and device time are printed side by side.

    python3 chip_smoke.py [--timings] [--profile DIR]
    python3 chip_smoke.py --times-only ROOT

--timings also runs the work whose only output is a time (TIMINGS: phase
4's and 6's serving p50 / tokens/s and memory turns, 4b's request turns,
4e's fused-step timing, phase 6's serial against pipelined turns, phase
7's tile-plan and prefill-graph sweeps, the
siglip_512 prefix, the long-context backward and the head_split sweep);
the default run keeps every check, launch count and kernel row.

The second form times only the decode step (decode_attention and the
quant_matmul GEMV beside their plain versions, bounds and library calls,
with their host cost a call), the quant_matmul prefill tile (M = 260 and
1040, each projection and one prefill's 96 as one graph) and the bf16 and
int8 serving of phase 4, for the package in the tree at ROOT; run for two
trees in turns (a, b, b, a) on one card, back to back, it compares them.

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit, torch / CUDA / nvcc versions
  2. build: the CUDA sources of starvector_tpu_torch/csrc, one nvcc each in
     parallel; registers and spills per kernel from ptxas; the tensor-core
     (HGMMA) instructions from cuobjdump: present in the bf16 attention
     kernels and the int8 wgmma tile, absent from the fp32 ones; the tile
     neither spills nor has its products serialized
  3. kernels against their plain PyTorch versions on the card, fp32 and
     bf16: the inference pair at the 1B prefill/decode shapes and ragged
     cases; the training forward-with-lse and backward pair at the 1B
     training shape (B=4, S=T=769; two bf16 launches bit for bit), ragged
     cases, the 8k context (B=1, S=T=8450), sequence-parallel chunks of the
     8k and 16k windows and the 16k triangle, the 8B's heads (H=36 Hkv=4,
     window 4096: B=2 S=T=1160, B=1 S=T=4700, and B=2 T=4700 with 700
     right-padded keys; bf16 bit for bit on relaunch); the int8 weight
     matmul (kernel 14: GEMV at M = 1, 4, 8, 16, the design gemv_path picks
     (the tensor-core GEMV, or the pair for fp32 x and the shapes where it
     is faster), the wgmma tile at M = 17, 260, 1040, the four 1B
     projection shapes, bf16 and fp32, with and without bias; two launches
     bit for bit) and the int8-cache decode attention; the 8B's
     shapes: decode at G = 9 (36 query heads over 4 KV heads; B=4 T=708,
     B=1 T=8192 past the 4096 window, a ragged mask; over a bf16 and over
     an int8 cache, with the int8 P-rounding case) and flash_prefill at
     H=36 Hkv=4 with the window (B=4 S=T=580; B=1 S=1024 at q_offset 7168 of
     T=8192), kernel 14 at the six 8B projections' four shapes (M = 1, 4,
     580, 2320), fp32 and bf16, bf16 bit for bit on relaunch; flash_prefill
     and decode at phase 4f's prefix lengths, B=2, S=T in {51, 198, 1026};
     kernel 2 with its key bounds read from the device (bounds, the grid
     planned at a larger t_cap) at G = 16 and 9, over a bf16/fp32 and an
     int8 cache, t_end well inside t_cap and a window's t_begin > 0, and
     one launch captured in a CUDA graph, replayed as the bounds move, bit
     for bit against fresh launches;
     a tensor rank's shapes (phase 6e): flash_prefill at H = 9, 5, 4 over
     Hkv = 1 with the window and at the 1B's H = 8, 2 (B=2 S=T=1024,
     right-padded), decode at G = 9 over Hkv = 1 (32 slots), over an int8
     cache at G = 5 and 4 (16 slots), and at the 1B's G = 8 and 2 over
     either cache; kernel 14 at a tensor-8 rank's slices of both models
     (row-parallel ones with an fp32 result and no bias), the GEMV at M = 1,
     4, 8, 16 and the tile at an admission's rows, bit for bit on relaunch; the
     training pair at a tensor rank's heads (phase 5g): the 1B's H = 8, 4
     and 2 over its KV head (B=4 S=T=769) and the 8B's 18 over 2, 9, 5 and
     4 over 1 (B=1 S=T=4700, window 4096), fp32 and bf16, bf16 bit for bit
     on relaunch, with dkdv_head_split's pick at each; and at a pipeline
     stage's microbatch (phase 5g's 1b-stage2-fsdp2: B=1 S=T=769, H=16
     over 1)
  4. inference at full StarVector-1B width (GPTBigCode 2048 x 24 layers,
     CLIP ViT-L/14 at 224, BatchNorm adapter) on random weights from a
     seeded torch.Generator: 3 requests of 4 images through
     StarVectorForCausalLM.generate_im2svg_ids, with launch counts; fp32
     greedy ids against the plain attention; bf16 prefill logits against it.
     Then int8: the decoder quantized with quantize_tree, 3 requests of 4
     images with an int8 cache through engine.generate, with launch counts
     (96 int8 matmuls per prefill and per decode step, 24 int8-cache decode
     launches per step); fp32 greedy ids kernels vs plain; bf16 prefill
     logits against the fp32 plain int8 path; greedy agreement with bf16.
     text2svg on the bf16 weights: a request of 4 captions (6-30 tokens
     through the byte-level test tokenizer) and one of 1 through
     generate_text2svg_ids, the prompts through the chunk step (no
     flash_prefill), 24 decode_attention a step; fp32 greedy ids kernels vs
     plain. Last, beside the card's name and power limit: p50 B=1 latency
     and B=4 decode tokens/s for bf16 im2svg, int8 and text2svg in turns,
     and the memory of bf16 and int8; the 1B inference trees are then
     released
  4b. the decoding variants at full 1B width on the first 8 of phase 4's 24
     layers (DEPTH_1B_EARLIER, as in 4c and 4d), each with exact launch
     counts: beam search (num_beams=2, B=2: flash_prefill over
     B x K = 4 rows, decode_attention a step; fp32 ids kernels == plain);
     num_return_sequences=4 over B=2 (the prefill once at 2 rows, the steps
     at 8; greedy groups identical, in fp32 equal to the n=1 rows), also
     over the int8 decoder and an int8 cache (kernel 14's GEMV at M = 8,
     kernel 2 over the tiled codes and scales); speculative decoding at B=1
     and B=4, its verify rounds as CUDA graphs (flash_prefill only;
     n_forwards; fp32 ids, lengths and n_forwards graphed == uncaptured,
     ids == plain greedy; the bf16 rows that part from it; each loop's
     uncaptured and graphed wall a round); with --timings B=1 latency of
     greedy, speculative and
     beam, and B=4 tokens/s of greedy and speculative, in turns; then GRPO:
     one GRPOTrainer.step (B=2, G=4, 64 new tokens, a synthetic target
     raster, on its own tree at all 24 layers: the rollout's kernels 1 and
     2, the update's 48 forwards and 24
     backward pairs under remat "dots"; the decoder alone moves; rollout,
     reward and update wall time, peak memory), and one fp32 update on one
     rollout with the kernels against the plain attention
  4c. continuous-batching serving (serve/engine.py) on phase 4's weights
     (their first 8 layers), before they are released: fp32, 4 concurrent
     requests of prefixes of 260-291 tokens (one admission group, one
     chunk), 32 greedy tokens with the stop: ids equal offline
     generate_im2svg_ids at B=1 and the engine with the plain attention,
     launches exactly 8 flash_prefill a chunk and 8 decode_attention a
     ragged step (ticks x steps_per_tick); int8 weights and cache: fp32 ids
     equal offline int8 generate's, bf16 launches 32 quant_matmul a step and
     a chunk and 8 int8-cache
     decode_attention a step; a bf16 mixed batch under speculative ticks
     (greedy, sampled, stop, logit_bias, beam K=2, drafts from prompt ids),
     every request done; the REST worker and controller (standard-library
     servers on 127.0.0.1): 4 concurrent streamed requests through the
     controller's relay and /v1/chat/completions; then, beside the card's
     name and power limit, 8 concurrent greedy requests of 128 tokens at
     steps_per_tick 1 and 4 in turns with offline generate at B=8 (tokens/s,
     p50 time to first token, p50 latency), int8 serving beside bf16 (with
     --profile DIR, a tick's device-busy share). Any request that ends in
     an error fails the run
  4d. the eval harness (validation/, metrics/) on phase 4's weights (their
     first 8 layers), before they are released: the in-process validator
     over 8 samples (the probe SVGs as ground truth, seeded synthetic
     images as input), B=2, 64
     greedy tokens, configs/metrics/im2svg.yaml's metrics with LPIPS and FID
     on full-size random VGG16 / InceptionV3 weights in a temporary
     STARVECTOR_METRICS_DIR: bf16 texts and ids equal offline
     generate_im2svg's on the same batches, 8 flash_prefill a batch and 8
     decode_attention a step, the output tree and every configured key;
     fp32 texts and ids with the kernels equal the plain attention's;
     LPIPS-VGG16 at 224 and InceptionV3 pool3 at 299 on the card against
     the CPU in fp32 without TF32, and the FID from either's features; the
     REST validator through the port's worker and controller serving the
     fp32 copy, each text equal to offline fp32 generate_im2svg at B=1;
     whether librsvg/cairo is there, and the validator's seconds a sample by
     stage, LPIPS and Inception ms on the card and the CPU, the REST
     validator's seconds a sample, beside the card's name and power limit
  4e. offline pipelined generation on phase 4's weights at 8 of their 24
     layers (DEPTH_1B_EARLIER, since PR 21), before they are
     released: 4 batches of B=16, P=1024 random prompt embeddings, 128
     greedy tokens, C=8, through generate_pipelined (every step of a batch
     but the last the static fused decode+chunk step: kernel 2 with its
     bounds on the device and the chunk step; the last batch's static
     decode steps; one CUDA graph a kind and key bucket, captured once a
     stream: 4 batches capture as many as 2); fp32 ids graphed ==
     uncaptured bit for bit with the same launches, == per-batch
     generate's and == the plain attention's, launches exactly 8
     flash_prefill (batch 0) and 8 decode_attention a decode step; bf16
     launches and each row's first token parting from per-batch generate;
     the stream's uncaptured and graphed wall a step beside its device
     time; int8 weights over an fp32 cache, fp32 ids ==
     per-batch generate's; an int8 KV cache, and int8 weights with it, in
     fp32: 16 teacher-forced fused steps' logits, kernels against plain,
     within twice generate's route's own gap, and batch 1's first decode
     step over the cache the fused steps wrote, kernels against plain, to
     TOL; bf16 launches exact over kernel 2' and kernel 14 (GEMV and tile
     by rows); generate_pipelined_spec over 3 batches of 8 right-padded
     prompts, its rounds graphed (fp32 ids and rounds graphed ==
     uncaptured, ids == generate_pipelined's and per-batch generate's;
     bf16 rounds, tokens a round, launches: kernel 1 for batch 0 only, no
     kernel 2; captures of 3 batches == 2's; its line); tokens/s of serial
     generate, generate_pipelined and its int8 KV, one run each; with
     --timings a fused step against the unfused pair (the decode forward,
     then the chunk step), 10 pairs of 8-step blocks in alternating order
     (with --profile DIR, a fused step's and a decode-only step's wall
     against device time)
  4f. the other vision towers behind phase 4's 1B decoder (all 24 layers):
     vqgan, convnext and open-clip at 224, siglip_512 and siglip_256, each
     at its stock geometry with seeded random tower and adapter weights: the
     bf16 tower forward within TOWER_REL_TOL of fp32 and both timed at B=2;
     bf16 greedy generate_im2svg_ids at B=2, 32 tokens, launches exactly 24
     flash_prefill at S = qlen + 2 (none at convnext's 51: the chunk step)
     and 24 decode_attention a step; fp32 greedy ids kernels == plain on
     the first 8 layers, 16 tokens
  5. training at full 1B width (fp32 masters, bf16 compute, dots_flash
     remat, AdamW): 8 steps of the port's train loop on one synthetic batch
     (T = 257 + 512 = 769), loss falling, 24 launches per step of each
     training kernel, peak memory (also above what was held before it);
     then 2 fp32 steps with the kernels against 2 with the plain attention
  5b. the export round trip: the trained 1B through train/hub.py's
     export_hf_checkpoint into a temporary directory (the reference HF
     layout), back through models/builder.py's load_pretrained_model at
     fp32: fp32 greedy ids for 2 images equal those of the in-memory
     weights, with flash_prefill and decode_attention launched
  5c. the entry points on 5b's directory (bf16, all 24 layers):
     quickstart.main (one image, 64 tokens, stdout captured: the SVG it
     prints, 24 flash_prefill, 24 decode_attention a step, its load and
     generation seconds); quickstart_serve.serve_images on the model it
     loaded (4 images, 128 tokens, every request done, 24 flash_prefill an
     engine chunk and 24 decode_attention a step); the web UI over a
     ModelWorker on 127.0.0.1 (one streamed im2svg request of 32 tokens
     through /api/generate, one vote in votes.jsonl); the directory is
     then deleted
  5d. the GRPO driver, train.grpo.main, on configs/models/starvector-1b/
     im2svg-grpo.yaml at full 1B width and depth (ToySVGDataset at 224 px,
     B=2, G=2, 64 tokens, 2 steps, a checkpoint at step 2): 2 steps logged,
     checkpoint-2 restored to the trainer's parameters bit for bit, kernels
     1, 2, 5 and 6 launched; its steps' seconds
  5e. data-parallel / ZeRO-3 training's path on one card: train.main on
     configs/models/starvector-1b/im2svg-icons.yaml at full 1B width and
     all 24 layers, bf16 compute, dots_flash, B=2, T=257+512=769, 3 steps,
     in a process group of world size 1 over NCCL (torchrun's variables;
     mesh fsdp: -1, parameters and AdamW state registered as shards, the
     loss's count, the BatchNorm statistics and the gradients summed over
     the one rank) and again as one plain process: each step's loss and the
     parameters after the last equal (the first loss bit for bit, the rest
     1e-4 relative, each parameter within AdamW's two steps of lr a step);
     24 + 24 + 24 launches of kernels 5 and 6 a step; the mesh run's peak
     memory and seconds. The multi-rank layouts need a second card (NCCL
     takes one rank a device) and are held on the CPU over gloo
     (tests/test_torch_fsdp_train.py, tests/test_torch_parallel.py)
  5f. sequence parallelism's per-rank attention at StarVector-8B's width
     (im2svg-stack-v5e8.yaml: sequence 2; H=36 over Hkv=4, window 4096,
     bf16, B=1), the two ranks one after the other in this process through
     parallel/sequence.py::sp_chunk_attention (what sp_flash_attention runs
     after its all-gather), the gather's result and the reduce-scatter's
     sum formed by hand, at S_total = 576 + 8192 and 576 + 4096: out and dQ
     concatenated and dK, dV summed equal one unsharded
     flash_prefill_trainable (phase 3's bf16 tolerance for the training
     kernels); each rank's chunk, fp32, kernels == plain (1e-4); every
     launch of rank 1 at q_offset = S_total / 2; each rank's and the
     unsharded forward + backward times. The multi-rank path itself is held
     on the CPU over gloo (tests/test_torch_sequence_parallel.py)
  5g. tensor- and pipeline-parallel training: TPT_WORLD = 4 processes on
     the one card over a gloo group (as 6e), each on its tensor slices of
     the whole tree (decoder, vision tower, adapter; parallel/tensor.py's
     two collectives under autograd) or its stage's block of the decoder's
     layers (parallel/pipeline.py's GPipe ticks), against one process on
     the same card, weights and batch (run first, its state released
     before the ranks start), both with the kernels, fp32, 2 steps:
     1b-fsdp2-tp2 (fsdp 2 x tensor 2; the 1B at full width, 4 of its 24
     decoder layers, the whole CLIP ViT-L/14 and the BatchNorm adapter;
     AdamW, dots_flash, B=4, T=769), 1b-stage2-fsdp2 (fsdp 2 x stage 2;
     the same model, weights and batch: 2 layers a stage, each rank's 2
     rows 2 microbatches of 1) and 8b-tp4 (tensor 4; the 8B at full width,
     2 of 32 layers, SigLIP-L/16, the LayerNorm adapter; Adafactor,
     dots_flash, B=1, T=4700 past the window): each step's loss and grad
     norm within rtol 1e-4 on every rank, the parameters gathered whole
     within fp32 TOL; each rank launches the forward with lse and the
     backward pair once a decoder layer a step at its heads (8 over 1;
     9 over 1), and on the stage mesh once a layer of its stage a
     microbatch, at B=1 and 16 over 1; each rank's microbatches and peak
     memory; walls are gloo's
  6. inference at full StarVector-8B width (StarCoder2-7B 4608 wide, GQA
     36/4, window 4096; SigLIP-L/16 at 384; LayerNorm adapter) and 8 of its
     32 decoder layers (DEPTH_8B) on random bf16 weights that
     StarVectorForCausalLM.from_config draws on the card from a seed: 3
     requests of 4 images with launch counts (8 flash_prefill a prefill, 8
     decode_attention a step); bf16 prefill logits against the fp32 plain
     ones and fp32 greedy ids kernels vs plain on an fp32 copy; the
     window at full width (2 layers, a 4700-token prefix, fp32
     ids kernels vs plain); text2svg as in phase 4 (8 decode_attention a
     step; its fp32 check on the same fp32 copy); beam search (num_beams=2,
     B=1: flash_prefill over 2 rows, decode_attention at G = 9) and
     speculative decoding (B=1, and B=4 through StarCoder2's
     forward_ragged_verify; the rounds graphed: fp32 ids, lengths and
     n_forwards == uncaptured, each loop's line), fp32 ids kernels ==
     plain on the same copy;
     p50 B=1 latency, B=4
     tokens/s of im2svg and text2svg in turns, and memory. Then int8: the
     decoder through quantize_tree, consuming the bf16 tree, with an int8
     KV cache: requests of 4 images and of 1 with launch counts (48
     quant_matmul a prefill and a decode step, 8 flash_prefill a prefill,
     8 int8-cache decode_attention a step); in fp32, kernels vs plain,
     greedy ids with an fp32 KV cache and, with the int8 cache, the logits
     of both fed the same tokens (INT8_CACHE_LOGIT_TOL); weights and
     memory, p50 and tokens/s beside bf16's. Pipelined generation
     (before 6d): batches of B=2 prefixes, 32 tokens, each step the static
     decode step and the static chunk step (StarCoder2 has no fused
     forward), as CUDA graphs: fp32, 2 batches, ids graphed == uncaptured
     with the same launches, == per-batch generate's and the plain
     attention's; bf16, 3 batches, launches 8 flash_prefill (batch 0) and 8
     decode_attention a decode step, captures == 2 batches'; its line; the
     port's NotImplementedError from generate_pipelined_spec; with
     --timings tokens/s of serial and pipelined at 3 batches of B=4, 128
     tokens. 6d, serving on the same
     weights: 4 concurrent bf16 requests (launches 8
     flash_prefill a chunk, 8 decode_attention at G = 9 a ragged step),
     fp32 engine ids equal offline generate's on the fp32 copy, the window
     at 2 layers in fp32 (a 4700-token prefix admitted in 8 chunks beside a
     579-token one, decoded past the 4096-key window in the row's mask: ids
     with the kernels == plain), tokens/s beside offline B=4. 6e, serving
     over a tensor mesh: TP_WORLD = 8 processes on the one card over a gloo
     group the phase makes (NCCL takes one rank a card; gloo takes CUDA
     tensors for the all-reduce and broadcast this path uses), the trees
     shared by CUDA IPC, each rank through the functions serve/worker.py's
     main calls, five runs (TP_CONFIGS): the 8B's tp4dp2 in fp32 (2
     replicas of tensor 4, 32 slots; 9 query heads over 1 KV head a rank)
     and the 1B's 1b-tp2dp4 in fp32 (phase 4c's trees drawn again: 4
     replicas of tensor 2; 8 query heads over the KV head), the first-step
     logits within fp32 TOL of one process, the greedy requests' ids == the
     one-process fp32 engine's, and on the 1B one use_speculative request
     through the group's engine whose ids and forward count equal one
     process's; the 8B's tp8-int8kv in bf16 (tensor 8, 16 slots, int8
     cache; 5 or 4 query heads over 1 KV head), 1b-tp8-int8 (the 1B's
     quantize_tree sliced, int8 cache; 2 query heads a rank) and
     tp8-int8kv-q (the 8B's leaf with --quantize: each rank quantizes its
     own slices, a row-parallel column's scale from the group's maximum),
     teacher-forced logits against one process's within twice its own
     kernels-vs-plain gap plus 1e-3, and the greedy agreement of the
     engines' ids; then three sharded runs, each data group one engine
     over its ranks, the decoder's weights as the JAX rules place them
     and gathered at use: 1b-fsdp4dp2 (bf16, 2 data groups of fsdp 4, 8
     of 24 layers: each group's first-step logits and greedy ids bit for
     bit one process's with the group's slots and requests),
     1b-stage2-seq2-tp2 (fp32, stage 2 x sequence 2 x tensor 2: as
     1b-tp2dp4, with a use_speculative request) and 8b-fsdp8-int8 (the
     8B's first 2 layers, bf16, fsdp 8, each rank quantizing its own
     shards: its codes and scales its shards of quantize_tree's,
     teacher-forced logits and greedy ids bit for bit one process's, int8
     cache); every rank's launches equal its leader's run (kernel 1 a
     layer an admission, kernel 2 / 2' a layer a step, kernel 14 a
     projection a layer a forward) and its resident decoder bytes beside
     the whole tree's; wall times are gloo's over one card, no serving
     speed
  6b. training at full StarVector-8B width and 8 of its 32 decoder layers
     (SigLIP-L/16 and the LayerNorm adapter trainable; fp32 masters, bf16
     compute, dots_flash, AdamW; B=1, T = 576 + 7616 = 8192, past the 4096
     window): 8 steps of the port's train loop on one batch, loss falling,
     8 launches a step of each training kernel, peak memory; one loss and
     backward with remat=True (16 forwards); then 2 fp32 steps at 2 layers,
     T = 4700, kernels against plain
  6c. the 8B's own recipe at full width and all 32 decoder layers, read
     from configs/models/starvector-8b/im2svg-stack-v5e8.yaml through the
     functions train.main uses: Adafactor, bf16 gradients (grad_dtype),
     dots_flash (or the yaml's fallback, full remat, if that does not fit;
     then the deepest depth that fits), fp32 masters, bf16 compute; lr
     raised and warmup dropped so that the loss falls in 5 steps; B=1,
     T = 8192 on phase 6b's batch: loss falling at every step, the training kernels'
     launches a step, step time, tokens/s and peak memory beside the
     state's bytes (masters, bf16 cast, bf16 gradients, Adafactor)
  7. times on the card, each beside the card's name and power limit (with
     --timings all of what follows; without, the sweeps named above
     stay out): each
     kernel against its plain version, its bound and one PyTorch library
     call where there is one (the 8B's at its shapes too; kernel 14's GEMV
     in both designs, in turns, at M = 1, 4, 8, 16 over weight copies past
     the L2, with each design's host cost a call; its tile also at M = 144,
     a fused step of phase 4e), the 1B and 8B
     train steps and the training kernels at the 8B's (S = T = 8192, H=36,
     Hkv=4, window 4096; dkdv at each head split beside the plan's pick),
     flash_prefill at siglip_512's prefix (B=2, S=T=1026) beside SDPA,
     a tensor rank's kernel 1 (H = 9, 5, 4; the 1B's 8 and 2) and kernel 2
     (G = 9; 5 and 4 over an int8 cache; the 1B's 8 and 2) beside their
     bounds and SDPA with enable_gqa, kernel 14 at a tensor-8 rank's
     slices (a layer's projections, GEMV and tile) beside bf16 addmm and
     _weight_int8pack_mm, the training pair at 5g's rank heads (the 1B's
     H = 8 at B=4 T=769; the 8B's H = 9 over 1 at B=1 T=4700, window)
     and at 5g's pipeline microbatch (B=1 T=769 H=16) beside SDPA with
     enable_gqa,
     also the training kernels at the long contexts phase 3 drives (with
     --profile DIR, also where a decode step's and the 1B and 8B train
     steps' device time goes)
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Fixed token ids stand in for the tokenizer: the "<svg" prompt and the
# "</svg>" stop sequence (no tokenizer file is needed on the card).
PROMPT_IDS = (44, 5727, 2262)
STOP_IDS = ((1053, 5727, 48),)
# Decoder projections are scaled up from the 0.02 init so that greedy
# decoding on random weights does not collapse onto one repeated token
# (tests/test_torch_im2svg.py scales them by 10 at tiny width); phase 4
# prints the distinct ids per row that this scale gives.
PROJ_SCALE = 3.0
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}  # (atol, rtol) per dtype
# decode_attention (bf16 or int8 cache): rtol 2^-7 is one bf16 step of the
# output, atol 2e-3 p rounded to bf16 against each warp's running max where
# the plain version uses the global max; 2e-2 would pass a dropped self
# token at T >= 1285, where outputs are ~0.02-0.04 (the CPU test
# test_decode_tolerance_tells_a_dropped_token_or_split holds this limit)
DECODE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2**-7)}
# quant_matmul (kernel 14, GEMV and tile): the fp32 sums differ from the
# plain version's only in order, which can move a bf16 result across one
# rounding boundary (one bf16 step, 2^-7 relative at most; atol for results
# near zero); 2e-2 would pass a kernel that drops or repeats a 16-row slab
# of q (tests/test_torch_quantization.py::
# test_qmm_tolerance_tells_a_dropped_or_repeated_k_slab holds this limit)
QMM_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2**-7)}
# the 8B's fp32 logits over an int8 KV cache, kernels against plain, fed the
# same tokens: the two paths' k/v differ by fp32 sum order, so some round to
# the next code (a scale step, 1/127 of the row's max |x|), and the flips
# grow layer by layer: 0.026-0.049 at 32 layers on the H100 (PERF.md
# section 6), against 2e-5-4e-5 with an fp32 cache; the limit is twice the
# largest
INT8_CACHE_LOGIT_TOL = 0.1
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W): the bound of
# a kernel is max(bytes / HBM rate, operations / dense bf16 tensor rate)
# --timings: the work whose only output is a time, off in the default run
# (phase 4's and 6's serving p50 / tokens/s and memory turns, 4b's request
# turns, 4e's fused-step timing, and phase 7's sweeps: tile plans, the
# 96-projection prefill graph, the siglip_512 prefix, the long-context
# backward and the dkdv head_split sweep); every check, launch count and
# kernel row stays in the default run
TIMINGS = False

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores (the fp32 kernels' CUDA-core path)


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for work that must
    move `nbytes` and do `flops` at `flop_rate`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_only(what: str, t0: float) -> None:
    """Log the seconds of `what`, work that runs only with --timings."""
    log("phase", f"--timings: {what} took {time.perf_counter() - t0:.1f} s")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    """Device time of one fn() call in ms: `iters` calls captured in a CUDA
    graph and replayed between two CUDA events, so the host's per-call
    launch cost (tens of microseconds here) is not what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: cuBLAS handles, allocator
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_COUNTS = ("flash_prefill", "decode_attention", "flash_prefill_with_lse",
                 "flash_bwd_dkdv", "flash_bwd_dq")
TRAIN_KERNELS = ("flash_prefill_with_lse", "flash_bwd_dkdv", "flash_bwd_dq")
QMM_PATHS = ("gemv_tc", "gemv", "wgmma", "f32_tile")


def reset_counts(tfa) -> None:
    from starvector_tpu_torch.generation import graphs
    from starvector_tpu_torch.ops import quantization as tq

    graphs.reset_tally()
    for name in KERNEL_COUNTS:
        getattr(tfa, name).launches = 0
    tfa.decode_attention.int8_launches = 0
    tq.quant_matmul.launches = 0
    tq.quant_matmul.path_launches.update(dict.fromkeys(QMM_PATHS, 0))


def read_counts(tfa) -> dict:
    """Every wrapper's launches since reset_counts: the attention kernels,
    the int8-cache share of decode_attention, and quant_matmul in all and by
    path. A CUDA graph's capture runs the wrappers (their counts move) but
    launches nothing, and its replays launch without them: each graph
    records what its capture counted, so the launches are the counts less
    the captures' plus the replays' (generation/graphs.py::true_launches).
    The wrappers are read where tfa holds them (a rehearsal may swap them)."""
    from starvector_tpu_torch.generation import graphs
    from starvector_tpu_torch.ops import quantization as tq

    counts = {name: getattr(tfa, name).launches for name in KERNEL_COUNTS}
    counts["decode_attention_int8"] = tfa.decode_attention.int8_launches
    counts["quant_matmul"] = tq.quant_matmul.launches
    counts.update({f"quant_matmul_{k}": v for k, v in tq.quant_matmul.path_launches.items()})
    return graphs.true_launches(counts)


def graphs_captured() -> int:
    """The CUDA graphs captured since reset_counts."""
    from starvector_tpu_torch.generation import graphs

    return graphs.tally()["captures"]


def graph_tally() -> str:
    """The CUDA graphs captured and replayed since reset_counts."""
    from starvector_tpu_torch.generation import graphs

    t = graphs.tally()
    return f"{t['captures']} graphs captured, {t['replays']} replays"


def decode_steps(tokens: torch.Tensor, lengths: torch.Tensor) -> int:
    """The decode steps generate ran for rows of these lengths out of n =
    tokens.shape[1] new tokens: n - 1 while a row runs to n, else every step
    up to the end of the block (generation/engine.py::decode_blocks) in
    which the last row stopped, since the host reads `done` once a block."""
    from starvector_tpu_torch.generation.engine import DECODE_GRAPH_STEPS, decode_blocks

    n, last = tokens.shape[-1], int(lengths.max())
    if last >= n:
        return n - 1
    end = 0
    for steps in decode_blocks(n, DECODE_GRAPH_STEPS):
        end += steps
        if end >= last:
            return end
    return n - 1


def kernel_tag(mangled: str) -> str:
    """What tells a kernel's instantiations apart, from its mangled name:
    ' int8 cache' for decode_attention_{bf16,f32}_kernel<int8_t, G> and
    ' G=16', ' G=9', ' G=8', ' G=5', ' G=4' or ' G=2' for its query heads
    per KV head; for the
    int8 matmul its first template argument ('<bf16>' or '<f32>': x's type
    for the GEMV pair, the output's for the tile, finish and tensor-core
    GEMV kernels, marked 'out'), for the GEMVs ' rows<=MR' (and the
    tensor-core one's rows of K a unit / 64, ' ku4') and for the wgmma
    tile ' xBX' (its rows of x a block); nothing for the flash kernels,
    whose type is in their names."""
    if "decode_attention" in mangled:
        group = re.search(r"decode_attention_(?:bf16|f32)_kernelI(?:13__nv_bfloat16|a|f)Li(\d+)E",
                          mangled)
        int8 = re.search(r"decode_attention_(bf16|f32)_kernelIa", mangled)
        return (" int8 cache" if int8 else "") + (f" G={group.group(1)}" if group else "")
    if "qmm_" not in mangled:
        return ""
    first = re.search(r"kernelI(13__nv_bfloat16|f)", mangled)
    out = "out " if re.search(r"qmm_(wgmma|f32|finish|gemv_tc)_kernel", mangled) else ""
    tag = f"<{out}bf16>" if first and first.group(1) != "f" else f"<{out}f32>"
    rows = re.search(r"qmm_gemv_kernelI(?:13__nv_bfloat16|f)Li(\d+)E", mangled)
    tile = re.search(r"qmm_wgmma_kernelI(?:13__nv_bfloat16|f)Li(\d+)E", mangled)
    tc = re.search(r"qmm_gemv_tc_kernelI(?:13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", mangled)
    return (tag + (f" rows<={rows.group(1)}" if rows else "")
            + (f" x{tile.group(1)}" if tile else "")
            + (f" rows<={8 * int(tc.group(1))} ku{tc.group(2)}" if tc else ""))


KERNEL_NAMES = ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel",
                "decode_attention_bf16_kernel", "decode_attention_f32_kernel",
                "flash_bwd_dkdv_bf16_kernel", "flash_bwd_dkdv_f32_kernel",
                "flash_bwd_dkdv_finish_kernel", "flash_bwd_dq_bf16_kernel",
                "flash_bwd_dq_f32_kernel", "qmm_gemv_kernel", "qmm_gemv_tc_kernel",
                "qmm_finish_kernel", "qmm_wgmma_kernel", "qmm_f32_kernel")


def ptxas_summary(log_text: str) -> list[str]:
    """'<kernel><type>: N registers, S bytes spilled' for each kernel ptxas
    compiled, read from its -v output; then any kernel whose wgmma products
    ptxas serialized, with its reason."""
    out, name, spill, serialized = [], None, 0, []
    for line in log_text.splitlines():
        if "wgmma" in line and "serialized" in line:
            mangled = line.rsplit("'", 2)[-2] if line.count("'") >= 2 else ""
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled[:40])
            serialized.append(f"{base}: wgmma serialized ({line.split(':', 1)[-1].strip()[:160]})")
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled[:40])
            # the attention tensor-core and CUDA-core kernels carry their type in the name
            name = base + kernel_tag(mangled)
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name is not None:
            regs = int(line.split("Used")[1].split()[0])
            out.append(f"{name} {regs} registers, {spill} bytes spilled")
            name, spill = None, 0
    return out + serialized


TENSOR_CORE_KERNELS = ("flash_prefill_bf16_kernel", "flash_bwd_dkdv_bf16_kernel",
                       "flash_bwd_dq_bf16_kernel")
CUDA_CORE_KERNELS = ("flash_prefill_f32_kernel", "flash_bwd_dkdv_f32_kernel",
                     "flash_bwd_dq_f32_kernel")
# decode_attention's instantiations: bf16 queries on the warp-level tensor
# cores (mma.sync: HMMA), fp32 queries on the CUDA cores (none)
DECODE_TAGS = tuple(f"{cache}G={G}" for G in (16, 9, 8, 5, 4, 2)
                    for cache in (" ", " int8 cache "))
HMMA_KERNELS = tuple(f"decode_attention_bf16_kernel{tag}" for tag in DECODE_TAGS)
NO_HMMA_KERNELS = tuple(f"decode_attention_f32_kernel{tag}" for tag in DECODE_TAGS)


def sass_counts(lib: Path, nvcc: str) -> dict[str, dict[str, int]]:
    """The tensor-core instructions of each kernel instantiation in the
    built library's machine code, from the toolkit's cuobjdump beside nvcc:
    {name (+ kernel_tag): {"HGMMA": warpgroup products, "HMMA": warp products}}."""
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            mangled = line.split("Function : ", 1)[1].strip()
            base = next((k for k in KERNEL_NAMES if k in mangled), None)
            name = None if base is None else base + kernel_tag(mangled)
            if name is not None:
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
    return counts


def compare(what: str, out: torch.Tensor, ref: torch.Tensor, dtype, live=None,
            tols=TOL) -> float:
    """Raise unless |out - ref| <= atol + rtol*|ref| on the live rows, with
    (atol, rtol) = tols[dtype]; return max |out - ref|."""
    if live is not None:
        out, ref = out[live], ref[live]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    atol, rtol = tols[dtype]
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max |diff| {err.max().item():.3e}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash_prefill(tfa, dev) -> float:
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # name, B, S, T, H, Hkv, q_offset, window, left_pad
        ("1B prefill", 4, 261, 261 + 128, 16, 1, 0, None, 0),
        ("1B pipelined batch 0 (4e)", 16, 1024, 1024 + 128, 16, 1, 0, None, 0),
        ("S=37", 2, 37, 37, 16, 1, 0, None, 0),
        ("T=53 not a tile multiple", 2, 37, 53, 16, 1, 0, None, 0),
        ("q_offset=100", 2, 37, 200, 16, 1, 100, None, 0),
        ("left-padded keys", 2, 64, 100, 16, 1, 0, None, 9),
        ("window=32", 2, 100, 100, 16, 1, 0, 32, 0),
        ("GQA Hkv=4", 2, 70, 70, 16, 4, 0, None, 0),
        # phase 4f's prefixes: qlen + 2 prompt ids of convnext, vqgan, siglip_512
        *((f"tower prefix S=T={S}", 2, S, S, 16, 1, 0, None, 0) for S in TOWER_PREFIXES),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, H, Hkv, q_off, window, pad in cases:
            # q as the decoder passes it: a strided view of the fused c_attn
            # output [q | k | v], rows H*D + 2*Hkv*D apart
            qkv = torch.randn((B, S, (H + 2 * Hkv) * 128), generator=g, device=dev).to(dtype)
            q = qkv[..., :H * 128].unflatten(-1, (H, 128))
            k = torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype)
            v = torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype)
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, q_off + S:] = 0   # unwritten cache tail
            mask[:, :pad] = 0
            out = tfa.flash_prefill(q, k, v, mask, q_off, window=window)
            ref = tfa.flash_prefill(q, k, v, mask, q_off, window=window, kernels=False)
            torch.cuda.synchronize()
            live = torch.arange(S, device=dev)[None, :] + q_off >= pad  # rows that see a key
            live = live.expand(B, S)
            err = compare(f"flash_prefill {name} {dtype}", out, ref, dtype, live)
            worst = max(worst, err)
            log("kernels", f"flash_prefill {name} {str(dtype)[6:]}: max |diff| {err:.3e}")
    return worst


# phase 4f's prefix lengths at B = 2: qlen + 2 prompt ids of convnext (49),
# vqgan (196) and siglip_512 (1024); open-clip's and siglip_256's are 258
TOWER_PREFIXES = (51, 198, 1026)
# B, T; (16, 1152) is phase 4e's pipelined decode: B = 16, Pn 1024 + 128 new tokens
DECODE_CHECKS = ((1, 1), (4, 300), (1, 1285), (8, 1285), (16, 1152), (4, 2049), (4, 4100),
                 *((2, T) for T in TOWER_PREFIXES))


@functools.lru_cache(maxsize=1)
def p_rounding_cases():
    """tests/test_torch_flash_attention.py, loaded from its file (an
    installed package may own the name `tests`): the P-rounding cases its
    GPU-marked tests build (it imports no JAX at module level)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "test_torch_flash_attention.py"
    spec = importlib.util.spec_from_file_location("p_rounding_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_decode_attention(tfa, dev) -> float:
    """decode_attention against its plain version, fp32 and bf16: the cache
    with the self token (merged_decode_attention), then a window whose edges
    fall inside the grid's chunks (gqa_decode_batched); row 0 left-padded,
    and at T > 256 a masked run that empties a whole 128-key chunk of the last
    row. Then the P-rounding case (bf16 must give the rounded-P value
    exactly) and two bf16 launches at B=8 T=1285 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(2)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in DECODE_CHECKS:
            qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, : T // 5] = 0  # left padding
            if T > 256:
                mask[-1, 100:300] = 0  # a whole chunk of the grid sees no key
            # (b) merged_decode_attention: the cache plus the self token
            out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
            ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, kernels=False)
            torch.cuda.synchronize()
            err_b = compare(f"merged decode B={B} T={T} {dtype}", out, ref, dtype,
                            tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16 and (B, T) == (8, 1285):
                again = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
                # what the limit refuses: the plain result without the self token
                dropped = tfa.decode_attention(qg, k, v, mask, kernels=False).reshape(ref.shape)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"decode B={B} T={T} {dtype}: two launches differ")
                atol, rtol = DECODE_TOL[dtype]
                gap = (dropped.float() - ref.float()).abs()
                n_off = int((gap > atol + rtol * ref.float().abs()).sum())
                if not n_off:
                    raise AssertionError("decode: the tolerance passes a dropped self token")
                same = (f"; a second launch gives the same bits; a dropped self token reads "
                        f"max |diff| {gap.max().item():.3e}, {n_off} elements past the limit")
            # (a) gqa_decode_batched: valid length and window start, no self token
            q = qg.reshape(B, G, D)
            lo, hi = T // 8, max(T - 3, 1)
            out = tfa.gqa_decode_batched(q, k, v, mask, hi, lo)
            ref = tfa.gqa_decode_batched(q, k, v, mask, hi, lo, kernels=False)
            torch.cuda.synchronize()
            live = (mask[:, lo:hi] > 0).any(dim=1)
            err_a = compare(f"gqa decode B={B} T={T} {dtype}", out, ref, dtype, live,
                            tols=DECODE_TOL)
            worst = max(worst, err_a, err_b)
            log("kernels", f"decode_attention B={B} T={T} {str(dtype)[6:]}: "
                           f"merged max |diff| {err_b:.3e}, batched max |diff| {err_a:.3e}{same}")
    # P rounded to bf16 before P V: the case the GPU-marked test builds
    (qg, k, v, mask), want, unrounded = p_rounding_cases()._p_rounding_inputs(dev)
    out = tfa.decode_attention(qg, k, v, mask)
    ref = tfa.decode_attention(qg, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    got = out[..., 0].double().unique().tolist()
    if got != [want] or ref[..., 0].double().unique().tolist() != [want] or (out[..., 1:] != 0).any():
        raise AssertionError(f"P rounding: kernel {got}, plain {ref[..., 0].unique().tolist()}, "
                             f"JAX's value {want}, fp32 P's {unrounded}")
    log("kernels", f"decode_attention bf16 P rounding: two visible keys in one chunk of T=325 "
                   f"(the other chunks see none): kernel {want!r} == plain == JAX's rounded-P "
                   f"value, not the fp32-P value {unrounded!r}")
    return worst


# M of kernel 14's checks: the GEMV and its edge, phase 4e's chunk-only, fused and
# batch-0 prefill rows (B = 16: 16 x 8, 16 x 9, 16 x 1024), and 1B prefills
QMM_CHECK_ROWS = (1, 4, 8, 16, 17, 128, 144, 260, 1040, 16384)
QMM_SHAPES = (  # the 1B decoder's four projections: name, K, N
    ("attn.c_attn", 2048, 2304), ("attn.c_proj", 2048, 2048),
    ("mlp.c_fc", 2048, 8192), ("mlp.c_proj", 8192, 2048),
)


def qmm_path(tq, M: int, K: int, N: int, dtype=torch.bfloat16) -> str:
    """Kernel 14's design for a call: the tensor-core GEMV ("gemv_tc") or
    the CUDA-core pair ("gemv") by gemv_path's rule up to GEMV_MAX_ROWS
    rows, else the tile ("tile")."""
    return tq.gemv_path(M, K, N, dtype) if M <= tq.GEMV_MAX_ROWS else "tile"


def gemv_counts(tq, shapes, forwards) -> dict:
    """The GEMV launches by design (quant_matmul_gemv_tc, quant_matmul_gemv)
    that bf16 forwards make: `forwards` [(rows of x, forwards at them)],
    each forward calling kernel 14 once at each (K, N) of `shapes` (its
    layers' projections)."""
    out = {"quant_matmul_gemv_tc": 0, "quant_matmul_gemv": 0}
    for M, n in forwards:
        for K, N in shapes:
            out["quant_matmul_" + tq.gemv_path(M, K, N, torch.bfloat16)] += n
    return out


def check_quant_matmul(tq, dev) -> dict:
    """Kernel 14 against its plain version at M = 1, 4, 8, 16 (GEMV), 17,
    128 and 144 (phase 4e's chunk-only and fused decode+chunk steps: B = 16
    rows x C = 8, x (1 + C)), 260 (a B=1 prefill), 1040 (the wgmma tile:
    4 x 260 prefill rows) and 16384 (phase 4e's batch 0 prefill: 16 x
    1024), the four projection shapes, bf16 and fp32 x (fp32 runs the
    pair), with a bias of x's type and without, to QMM_TOL; the bf16 GEMV
    at M = 1, 4, 8, 16 and tile at M = 144 and 260 (where tile_plan splits
    K, and the finish pass sums the splits) and 1040 launched twice, bit for
    bit. Returns the worst max |diff| by design ("gemv_tc", "gemv",
    "tile")."""
    g = torch.Generator(device=dev).manual_seed(8)
    worst = {"gemv_tc": 0.0, "gemv": 0.0, "tile": 0.0}
    for name, K, N in QMM_SHAPES:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        errs = []
        for M in QMM_CHECK_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                path = qmm_path(tq, M, K, N, dtype)
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                for b in (None, bias.to(dtype)):
                    out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    err = compare(f"quant_matmul {name} M={M} {dtype} bias={b is not None}",
                                  out, ref, dtype, tols=QMM_TOL)
                    if M in (1, 4, 8, 16, 144, 260, 1040) and dtype == torch.bfloat16:
                        again = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                        torch.cuda.synchronize()
                        if not torch.equal(again, out):
                            raise AssertionError(f"quant_matmul {name} M={M}: two launches differ")
                    worst[path] = max(worst[path], err)
                    errs.append(f"M={M} {str(dtype)[6:]}{'+bias' if b is not None else ''} "
                                f"{err:.2e}")
        log("kernels", f"quant_matmul {name} (K={K}, N={N}): max |diff| " + ", ".join(errs))
    return worst


def check_int8_decode(tfa, dc, dev) -> float:
    """The int8-cache decode attention against its plain version: B = 1, 4,
    T = 260, 389 cached tokens, and the 1k-token cell's end (B = 1, 8,
    T = 1285), phase 4e's pipelined decode (B = 16, T = 1152), T = 4100; left padding, a masked slot and (T > 256) a masked
    run of whole chunks; fp32 and bf16 queries over codes and scales from
    quantize_kv; two bf16 launches at B=8 T=1285 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in ((1, 260), (4, 260), (1, 389), (4, 389), (1, 1285), (8, 1285), (16, 1152),
                     (4, 4100)):
            qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            (kq, ks), (vq, vs) = (dc.quantize_kv(torch.randn((B, T, 1, D), generator=g,
                                                             device=dev)) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, : T // 5] = 0
            mask[0, T // 2] = 0
            if T > 256:
                mask[-1, 100:300] = 0
            out = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
            ref = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs,
                                              kernels=False)
            torch.cuda.synchronize()
            err = compare(f"int8 decode B={B} T={T} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16 and (B, T) == (8, 1285):
                again = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"int8 decode B={B} T={T}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention int8 cache B={B} T={T} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    return worst


# StarVector-8B's attention: 36 query heads over 4 KV heads (G = 9), head
# size 128, a sliding window of 4096 keys
H8, HKV8, WINDOW8 = 36, 4, 4096
G9_DECODE_CHECKS = (  # name, B, T, t_begin, ragged mask
    ("B=4 T=708 (576 visual + 4 prompt + 128 new tokens)", 4, 708, 0, False),
    ("B=1 T=8192 past the window (t_begin 4097)", 1, 8192, 4097, False),
    ("B=4 T=708 ragged mask", 4, 708, 0, True),
)


def check_g9_decode(tfa, dev) -> float:
    """decode_attention at G = 9, Hkv = 4 against its plain version, fp32
    and bf16, the self token merged (rows 9-15 of the tensor-core product are
    zero padding): the 8B decode at T = 708, a step past the window (the
    first visible slot t_begin = idx - 4095), and a ragged mask (left
    padding, a masked run that empties whole chunks, a masked slot); each
    bf16 case launched twice, bit for bit. Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(14)
    G, D = H8 // HKV8, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, t_begin, ragged in G9_DECODE_CHECKS:
            qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            k, v = (torch.randn((B, T, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if ragged:
                mask[0, : T // 5] = 0
                mask[-1, 100:400] = 0
                mask[:, T // 2] = 0
            out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, t_begin=t_begin)
            ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, t_begin=t_begin,
                                              kernels=False)
            torch.cuda.synchronize()
            err = compare(f"decode G=9 {name} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16:
                again = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5,
                                                    t_begin=t_begin)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"decode G=9 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention G=9 Hkv=4 {name} {str(dtype)[6:]}: max |diff| "
                           f"{err:.3e}{same}")
    return worst


def check_g9_int8_decode(tfa, dc, dev) -> float:
    """Kernel 2's int8 instantiation at G = 9, Hkv = 4 (the 8B's int8 KV
    cache) against its plain version, fp32 and bf16 queries over codes and
    scales from quantize_kv, the self token merged: the cases of
    check_g9_decode (T = 708, a step past the window, a ragged mask), each
    bf16 case launched twice, bit for bit; then the int8 P-rounding case
    (bf16(bf16(c p) / (1 + p)) exactly: v_scale folded into P before the
    rounding). Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(19)
    G, D = H8 // HKV8, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, t_begin, ragged in G9_DECODE_CHECKS:
            qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            (kq, ks), (vq, vs) = (dc.quantize_kv(torch.randn((B, T, HKV8, D), generator=g,
                                                             device=dev)) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if ragged:
                mask[0, : T // 5] = 0
                mask[-1, 100:400] = 0
                mask[:, T // 2] = 0

            def run(kernels=True):
                return tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs,
                                                   t_begin=t_begin, kernels=kernels)

            out, ref = run(), run(False)
            torch.cuda.synchronize()
            err = compare(f"int8 decode G=9 {name} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16:
                again = run()
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"int8 decode G=9 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention int8 cache G=9 Hkv=4 {name} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    (qg, k, v, mask, ks, vs), want, others = p_rounding_cases()._int8_p_rounding_inputs(dev)
    out = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs)
    ref = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs, kernels=False)
    torch.cuda.synchronize()
    got, plain = (t[..., 0].double().unique().tolist() for t in (out, ref))
    if got != [want] or plain != [want] or (out[..., 1:] != 0).any():
        raise AssertionError(f"int8 P rounding G=9: kernel {got}, plain {plain}, JAX's value "
                             f"{want}, the other orderings' {others}")
    log("kernels", f"decode_attention int8 cache G=9 P rounding: two visible keys of T=325: "
                   f"kernel {want!r} == plain == JAX's bf16(bf16(c p) / (1 + p)), not the "
                   f"v_scale-after-rounding or fp32-P values {others}")
    return worst


BOUNDS_CHECKS = (  # name, G, Hkv, B, cache slots T, t_begin, t_end, t_cap
    ("1B step mid-request (t_end 390 of t_cap 512)", 16, 1, 4, 1024, 0, 390, 512),
    ("1B step at the bucket's start (t_end 513 of t_cap 1024)", 16, 1, 4, 1024, 0, 513, 1024),
    ("8B step past the window (t_begin 605, t_end 4700 of t_cap 8192)", 9, 4, 4, 8192, 605,
     4700, 8192),
    ("8B step early (t_end 700 of t_cap 1024)", 9, 4, 4, 8192, 0, 700, 1024),
)


def check_decode_bounds(tfa, dc, dev) -> float:
    """Kernel 2 with its key bounds read from the device (`bounds`, int32
    [t_begin, t_end]; the grid planned at t_cap keys, splits past t_end
    writing empty partials) against its plain version with the same bounds,
    DECODE_TOL, the self token merged: BOUNDS_CHECKS at fp32 and bf16
    queries over a cache of their type and over int8 codes; then, for each
    case, one launch captured in a CUDA graph and replayed as the device
    bounds move to the other cases' (t_begin, t_end) under its t_cap, bit
    for bit against fresh launches. Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(26)
    D = 128
    worst = 0.0
    for name, G, Hkv, B, T, t_begin, t_end, t_cap in BOUNDS_CHECKS:
        for dtype in (torch.float32, torch.bfloat16):
            for quant in (False, True):
                qg = torch.randn((B, Hkv, G, D), generator=g, device=dev).to(dtype)
                kn, vn = (torch.randn((B, Hkv, D), generator=g, device=dev).to(dtype)
                          for _ in "kv")
                k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev) for _ in "kv")
                ks = vs = None
                if quant:
                    (k, ks), (v, vs) = dc.quantize_kv(k), dc.quantize_kv(v)
                else:
                    k, v = k.to(dtype), v.to(dtype)
                mask = torch.ones((B, T), dtype=torch.int32, device=dev)
                mask[0, :T // 9] = 0
                mask[:, t_end // 2] = 0
                bounds = torch.tensor([t_begin, t_end], dtype=torch.int32, device=dev)
                kw = dict(k_new=kn, v_new=vn, k_scale=ks, v_scale=vs, t_end=t_cap,
                          bounds=bounds)
                out = tfa.decode_attention(qg, k, v, mask, **kw)
                ref = tfa.decode_attention(qg, k, v, mask, kernels=False, **kw)
                torch.cuda.synchronize()
                what = f"decode bounds G={G} {name} {str(dtype)[6:]}{' int8' if quant else ''}"
                err = compare(what, out, ref, dtype, tols=DECODE_TOL)
                worst = max(worst, err)
                # the launch in a graph, its bounds moved on the device
                tfa.reserve_decode_scratch(dev, B, Hkv, G, D, t_cap)
                static = torch.empty_like(out)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    static.copy_(tfa.decode_attention(qg, k, v, mask, **kw))
                moved = [(b, min(e, t_cap)) for _, _, _, _, _, b, e, _ in BOUNDS_CHECKS
                         if b < min(e, t_cap)] + [(t_begin, t_end)]
                for lo, hi in moved:
                    bounds.copy_(torch.tensor([lo, hi], dtype=torch.int32))
                    graph.replay()
                    fresh = tfa.decode_attention(qg, k, v, mask, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(static, fresh):
                        raise AssertionError(f"{what}: the replayed launch at bounds "
                                             f"{(lo, hi)} differs from a fresh launch")
                del graph
                log("kernels", f"{what}: max |diff| {err:.3e}; replayed in a CUDA graph at "
                               f"{len(moved)} device bounds == fresh launches")
    return worst


# one tensor rank's heads at the 8B's serve configs (parallel/tensor.py::
# head_layout): tensor 4 holds 9 query heads over 1 KV head; tensor 8
# splits each KV head's 9 over two ranks, 5 + 4; the 1B's 16 query heads
# over its one KV head are 8 a rank on tensor 2 and 2 on tensor 8
TP_PREFILL_HEADS = ((9, 4096), (5, 4096), (4, 4096), (8, None), (2, None))  # H, window
TP_DECODE_CHECKS = (  # name, G, int8 cache, B, T, ragged mask
    ("tensor 4, B=32 slots T=708", 9, False, 32, 708, True),
    ("tensor 8, B=16 slots T=708 (int8 cache)", 5, True, 16, 708, True),
    ("tensor 8, B=16 slots T=708 (int8 cache)", 4, True, 16, 708, True),
    ("1B tensor 2, B=2 slots T=325", 8, False, 2, 325, True),
    ("1B tensor 2, B=2 slots T=325 (int8 cache)", 8, True, 2, 325, True),
    ("1B tensor 8, B=16 slots T=325 (int8 cache)", 2, True, 16, 325, True),
    ("1B tensor 8, B=16 slots T=325", 2, False, 16, 325, True),
)
# kernel 14 at a tensor rank's shapes: name, K, N, row-parallel (fp32 out,
# no bias: ops/quantization.py::dense_quantized), model. The 8B on tensor 8
# (q 5 or 4 heads of 128, k/v one, o_proj their rows, 1/8 of the MLP) and
# the 1B on tensor 8 (c_attn 2 query heads + the whole K and V, attn/c_proj
# their rows, 1/8 of the MLP)
QMM_TP_SHAPES = (
    ("8B tp8 q_proj (5 heads)", 4608, 640, False, "8b"),
    ("8B tp8 q_proj (4 heads)", 4608, 512, False, "8b"),
    ("8B tp8 k_proj, v_proj", 4608, 128, False, "8b"),
    ("8B tp8 o_proj (5 heads)", 640, 4608, True, "8b"),
    ("8B tp8 o_proj (4 heads)", 512, 4608, True, "8b"),
    ("8B tp8 mlp.c_fc", 4608, 2304, False, "8b"),
    ("8B tp8 mlp.c_proj", 2304, 4608, True, "8b"),
    ("1B tp8 attn.c_attn", 2048, 512, False, "1b"),
    ("1B tp8 attn.c_proj", 256, 2048, True, "1b"),
    ("1B tp8 mlp.c_fc", 2048, 1024, False, "1b"),
    ("1B tp8 mlp.c_proj", 1024, 2048, True, "1b"),
)
# rows of x: the GEMV at a decode step of the engine's 16 slots (the rows
# every step of 6e's int8 runs feeds it); the tile at an admission of 2
# prompts in their bucket (the 8B's 576 visual tokens and prompt in 1024,
# the 1B's 257 in 512)
QMM_TP_ROWS = {"8b": (16, 2048), "1b": (16, 1024)}
QMM_TP_CHECK_ROWS = {"8b": (1, 4, 8, 16, 2048), "1b": (1, 4, 8, 16, 1024)}


def check_tp_shapes(tfa, dc, dev) -> dict:
    """The kernels at one tensor rank's shapes (phase 6e) against their plain
    versions, fp32 and bf16 (bf16 launched twice, bit for bit): kernel 1
    at H = 9, 5 and 4 over Hkv = 1 with the window 4096 (the 8B) and at H
    = 8 and 2 without one (the 1B), an admission of two prompts
    right-padded in their 1024 bucket; kernel 2 at G = 9 over Hkv = 1
    (tensor 4: the serve config's 32 slots), over an int8 cache at G = 5
    and 4 (tensor 8: 16 slots; their own instantiations), and at the 1B's
    G = 8 and 2 over either cache, a ragged mask, the self token merged.
    Returns the worst max |diff| by row name."""
    g = torch.Generator(device=dev).manual_seed(21)
    D, errs = 128, {}
    for H, window in TP_PREFILL_HEADS:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            B, S = 2, 1024
            q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, S, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, S), dtype=torch.int32, device=dev)
            mask[0, 579:] = 0
            mask[1, 610:] = 0
            out = tfa.flash_prefill(q, k, v, mask, window=window)
            ref = tfa.flash_prefill(q, k, v, mask, window=window, kernels=False)
            torch.cuda.synchronize()
            live = torch.zeros((B, S), dtype=torch.bool, device=dev)
            live[0, :579], live[1, :610] = True, True
            err = compare(f"flash_prefill H={H} Hkv=1 {dtype}", out, ref, dtype, live=live)
            same = ""
            if dtype == torch.bfloat16:
                again = tfa.flash_prefill(q, k, v, mask, window=window)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"flash_prefill H={H} Hkv=1: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"flash_prefill H={H} Hkv=1 window={window} B=2 S=T=1024 (prompts of 579 "
                           f"and 610 right-padded) {str(dtype)[6:]}: max |diff| {err:.3e} on the "
                           f"real rows{same}")
        errs[f"flash_prefill_h{H}"] = worst
    for name, G, quant, B, T, ragged in TP_DECODE_CHECKS:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            if quant:
                (k, ks), (v, vs) = (dc.quantize_kv(torch.randn((B, T, 1, D), generator=g,
                                                               device=dev)) for _ in "kv")
            else:
                k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).to(dtype)
                        for _ in "kv")
                ks = vs = None
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if ragged:
                mask[0, : T // 5] = 0
                mask[-1, 100:400] = 0
                mask[:, T // 2] = 0

            def run(kernels=True):
                return tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, ks, vs,
                                                   kernels=kernels)

            out, ref = run(), run(False)
            torch.cuda.synchronize()
            err = compare(f"decode G={G} Hkv=1 {name} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16:
                again = run()
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"decode G={G} Hkv=1 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention {'int8 cache ' if quant else ''}G={G} Hkv=1 {name} "
                           f"{str(dtype)[6:]}: max |diff| {err:.3e}{same}")
        key = f"decode{'_int8' if quant else ''}_g{G}_hkv1"
        errs[key] = max(errs.get(key, 0.0), worst)
    torch.cuda.empty_cache()
    return errs


def check_quant_matmul_tp(tq, dev) -> dict:
    """Kernel 14 at a tensor rank's shapes (QMM_TP_SHAPES) against its plain
    version, bf16 x, as a rank's dense runs it: a column-parallel slice with
    its bias and a bf16 result, a row-parallel one with no bias and an fp32
    result (the partial its group sums); the GEMV at M = 1, 4, 8, 16 and the
    tile at an admission's rows (QMM_TP_CHECK_ROWS), to QMM_TOL, each
    launched twice, bit for bit. Returns the worst max |diff| by model and
    design ("qmm_gemv_tc_tp_8b", "qmm_tile_tp_1b", ...)."""
    g = torch.Generator(device=dev).manual_seed(22)
    worst = {}
    for name, K, N, row, model in QMM_TP_SHAPES:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = None if row else torch.randn((N,), generator=g, device=dev).bfloat16()
        out_dtype = torch.float32 if row else torch.bfloat16
        errs = []
        for M in QMM_TP_CHECK_ROWS[model]:
            path = qmm_path(tq, M, K, N)
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            out = tq.quant_matmul(x, p["kernel_q"], p["scale"], bias, out_dtype=out_dtype)
            ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], bias, out_dtype=out_dtype)
            again = tq.quant_matmul(x, p["kernel_q"], p["scale"], bias, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = compare(f"quant_matmul {name} M={M}", out, ref, torch.bfloat16, tols=QMM_TOL)
            if not torch.equal(again, out):
                raise AssertionError(f"quant_matmul {name} M={M}: two launches differ")
            key = f"qmm_{path}_tp_{model}"
            worst[key] = max(worst.get(key, 0.0), err)
            errs.append(f"M={M} {path} {err:.2e}")
            del x, out, ref, again
        log("kernels", f"quant_matmul {name} (K={K}, N={N}, "
                       f"{'row-parallel: fp32 out, no bias' if row else 'bias, bf16 out'}), "
                       f"plans: tensor-core GEMV {tq.gemv_plan(K, N)}, pair "
                       f"{tq.gemv_split(K, N)}, tile "
                       f"{tq.tile_plan(QMM_TP_CHECK_ROWS[model][-1], K, N)}: max |diff| "
                       + ", ".join(errs) + "; a second launch gives the same bits")
    torch.cuda.empty_cache()
    return worst


QMM_SHAPES_8B = (  # the 8B decoder's six projections a layer, four shapes: name, K, N
    ("attn.q_proj, o_proj", 4608, 4608), ("attn.k_proj, v_proj", 4608, 512),
    ("mlp.c_fc", 4608, 18432), ("mlp.c_proj", 18432, 4608),
)
# decode at B = 1, 4, 8 (num_return_sequences) and 16 (phase 4e's slots);
# prefill of 580 tokens at B = 1, 4
QMM_ROWS_8B = (1, 4, 8, 16, 580, 2320)
# the 8B decoder's projections a layer: q, k, v, o_proj, c_fc, c_proj
LAYER_SHAPES_8B = ((4608, 4608), (4608, 512), (4608, 512), (4608, 4608), (4608, 18432),
                   (18432, 4608))


def check_quant_matmul_8b(tq, dev) -> dict:
    """Kernel 14 at the 8B's shapes against its plain version, with a bias
    of x's type: M = 1, 4, 8, 16 (the GEMV) and 580, 2320 (the tile) in
    bf16, and fp32 x up to M = 580 (the fp32 greedy check's path: the pair
    for M <= 16), to QMM_TOL; the bf16 GEMV and the tile at M = 2320
    launched twice, bit for bit. Returns the worst max |diff| by design
    ("gemv_tc", "gemv", "tile")."""
    g = torch.Generator(device=dev).manual_seed(20)
    worst = {"gemv_tc": 0.0, "gemv": 0.0, "tile": 0.0}
    for name, K, N in QMM_SHAPES_8B:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        errs = []
        for M in QMM_ROWS_8B:
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and M > 580:
                    continue
                path = qmm_path(tq, M, K, N, dtype)
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                b = bias.to(dtype)
                out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                torch.cuda.synchronize()
                err = compare(f"quant_matmul 8B {name} M={M} {dtype}", out, ref, dtype,
                              tols=QMM_TOL)
                if M == 2320 or path == "gemv_tc":
                    again = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(again, out):
                        raise AssertionError(f"quant_matmul 8B {name} M={M}: two launches differ")
                worst[path] = max(worst[path], err)
                errs.append(f"M={M} {str(dtype)[6:]} {path} {err:.2e}")
                del x, out, ref
        log("kernels", f"quant_matmul 8B {name} (K={K}, N={N}, bias), plans: tensor-core GEMV "
                       f"{tq.gemv_plan(K, N)} (blocks, waves of whole tiles, rows of K a unit / "
                       f"64), pair {tq.gemv_split(K, N)} (splits, rows), tile {[tq.tile_plan(M, K, N) for M in QMM_ROWS_8B[-2:]]} (rows of "
                       f"x, splits, rows of K): max |diff| " + ", ".join(errs))
    torch.cuda.empty_cache()
    return worst


PREFILL_8B_CHECKS = (  # name, B, S, T, q_offset
    ("B=4 S=T=580 (the 8B prefill)", 4, 580, 580, 0),
    ("B=1 S=1024 at q_offset 7168 of T=8192", 1, 1024, 8192, 7168),
)


def check_flash_prefill_8b(tfa, dev) -> float:
    """flash_prefill at H = 36, Hkv = 4 with the 4096-key window against its
    plain version, fp32 and bf16 (TOL): the 8B prefill, and a chunk past the
    window whose first rows' windows start inside a key tile; each bf16 case
    launched twice, bit for bit. Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(15)
    D = 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, q_off in PREFILL_8B_CHECKS:
            q = torch.randn((B, S, H8, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, T, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            out = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8)
            ref = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8, kernels=False)
            torch.cuda.synchronize()
            err = compare(f"flash_prefill H=36 {name} {dtype}", out, ref, dtype)
            same = ""
            if dtype == torch.bfloat16:
                again = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"flash_prefill H=36 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            del ref
            log("kernels", f"flash_prefill H=36 Hkv=4 window=4096 {name} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    torch.cuda.empty_cache()
    return worst


TRAIN_CASES = [  # name, B, S, T, H, Hkv, q_offset, window, right_pad, left_pad
    ("1B train step", 4, 769, 769, 16, 1, 0, None, 0, 0),
    ("right-padded keys", 2, 300, 300, 16, 1, 0, None, 120, 0),
    ("S=37 not a tile multiple", 2, 37, 37, 16, 1, 0, None, 0, 0),
    ("S<T, q_offset=130", 2, 70, 200, 16, 1, 130, None, 0, 0),
    ("window=33", 2, 150, 150, 16, 1, 0, 33, 0, 0),
    ("GQA Hkv=4", 2, 130, 130, 16, 4, 0, None, 0, 0),
    ("left-padded keys, rows with no key", 2, 100, 100, 16, 1, 0, None, 0, 7),
    # the long contexts of the TPU's other backward variants: the 8k
    # triangle (one-pass tri), a sequence-parallel chunk at the end of the
    # 8k and of the 16k window (one-pass / dq-partials, and the split pair,
    # q_offset traced), and the 16k triangle (split tri) at 2 heads, whose
    # plain version's (H, T, T) fp32 blocks would not fit at 16
    ("8k context", 1, 8450, 8450, 16, 1, 0, None, 0, 0),
    ("8k SP chunk, S=1024 at q_offset=7426", 1, 1024, 8450, 16, 1, 7426, None, 0, 0),
    ("16k SP chunk, S=1024 at q_offset=15618", 1, 1024, 16642, 16, 1, 15618, None, 0, 0),
    ("16k context, H=2", 1, 16642, 16642, 2, 1, 0, None, 0, 0),
    # the 8B's training shapes: 36 query heads over 4 KV heads (G = 9, so
    # dkdv_head_split's divisors 3 and 9), the 4096-key window with GQA, a
    # short step (the TPU's fused backward, T <= 2048) and one past the
    # window (its one-pass backward), right-padded keys past the window, and
    # phase 6b's step itself (128 key tiles, the plan's head split)
    ("8B train, short", 2, 1160, 1160, 36, 4, 0, 4096, 0, 0),
    ("8B train past the window", 1, 4700, 4700, 36, 4, 0, 4096, 0, 0),
    ("8B right-padded keys past the window", 2, 4700, 4700, 36, 4, 0, 4096, 700, 0),
    ("8B train step", 1, 8192, 8192, 36, 4, 0, 4096, 0, 0),
    # a tensor rank's heads in training (phase 5g): the 1B's 16 over 1 at
    # tensor 2, 4 and 8 (the KV head on every rank), at its step's shape;
    # the 8B's 36 over 4 at tensor 2 (18 over 2), 4 (9 over 1) and 8 (5 or
    # 4 over 1: dkdv_head_split's divisors of 5 are 1 and 5), past the window
    ("1B tensor rank H=8", 4, 769, 769, 8, 1, 0, None, 0, 0),
    ("1B tensor rank H=4", 4, 769, 769, 4, 1, 0, None, 0, 0),
    ("1B tensor rank H=2", 4, 769, 769, 2, 1, 0, None, 0, 0),
    ("8B tensor rank H=18 Hkv=2", 1, 4700, 4700, 18, 2, 0, 4096, 0, 0),
    ("8B tensor rank H=9", 1, 4700, 4700, 9, 1, 0, 4096, 0, 0),
    ("8B tensor rank H=5", 1, 4700, 4700, 5, 1, 0, 4096, 0, 0),
    ("8B tensor rank H=4", 1, 4700, 4700, 4, 1, 0, 4096, 0, 0),
    # a pipeline stage's microbatch (phase 5g's 1b-stage2-fsdp2): one row
    ("1B pipeline microbatch", 1, 769, 769, 16, 1, 0, None, 0, 0),
]
# cases whose bf16 kernels are launched twice and held to the same bits
RELAUNCH_CASES = ("1B train step", "8B train, short", "8B train past the window",
                  "8B right-padded keys past the window", "8B train step",
                  "1B pipeline microbatch") + tuple(
    case[0] for case in TRAIN_CASES if "tensor rank" in case[0])
# the case whose bf16 error each kernel's JSON row reports: the shape its
# times are taken at (phase 7), by the row name's suffix
ROW_CASES = {"": "1B train step", "_8b": "8B train step", "_tp1b": "1B tensor rank H=8",
             "_tp8b": "8B tensor rank H=9", "_pp1b": "1B pipeline microbatch"}


def compare_training(what: str, out, plain, ref32, dtype, live=None) -> float:
    """compare() at the dtype's tolerance; for bf16, failing that, the kernel
    may be no further from the fp32 plain result (on the same bf16 inputs)
    than twice the plain bf16 version's own distance, plus 1e-3: the kernels
    round at the JAX kernels' points, which are not all the plain version's
    (the forward kernel rounds the unnormalised P to bf16 against the
    running max of its key tile, the plain version the normalised P; the
    backward kernels round P and dS where the plain version does)."""
    try:
        return compare(what, out, plain, dtype, live)
    except AssertionError:
        if dtype != torch.bfloat16:
            raise
    sel = (lambda t: t[live]) if live is not None else (lambda t: t)
    err_k = (sel(out).float() - sel(ref32)).abs().max().item()
    err_p = (sel(plain).float() - sel(ref32)).abs().max().item()
    if not torch.isfinite(out).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"{what}: kernel {err_k:.3e} from fp32, plain bf16 {err_p:.3e}")
    return (sel(out).float() - sel(plain).float()).abs().max().item()


def check_training_kernels(tfa, dev) -> dict:
    """The forward with lse and the backward pair against their plain
    versions. q is a strided view of a fused [q | k | v] projection, as the
    1B decoder passes it; the backward pair gets the plain forward's out and
    lse on both sides, so each comparison isolates one kernel. Returns each
    kernel's bf16 max |diff| at the 1B step's shape, and under
    "<kernel>_8b" at the 8B step's (ROW_CASES)."""
    g = torch.Generator(device=dev).manual_seed(6)
    at_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, H, Hkv, q_off, window, rpad, lpad in TRAIN_CASES:
            qkv = torch.randn((B, S, (H + 2 * Hkv) * 128), generator=g, device=dev).to(dtype)
            q = qkv[..., :H * 128].unflatten(-1, (H, 128))
            k, v = (torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype) for _ in "kv")
            do = torch.randn((B, S, H, 128), generator=g, device=dev).to(dtype)
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if rpad:
                mask[1, T - rpad:] = 0
            mask[:, :lpad] = 0
            kw = dict(window=window)
            out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, **kw)
            ro, rl = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, kernels=False, **kw)
            delta = tfa.attention_delta(ro, do)
            dk, dv = tfa.flash_bwd_dkdv(q, k, v, mask, do, rl, delta, q_off, **kw)
            dq = tfa.flash_bwd_dq(q, k, v, mask, do, rl, delta, q_off, **kw)
            pq, pk, pv = tfa.flash_backward(q, k, v, mask, ro, rl, do, q_off, kernels=False, **kw)
            torch.cuda.synchronize()
            ref32 = dict(out=ro, dq=pq, dk=pk, dv=pv)
            if dtype == torch.bfloat16:  # the plain version on the same values in fp32
                f = [t.float() for t in (q, k, v, do)]
                o32, l32 = tfa.flash_prefill_with_lse(*f[:3], mask, q_off, kernels=False, **kw)
                g32 = tfa.flash_backward(*f[:3], mask, o32, l32, f[3], q_off, kernels=False, **kw)
                ref32 = dict(out=o32, dq=g32[0], dk=g32[1], dv=g32[2])
            pos = q_off + torch.arange(S, device=dev)
            lo = (pos - (window or T) + 1).clamp_min(0)
            cum = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                             mask.long().cumsum(1)], 1)
            live = cum[:, (pos + 1).clamp_max(T)] - cum[:, lo] > 0  # rows that see a key
            tag = f"{name} {str(dtype)[6:]}"
            err_o = compare_training(f"out {tag}", out, ro, ref32["out"], dtype, live)
            err_l = compare(f"lse {tag}", lse.transpose(1, 2), rl.transpose(1, 2),
                            torch.float32, live)
            errs = [compare_training(f"{w} {tag}", a, b, ref32[w], dtype)
                    for w, a, b in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv))]
            if not live.all() and (dq.float()[~live] != 0).any():
                raise AssertionError(f"dq {tag}: rows that see no key are not zero")
            same = ""
            if "tensor rank" in name and dtype == torch.bfloat16:
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                split = tfa.dkdv_head_split(B, T, Hkv, H // Hkv, sms, S=S, q_offset=q_off,
                                            window=window)
                same = f"; dkdv_head_split picks {split} of G = {H // Hkv}"
            if name in RELAUNCH_CASES and dtype == torch.bfloat16:
                # no atomics: each output is written once, the backward's head
                # splits summed in a fixed order
                fwd = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, **kw)
                again = (tfa.flash_bwd_dq(q, k, v, mask, do, rl, delta, q_off, **kw),
                         *tfa.flash_bwd_dkdv(q, k, v, mask, do, rl, delta, q_off, **kw))
                torch.cuda.synchronize()
                if not (torch.equal(fwd[0], out) and torch.equal(fwd[1], lse)):
                    raise AssertionError(f"forward {tag}: two launches differ")
                if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
                    raise AssertionError(f"backward {tag}: two launches differ")
                same += "; a second launch gives bit-identical out, lse, dq, dk, dv"
                del again, fwd
            for sfx, case in ROW_CASES.items():
                if name == case and dtype == torch.bfloat16:
                    at_rows.update({"flash_prefill_with_lse" + sfx: max(err_o, err_l),
                                    "flash_bwd_dq" + sfx: errs[0],
                                    "flash_bwd_dkdv" + sfx: max(errs[1:])})
            log("kernels", f"training {tag}: max |diff| out {err_o:.3e}, lse {err_l:.3e}, "
                           f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}"
                           + ("" if live.all() else f"; {int((~live).sum())} rows see no key: "
                              "finite, dq = 0") + same)
            del qkv, q, k, v, do, out, lse, ro, rl, delta, dk, dv, dq, pq, pk, pv, ref32
            torch.cuda.empty_cache()
    return at_rows


def check_bf16_rounding(dev) -> str:
    """The served bf16 path rounds as the JAX package does. A dense layer
    adds its bias to the fp32 sum before its one rounding to bf16, with bf16
    and with fp32 parameters; the tied head returns the fp32 sum itself.
    Checked at the 1B decoder's c_attn shape for a decode step (4 rows) and a
    prefill (4 x 261 rows), and at the head's, against float64 sums."""
    from starvector_tpu_torch.ops.layers import DTypePolicy, dense, matmul_f32

    g = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((2048, 2304), generator=g, device=dev) * 0.02
    b = torch.rand((2304,), generator=g, device=dev) + 1.0  # dwarfs x @ w: a bf16 bias shows
    parts = []
    for rows in (4, 4 * 261):
        x = torch.randn((rows, 2048), generator=g, device=dev).bfloat16()
        for pdt in (torch.bfloat16, torch.float32):
            wp, bp = w.to(pdt), b.to(pdt)
            y = dense({"kernel": wp, "bias": bp}, x, DTypePolicy(pdt, torch.bfloat16))
            ref = (x.double() @ wp.bfloat16().double() + bp.double()).bfloat16().double()
            diff = (y.double() - ref).abs()
            exact = (diff == 0).double().mean().item()
            # off by one bf16 step where the fp32 and float64 sums straddle a
            # rounding boundary, or by the fp32 sum's own error (~1e-6 over
            # 2048 terms) where the sum cancels to near zero
            if y.dtype != torch.bfloat16 or exact < 0.99 or (diff > ref.abs() * 2**-7 + 1e-4).any():
                raise AssertionError(f"dense rows={rows} {pdt} params: {y.dtype}, equal to the "
                                     f"rounded float64 sum on {exact:.4f}, max |diff| {diff.max():.3e}")
            parts.append(f"dense rows={rows} {str(pdt)[6:]} params {exact:.5f}")
    wte = (torch.randn((49152, 2048), generator=g, device=dev) * 0.02).bfloat16()
    x = torch.randn((4, 2048), generator=g, device=dev).bfloat16()
    logits = matmul_f32(x, wte.T)
    ref = x.double() @ wte.double().T
    err = (logits.double() - ref).abs().max().item()
    in_bf16 = (logits == logits.bfloat16().float()).double().mean().item()
    if logits.dtype != torch.float32 or in_bf16 > 0.05 or err > 1e-5 * ref.abs().max().item():
        raise AssertionError(f"head logits {logits.dtype}: {in_bf16:.4f} are bf16 values, "
                             f"max |diff| from float64 {err:.3e}")
    return (f"share equal to the float64 sum rounded once: {', '.join(parts)}; head logits fp32, "
            f"{in_bf16:.5f} of them bf16 values, max |diff| from float64 {err:.3e} "
            f"(max |logit| {ref.abs().max().item():.3f})")


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def synthetic_images(n: int, seed: int) -> list[np.ndarray]:
    """uint8 RGB images of assorted sizes: a gradient with a few flat
    rectangles, like a rendered icon."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(s) for s in rng.integers(180, 420, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 255 // w), (yy * 255 // h), np.full_like(xx, 200)], -1)
        for _ in range(3):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
        out.append(img.astype(np.uint8))
    return out


GREEDY = dict(prompt_ids=[PROMPT_IDS] * 4, stop_sequences=STOP_IDS, max_new_tokens=128,
              use_nucleus_sampling=False)


def api_requester(model):
    """request(images, **kw) -> (tokens, lengths, seconds): the API's
    generate_im2svg_ids, greedy with 128 new tokens unless kw says
    otherwise, host clock around a synchronised request."""
    def request(images, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = {"image": model.process_images(images)}
        _, tokens, lengths = model.generate_im2svg_ids(batch, **{**GREEDY, **kw})
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def scale_projections(params: dict) -> dict:
    """The decoder's attention and MLP kernels times PROJ_SCALE, in place."""
    for grp in (params["svg_transformer"]["layers"]["attn"], params["svg_transformer"]["layers"]["mlp"]):
        for p in grp.values():
            p["kernel"].mul_(PROJ_SCALE)
    return params


def full_width_params(sv, cfg, dev, dtype, seed: int = 0) -> dict:
    return scale_projections(sv.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                            device=dev, dtype=dtype))


KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("decode_attention", ("decode_attention_bf16_kernel", "decode_attention_f32_kernel")),
    ("quant_matmul", ("qmm_gemv_kernel", "qmm_gemv_tc_kernel", "qmm_finish_kernel",
                      "qmm_wgmma_kernel", "qmm_f32_kernel")),
    ("flash_prefill", ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel")),
    ("GEMM/GEMV (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


def profiled_device_ms(fn) -> float:
    """Device milliseconds of fn() by torch.profiler: the sum of every CUDA
    kernel's time (graph replays' kernels included), 0 where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def step_times(card: str, label: str, dec_params, llm_cfg, emb, mask, policy,
               new: int = 128) -> dict:
    """generate's decode step at B = emb.shape[0], `new` greedy tokens with
    no stop, graphed (a CUDA graph of one step a key bucket, captured in
    each call, replayed DECODE_GRAPH_STEPS times between two reads of
    `done`) against the same static steps uncaptured (cuda_graphs=False):
    the wall a step is the host clock around a whole generate less a
    prefill-only one (max_new_tokens=1), over the new - 1 steps, in turns
    (uncaptured, graphed, graphed, uncaptured); for the graphed calls also
    with their captures' host seconds taken out (what a replay costs); the
    device time a step is torch.profiler's kernel time over the same two
    calls; the busy share is device over wall. Returns {"uncaptured":
    {...}, "graphed": {...}} of wall_ms, device_ms (None where the profiler
    saw no kernel), busy."""
    from starvector_tpu_torch.generation import graphs
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate

    def run(n: int, graphed: bool) -> tuple[float, float]:
        gen = GenerationConfig(max_new_tokens=n, min_new_tokens=n, do_sample=False,
                               pad_token_id=0)
        graphs.reset_tally()
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(dec_params, llm_cfg, emb, mask, gen, policy=policy, cuda_graphs=graphed)
        torch.cuda.synchronize()
        return time.perf_counter() - t, graphs.tally()["capture_s"]

    for graphed in (False, True):
        run(new, graphed)  # warm-up
    walls = {False: [], True: []}
    replay = []
    for graphed in (False, True, True, False):
        (full, cap), (short, _) = run(new, graphed), run(1, graphed)
        walls[graphed].append((full - short) * 1e3 / (new - 1))
        if graphed:
            replay.append((full - cap - short) * 1e3 / (new - 1))
    out = {}
    for graphed, name in ((False, "uncaptured"), (True, "graphed")):
        device = (profiled_device_ms(lambda: run(new, graphed))
                  - profiled_device_ms(lambda: run(1, graphed))) / (new - 1)
        wall = statistics.mean(walls[graphed])
        out[name] = dict(wall_ms=wall, device_ms=device if device > 0 else None,
                         busy=device / wall if device > 0 else None, walls=walls[graphed])
    out["graphed"]["replay_wall_ms"] = statistics.mean(replay)
    B = emb.shape[0]

    def fmt(r):
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        busy = "" if r["busy"] is None else f", busy {r['busy']:.1%}"
        return f"wall {r['wall_ms']:.3f} ms, device {dev}{busy}"

    log("steps", f"{card}: {label} decode step, B={B}, {new} greedy tokens: uncaptured "
                 f"(cuda_graphs=False) {fmt(out['uncaptured'])}; graphed {fmt(out['graphed'])} "
                 f"({out['graphed']['replay_wall_ms']:.3f} ms a step without the call's "
                 f"captures); walls a step in turns "
                 f"{[round(w, 3) for w in out['uncaptured']['walls']]} uncaptured, "
                 f"{[round(w, 3) for w in out['graphed']['walls']]} graphed")
    return out


def profile_request(request, card: str, out_dir: Path, label: str = "bf16") -> None:
    """Where the device time of a B=4, 128-token greedy request of the
    `label` model (bf16, or int8 weights and cache) goes:
    torch.profiler traces the whole request and a prefill-only request
    (max_new_tokens=1); their difference over the decode steps is the
    per-step cost. The wall times come from the same requests run just
    before without the profiler, whose own host cost would inflate them.
    Writes both kernel tables to out_dir and prints the per-step wall time,
    device time, busy share and kernel classes."""
    from torch.profiler import ProfilerActivity, profile

    images = synthetic_images(4, 21)

    def traced(**kw):
        _, _, wall = request(images, **kw)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, lengths, _ = request(images, **kw)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        by_class: dict[str, float] = {}
        for e in rows:
            label = next((lab for lab, keys in KERNEL_CLASSES
                          if any(k in e.key.lower() for k in keys)), "other")
            by_class[label] = by_class.get(label, 0.0) + e.self_device_time_total / 1e3
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
        return int(lengths.max()), wall * 1e3, by_class, table

    steps, wall, full, table_full = traced()
    _, wall0, prefill, table_prefill = traced(max_new_tokens=1)
    if not sum(full.values()):
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    table = out_dir / ("profile_im2svg.txt" if label == "bf16" else f"profile_im2svg_{label}.txt")
    table.write_text(
        f"{card}\n{label}: B=4, 128 new tokens greedy\n{table_full}\n\n"
        f"B=4, prefill only (max_new_tokens=1)\n{table_prefill}\n")
    n = steps - 1
    per_step = {k: (full.get(k, 0.0) - prefill.get(k, 0.0)) / n for k in full}
    dev_step, wall_step = sum(per_step.values()), (wall - wall0) / n
    shares = ", ".join(f"{k} {v * 1e3:.1f} us ({v / dev_step:.1%})"
                       for k, v in sorted(per_step.items(), key=lambda kv: -kv[1]))
    log("profile", f"{card}: {label} B=4 decode step ({n} steps, tables in "
                   f"{table}): wall {wall_step:.3f} ms without the "
                   f"profiler, device {dev_step:.3f} ms under it, busy {dev_step / wall_step:.1%}; "
                   f"device time per step: {shares}")
    log("profile", f"{card}: {label} B=4 image+prefill+first token: wall "
                   f"{wall0:.1f} ms, device {sum(prefill.values()):.3f} ms: "
                   + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(prefill.items(),
                                                                   key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# phase 4, int8: quantized decoder weights and an int8 KV cache
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quantized(params: dict) -> dict:
    """params with the decoder quantized as from_pretrained(quantize=True)
    does (quantize_tree at its default threshold, decoder only);
    consume=False keeps the source tree for the comparisons."""
    from starvector_tpu_torch.ops.quantization import quantize_tree

    return {**params, "svg_transformer": quantize_tree(params["svg_transformer"], consume=False)}


def int8_requester(model, cfg, params, policy, dev, kernels: bool = True,
                   kv_cache_dtype=torch.int8):
    """request(images, max_new_tokens=128) -> (tokens, lengths, seconds):
    the model's processor, the im2svg prefix, then engine.generate with an
    int8 KV cache (or `kv_cache_dtype`) and the API's greedy generation
    config, host clock around a synchronised request."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix

    def request(images, max_new_tokens: int = 128, prompt_ids=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = model.process_images(images)
        prompt = torch.tensor([PROMPT_IDS] * len(images), device=dev)
        emb, mask = im2svg_prefix(params, cfg, x, prompt, policy=policy)
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                               stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
        tokens, lengths = generate(params["svg_transformer"], cfg.llm, emb, mask, gen,
                                   prompt_ids=prompt, policy=policy, kernels=kernels,
                                   kv_cache_dtype=kv_cache_dtype)
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def forced_logits(dec, params, llm_cfg, emb, mask, n: int, policy, kernels: bool, cache_dtype,
                  ids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, n, V) fp32, ids (B, n - 1)): a cached prefill over (emb,
    mask), then n - 1 decode steps, each fed ids[:, t] whatever the logits
    pick or, without `ids`, the greedy token (engine.generate's greedy
    loop without its stops)."""
    B = emb.shape[0]
    cache = dec.init_cache(llm_cfg, B, emb.shape[1] + n, dtype=cache_dtype, device=emb.device)
    logits, cache = dec.forward(params, llm_cfg, emb, mask, cache=cache, policy=policy,
                                last_logits_only=True, kernels=kernels)
    out, fed = [logits[:, -1]], []
    ones = torch.ones((B, 1), dtype=torch.int32, device=emb.device)
    for t in range(n - 1):
        fed.append(out[-1].argmax(-1) if ids is None else ids[:, t])
        x = dec.embed_tokens(params, fed[-1][:, None]).to(policy.compute_dtype)
        logits, cache = dec.forward(params, llm_cfg, x, ones, cache=cache, policy=policy,
                                    kernels=kernels)
        out.append(logits[:, -1])
    return torch.stack(out, 1), torch.stack(fed, 1)


def int8_slice(model, tfa, cfg, p16, p32, dev) -> dict:
    """StarVector-1B with the decoder's projections in int8 (quantize_tree)
    and an int8 KV cache: 3 requests of 4 images, greedy, 128 new tokens,
    with exact launch counts; then fp32 greedy ids kernels vs plain, bf16
    prefill logits against the fp32 plain int8 path, and the share of
    greedy tokens on which int8 agrees with bf16 (random weights: printed,
    not checked)."""
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    q16 = quantized(p16)
    request = int8_requester(model, cfg, q16, bf16, dev)
    request(synthetic_images(4, 99))  # warm-up
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    steps = [decode_steps(tokens, lengths) for tokens, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"int8: bad tokens {tuple(tokens.shape)} [{tokens.min()}, {tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"int8: bad lengths {lengths.tolist()}")
    n = sum(steps)
    gemv = gemv_counts(tq, [(K, N) for _, K, N in QMM_SHAPES], [(4, L * n)])
    expected = {"quant_matmul": 4 * L * (3 + n), **gemv,
                "quant_matmul_wgmma": 4 * L * 3, "quant_matmul_f32_tile": 0,
                "flash_prefill": L * 3, "decode_attention": L * n, "decode_attention_int8": L * n,
                **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"int8 launches {got}, expected {expected}")
    log("slice", f"int8 weights + int8 KV cache, 3 requests x 4 images, greedy, 128 new tokens: "
                 f"decode steps {steps}, lengths {[l.tolist() for _, l, _ in served]}; launches "
                 f"quant_matmul {got['quant_matmul']} = 96 x ({3} prefills + {n} decode steps) "
                 f"(tensor-core GEMV {got['quant_matmul_gemv_tc']}, GEMV pair "
                 f"{got['quant_matmul_gemv']}, wgmma tile {got['quant_matmul_wgmma']}), int8 "
                 f"decode_attention {got['decode_attention_int8']} = {L} x {n}, flash_prefill "
                 f"{got['flash_prefill']} = {L} x 3, no training kernel")

    # fp32: greedy ids with the kernels against the plain versions (fp32 x
    # runs the GEMV pair: its launches there go beside the bf16 run's)
    q32 = quantized(p32)
    reset_counts(tfa)
    ids = {k: int8_requester(model, cfg, q32, f32, dev, kernels=k)(
        synthetic_images(2, 7), max_new_tokens=32)[0] for k in (True, False)}
    got["quant_matmul_gemv_fp32"] = read_counts(tfa)["quant_matmul_gemv"]
    if not torch.equal(ids[True], ids[False]) or not got["quant_matmul_gemv_fp32"]:
        raise AssertionError(f"int8 fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}\nor the GEMV pair did not run "
                             f"({got['quant_matmul_gemv_fp32']} launches)")
    log("slice", f"int8 fp32, B=2, 32 tokens: greedy ids with the kernels == with the plain "
                 f"versions ({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row); "
                 f"GEMV pair launches {got['quant_matmul_gemv_fp32']}")
    del q32

    # bf16: prefill last-position logits against the fp32 plain int8 path
    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg, images, prompt, policy=policy)
        cache = gpt_bigcode.init_cache(cfg.llm, 4, emb.shape[1], dtype=torch.int8, device=dev)
        return gpt_bigcode.forward(params["svg_transformer"], cfg.llm, emb, mask, cache=cache,
                                   policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(_cast_tree(q16, torch.float32), f32, False)  # the same codes
    logits = {k: prefill_logits(q16, bf16, k) for k in (True, False)}
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"int8 bf16 prefill logits: kernels {err_k:.3e} from the fp32 "
                             f"plain int8 path, over twice the plain bf16 version's {err_p:.3e}")
    toks16 = model.generate_im2svg_ids({"image": images}, prompt_ids=[PROMPT_IDS] * 4,
                                       stop_sequences=STOP_IDS, max_new_tokens=128,
                                       use_nucleus_sampling=False)[1]
    toks8 = request(synthetic_images(4, 11))[0]
    agree = (toks8 == toks16).float().mean().item()
    log("slice", f"int8 bf16, B=4: prefill last-position logits from the fp32 plain int8 path "
                 f"(max |logit| {ref32.abs().max().item():.3e}): kernels {err_k:.4e}, plain "
                 f"{err_p:.4e} (bound: kernels <= 2 x plain + 1e-3); greedy tokens of the int8 "
                 f"path agree with the bf16 path's on {agree:.4f} of 4x128 positions (random "
                 f"weights: a printed figure, not a check)")
    return dict(counts=got, request=request, params=q16)


# ---------------------------------------------------------------------------
# text2svg: captions in, no vision tower (phases 4 and 6)
# ---------------------------------------------------------------------------

# captions of 6, 13, 26 and 30 tokens through the byte-level test tokenizer
# (caption + <svg-start>; the last is cut at the API's max_length of 30)
CAPTIONS = ("heart", "a red circle", "a green triangle on white",
            "a minimalist icon of a blue house with a chimney")


def text2svg_requester(model):
    """request(images, max_new_tokens=128, prompt_ids=None) -> (tokens,
    lengths, seconds): the API's generate_text2svg_ids on as many captions
    as `images` has entries (so that serving_times drives it as it drives
    an im2svg request), greedy, host clock around a synchronised request."""
    calls = iter(range(1 << 30))

    def request(images, max_new_tokens: int = 128, prompt_ids=None):
        first = next(calls)  # each request starts one caption further on
        captions = [CAPTIONS[(first + i) % len(CAPTIONS)] for i in range(len(images))]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, tokens, lengths = model.generate_text2svg_ids(
            {"caption": captions}, max_new_tokens=max_new_tokens, use_nucleus_sampling=False)
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def text2svg_slice(tfa, label: str, model, p32, cfg32, dev, depth_note: str) -> dict:
    """text2svg through the API at full width: a request of 4 captions (6
    to 30 tokens, left-padded) and one of 1, greedy, 128 new tokens, with
    exact launch counts: a prompt of at most 64 tokens takes the chunk step
    (plain PyTorch: no flash_prefill), then one decode_attention a layer a
    step; then fp32 greedy ids of 2 captions, 32 tokens, kernels against
    plain, on the fp32 tree `p32` (cfg32's depth, told by `depth_note`).
    Returns the requester and the launch counts."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = model.cfg.llm.n_layer
    request = text2svg_requester(model)
    request([None] * 4, max_new_tokens=8)  # warm-up
    reset_counts(tfa)
    served = [request([None] * 4), request([None])]
    counts = read_counts(tfa)
    steps = [decode_steps(tokens, lengths) for tokens, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape[1] != 128 or int(tokens.min()) < 0 or \
                int(tokens.max()) >= model.cfg.llm.vocab_size:
            raise AssertionError(f"{label} text2svg: bad tokens {tuple(tokens.shape)}")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"{label} text2svg: bad lengths {lengths.tolist()}")
    expected = {"flash_prefill": 0, "decode_attention": L * sum(steps),
                "decode_attention_int8": 0, "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"{label} text2svg launches {got}, expected {expected}")
    prompt = [min(len(model.tokenizer.token_ids(c)) + 1, 30) for c in CAPTIONS]
    log("text2svg", f"{label}: requests of 4 captions and of 1 ({prompt} prompt tokens, "
                    f"left-padded), greedy, 128 new tokens: decode steps {steps}, "
                    f"lengths {[l.tolist() for _, l, _ in served]}; launches flash_prefill 0 (the "
                    f"prompts take the chunk step), decode_attention {got['decode_attention']} = "
                    f"{L} x {sum(steps)} decode steps, no int8 or training kernel")
    f32 = DTypePolicy(torch.float32, torch.float32)
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg32, model.tokenizer, policy=f32, device=dev,
                                    kernels=kernels)
        ids[kernels] = m32.generate_text2svg_ids({"caption": list(CAPTIONS[1:3])},
                                                 max_new_tokens=32,
                                                 use_nucleus_sampling=False)[1]
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"{label} text2svg fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    log("text2svg", f"{label}: fp32, B=2, 32 tokens, {depth_note}: greedy ids with the kernels "
                    f"== with the plain versions ({[len(set(r.tolist())) for r in ids[True]]} "
                    f"distinct ids per row)")
    return dict(request=request, counts=got)


def serving_times(card: str, requests: dict, rounds: int = 2) -> dict:
    """For each model: p50 B=1 image -> SVG latency, and B=4 decode
    tokens/s from full and prefill-only (max_new_tokens=1) requests. The
    models take turns in the order a, b, b, a in each round, so that the
    host's drift within the call falls on both alike."""
    labels = list(requests)
    t = {label: dict(b1=[], tokens=[], full=[], prefill=[], steps=[]) for label in labels}
    slot = 0
    for _ in range(rounds):
        for label in labels + labels[::-1]:
            request, rec = requests[label], t[label]
            _, lengths, secs = request(synthetic_images(1, 100 + slot), prompt_ids=[PROMPT_IDS])
            rec["b1"].append(secs)
            rec["tokens"].append(int(lengths.max()))
            tokens, lengths, secs = request(synthetic_images(4, 200 + slot))
            rec["full"].append(secs)
            rec["steps"].append(decode_steps(tokens, lengths))
            rec["prefill"].append(request(synthetic_images(4, 200 + slot), max_new_tokens=1)[2])
            slot += 1
    out = {}
    for label in labels:
        rec = t[label]
        p50 = statistics.median(rec["b1"])
        full, prefill = statistics.median(rec["full"]), statistics.median(rec["prefill"])
        rate = 4 * statistics.median(rec["steps"]) / (full - prefill)
        log("times", f"{card}: {label}: p50 image->SVG latency, B=1, 128 new tokens greedy: "
                     f"{p50 * 1e3:.1f} ms ({len(rec['b1'])} requests: "
                     f"{[round(x * 1e3, 1) for x in rec['b1']]} ms, tokens {rec['tokens']}); decode "
                     f"{rate:.1f} tokens/s at B=4 (request {full * 1e3:.1f} ms of "
                     f"{[round(x * 1e3, 1) for x in rec['full']]}, image+prefill+first token "
                     f"{prefill * 1e3:.1f} ms, decode steps {rec['steps']})")
        out[label] = dict(p50=p50, rate=rate)
    return out


def memory_times(card: str, requests: dict, trees: dict) -> None:
    """Each model's weights and its peak device memory above them during a
    B=4, 128-token request."""
    images = synthetic_images(4, 50)
    parts = []
    for label, request in requests.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        request(images)
        peak = torch.cuda.max_memory_allocated() - base
        params = trees[label]
        parts.append(f"{label}: decoder weights {tree_bytes(params['svg_transformer']) / 2**30:.3f}"
                     f" GiB, all weights {tree_bytes(params) / 2**30:.3f} GiB, request peak above "
                     f"them {peak / 2**20:.1f} MiB")
    log("times", f"{card}: memory, B=4 request with 128 new tokens: " + "; ".join(parts))


def library_ms(fn, what: str, timer=None):
    """Device ms of one PyTorch library call that computes a kernel's
    function (a yardstick: the port never calls it), or None, with the
    reason logged, where this torch has no such call for the card. Only the
    probe call is guarded; a failure while timing raises."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log("times", f"{what}: no such call on this card's torch ({str(e).splitlines()[0][:160]})")
        return None
    return (timer or cuda_ms)(fn)


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per eager fn() call between two CUDA events (for the autograd
    backward, which is not captured in a graph, and library calls that take
    tenths of a second): the host's per-op cost is small beside a
    millisecond of device work."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DECODE_TIMES = ((4, 325), (8, 1285), (1, 1285))  # the 1B decode mid-request; the end of a 1k-token one


def host_us(fn, iters: int = 10_000, rounds: int = 3) -> float:
    """The calling thread's CPU microseconds per eager fn() call (the
    wrapper's host cost, launch included): `iters` calls back to back after
    a synchronisation, the least of `rounds` such runs. CPU time, not wall
    time: the machine's host is shared, and a thread that waits for a core
    is not charged for the wait. The thread's CPU clock may tick as coarsely
    as 10 ms, hence the long runs (1 us a call at 10,000 calls)."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.thread_time()
        for _ in range(iters):
            fn()
        best = min(best, time.thread_time() - t)
    torch.cuda.synchronize()
    return best / iters * 1e6


def decode_times(tfa, dc, dev, card: str) -> dict:
    """decode_attention's device time against its plain version, its bound
    and SDPA, bf16 and over an int8 cache (bf16 queries), every key visible,
    the self token merged, at B=4 T=325 (64 tokens into a 1B request) and at
    B=8 and B=1, T=1285 (the end of a 1k-token request); with its host cost
    a call at B=4 T=325. Returns B=4 T=325's figures by cache
    ("bf16", "int8"): ms, plain_ms, bound_ms, bound_by, library_ms."""
    g = torch.Generator(device=dev).manual_seed(3)
    H, D = 16, 128
    rows = {}
    for B, T in DECODE_TIMES:
        qg = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
        kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        kc, vc = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        old = torch.ones((B, T), dtype=torch.int32, device=dev)
        (kq, ks), (vq, vs) = dc.quantize_kv(kc.float()), dc.quantize_kv(vc.float())
        shape = f"B={B} T={T} G=16 D=128"
        # q, out, k_new, v_new, mask; the cache read once
        small = 2 * B * H * D * 2 + 2 * B * D * 2 + B * T * 4
        flops = 4 * D * H * B * (T + 1)
        for label, cache in (("bf16", (kc, vc, None, None)), ("int8", (kq, vq, ks, vs))):
            kk, vv, sk, sv_ = cache

            def kernel():
                return tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_)

            times = _turns(
                lambda: tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_,
                                                    kernels=False), kernel)
            cache_bytes = 2 * B * T * D * (2 if label == "bf16" else 1) + \
                (0 if label == "bf16" else 2 * B * T * 4)
            b_ms, b_by = bound(cache_bytes + small, flops)
            lib = None
            if label == "bf16":  # SDPA over the cache and the new token
                keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).expand(B, H, T + 1, D)
                        .contiguous() for c, n in ((kc, kn), (vc, vn))]
                lib = sdpa_ms(qg.reshape(B, H, 1, D), *keys, causal=False)
            host = f", {host_us(kernel):.1f} us of host CPU a call" if B == 4 else ""
            log("times", f"{card}: decode_attention {label} cache {shape}, bf16 queries: kernel "
                         f"{times[1]:.4f} ms{host}, plain {times[0]:.4f} ms, bound {b_ms:.5f} ms "
                         f"({b_by}: {cache_bytes / 1e6:.3f} MB of cache), SDPA "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
                         + ("" if label == "bf16" else " (no single PyTorch call attends over an "
                            "int8 cache)"))
            if B == 4:
                rows[label] = dict(ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib)
    return rows


def tower_prefix_times(tfa, dev, card: str, S: int = 1026) -> dict:
    """flash_prefill (bf16) at siglip_512's im2svg prefix, B = 2, S = T =
    1026 (1024 visual tokens and a 2-id prompt; phase 4f), H=16 Hkv=1,
    against its plain version, its bound and SDPA (K/V expanded to the 16
    heads), graph-replayed, in turns."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, D = 2, 16, 128
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(lambda: tfa.flash_prefill(q, k, v, mask, kernels=False),
                          lambda: tfa.flash_prefill(q, k, v, mask))
    lib = sdpa_ms(q.transpose(1, 2).contiguous(),
                  *(t.transpose(1, 2).expand(B, H, S, D).contiguous() for t in (k, v)),
                  causal=True)
    nbytes = 2 * B * S * H * D * 2 + 2 * B * S * D * 2 + B * S * 4
    flops = 4 * D * H * B * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill B={B} S=T={S} H={H} Hkv=1 D={D} bf16 (siglip_512's "
                 f"prefix): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                 f"{b_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                 f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), SDPA "
                 f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def _sdpa_causal(S: int, T: int) -> dict:
    """SDPA's causal arguments with the last of S queries on the last of T
    keys (the kernels' q_offset = T - S)."""
    from torch.nn.attention.bias import causal_lower_right

    return dict(is_causal=True) if S == T else dict(attn_mask=causal_lower_right(S, T))


def sdpa_ms(q, k, v, causal: bool, **kw):
    """F.scaled_dot_product_attention on (B, H, S, D) queries over
    (B, H, T, D) keys, K/V expanded to all heads (or (B, Hkv, T, D) with
    enable_gqa=True in `kw`); causal with the last query on the last key
    (lower right, which is top left when S = T). The faster of the backend
    it dispatches to by itself and its flash or memory-efficient backend
    (the two differ for one-token decode)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = _sdpa_causal(q.shape[2], k.shape[2]) if causal else {}

    def fused():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, **mask, **kw)

    times = [library_ms(lambda: F.scaled_dot_product_attention(q, k, v, **mask, **kw),
                        "scaled_dot_product_attention"),
             library_ms(fused, "scaled_dot_product_attention, flash/efficient")]
    times = [t for t in times if t is not None]
    return min(times) if times else None


GEMV_TIME_ROWS = (1, 4, 8, 16)  # decode at B = 1, 4; num_return_sequences; 4e's 16 slots
GEMV_ROTATE_BYTES = 160 << 20  # weights a timed GEMV runs through: past the 50 MB L2
# M = 144: a fused decode+chunk step of phase 4e (B = 16 rows x (1 + C = 8))
QMM_TIMES = ((144, "tile"), (260, "tile"), (1040, "tile"))


def gemv_times(tq, dev, card: str, shapes, label: str, seed: int) -> dict:
    """Kernel 14's two GEMV designs, the tensor-core GEMV (on gemv_plan's
    plan) and the CUDA-core pair, in turns with the plain version (plain,
    tensor-core, pair, pair, tensor-core, plain), at M = GEMV_TIME_ROWS and
    each (name, K, N) of `shapes`, bf16 x with a bf16 bias; beside each its
    bound, the bf16 cuBLAS addmm over the dequantized weight,
    torch._weight_int8pack_mm and each design's host CPU us a call. Every
    timed launch reads another copy of the codes, of copies passing
    GEMV_ROTATE_BYTES together, so that it streams them from HBM as a
    decode step does (its layers' weights pass the 50 MB L2). Returns
    {(name, M): figures}; the design gemv_path picks is `kernel`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for name, K, N in shapes:
        n = max(2, min(64, -(-GEMV_ROTATE_BYTES // (K * N))))
        ws = [(torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
               torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4,
               torch.randn((N,), generator=g, device=dev).bfloat16()) for _ in range(n)]
        w16 = [(kq.float() * sc).bfloat16() for kq, sc, _ in ws]
        kq_nk, sc16 = ws[0][0].t().contiguous(), ws[0][1].bfloat16()
        plan, split = tq.gemv_plan(K, N), tq.gemv_split(K, N)
        for M in GEMV_TIME_ROWS:
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            calls = {
                "plain": lambda w: tq.quant_matmul(x, w[0], w[1], w[2], out_dtype=torch.bfloat16,
                                                   kernels=False),
                "gemv_tc": lambda w: tq.launch_gemv_tc(x, w[0], w[1], w[2], torch.bfloat16,
                                                       *plan),
                "gemv": lambda w: tq.launch_kernel(x, w[0], w[1], w[2], torch.bfloat16, "gemv", 0,
                                                   *split)}
            got = {k: [] for k in calls}
            for k in ("plain", "gemv_tc", "gemv", "gemv", "gemv_tc", "plain"):
                got[k].append(rotated_ms(calls[k], ws))
            ms = {k: sum(v) / len(v) for k, v in got.items()}
            addmm = rotated_ms(lambda w: torch.addmm(ws[0][2], x, w), w16)
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm")
            host = {k: host_us(lambda: calls[k](ws[0]), iters=4000, rounds=1)
                    for k in ("gemv_tc", "gemv")}
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, 2 * M * K * N)
            path = tq.gemv_path(M, K, N, torch.bfloat16)
            rows[name, M] = dict(ms=ms[path], plain_ms=ms["plain"], bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib if lib is not None else addmm, addmm_ms=addmm,
                                 int8pack_ms=lib, tc_ms=ms["gemv_tc"], pair_ms=ms["gemv"],
                                 tc_host_us=host["gemv_tc"], pair_host_us=host["gemv"],
                                 path=path)
            log("times", f"{card}: quant_matmul GEMV {label} {name} M={M} K={K} N={N} bf16: "
                         f"tensor-core {ms['gemv_tc']:.4f} ms ({b_ms / ms['gemv_tc']:.1%} of the "
                         f"bound; plan {plan}), pair {ms['gemv']:.4f} ms "
                         f"({b_ms / ms['gemv']:.1%}), gemv_path keeps {path}; plain "
                         f"{ms['plain']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), bf16 addmm "
                         f"{addmm:.4f} ms (reads 2 bytes a weight), int8pack_mm "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}; host CPU a call "
                         f"{host['gemv_tc']:.1f} us tensor-core, {host['gemv']:.1f} us pair")
            del x
        del ws, w16, kq_nk
        torch.cuda.empty_cache()
    for M in GEMV_TIME_ROWS:
        total = {k: sum(rows[nm, M][k] for nm, _, _ in shapes)
                 for k in ("ms", "tc_ms", "pair_ms", "addmm_ms", "bound_ms")}
        log("times", f"{card}: quant_matmul GEMV {label}, M={M}, the projections "
                     f"{', '.join(nm for nm, _, _ in shapes)} once each: gemv_path's picks "
                     f"{total['ms']:.4f} ms (tensor-core {total['tc_ms']:.4f}, pair "
                     f"{total['pair_ms']:.4f}), bf16 addmm {total['addmm_ms']:.4f} ms, bound "
                     f"{total['bound_ms']:.4f} ms")
    return rows


def rotated_ms(fn, items: list) -> float:
    """Device ms a call of fn(item), the graph's calls going through
    `items` in turn (cuda_ms)."""
    state = {"i": 0}

    def one():
        fn(items[state["i"] % len(items)])
        state["i"] += 1

    return cuda_ms(one, iters=max(48, 2 * len(items)))


def gemv_rows(rows: dict, name: str, M: int = 4) -> dict:
    """The kernels' JSON figures of each GEMV design at one shape."""
    r = rows[name, M]
    keys = ("plain_ms", "bound_ms", "bound_by", "library_ms", "addmm_ms")
    return {"gemv_tc": dict(ms=r["tc_ms"], **{k: r[k] for k in keys}),
            "gemv": dict(ms=r["pair_ms"], **{k: r[k] for k in keys})}


def quant_matmul_times(tq, dev, card: str) -> dict:
    """Kernel 14 against its plain version, the library's int8 weight
    matmul (torch._weight_int8pack_mm, where this torch has it for CUDA) and
    the bf16 cuBLAS addmm: the GEMV's two designs at M = 1, 4, 8, 16
    (gemv_times: decode at B = 1, 4, num_return_sequences, 4e's slots) and
    the tile at M = 144 (a fused decode+chunk step of phase 4e), 260 and
    1040 (a B=1 and a B=4 prefill) for the four projections, bf16 x with a
    bf16 bias, each beside its bound (the tile also in TFLOP/s and share of
    the bound, and at every width and split of K that tile_plan weighs);
    then one prefill's 96 projections (prefill_projection_times). Returns
    mlp.c_fc's figures, the largest, by design ("gemv_tc" and "gemv" at
    M = 4, "tile" at M = 1040, "tile_m144"): ms, plain_ms, bound_ms,
    bound_by, library_ms, addmm_ms."""
    rows = gemv_rows(gemv_times(tq, dev, card, QMM_SHAPES, "1B", 10), "mlp.c_fc") \
        if hasattr(tq, "gemv_plan") else {}
    g = torch.Generator(device=dev).manual_seed(10)
    for M, path in QMM_TIMES:
        total = dict(ms=0.0, plain=0.0, addmm=0.0, bound=0.0)
        for name, K, N in QMM_SHAPES:
            p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
            kq, sc = p["kernel_q"], p["scale"]
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            b = torch.randn((N,), generator=g, device=dev).bfloat16()
            plain_ms, ms = _turns(
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16, kernels=False),
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16))
            w16 = (kq.float() * sc).bfloat16()
            addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w16))
            kq_nk, sc16 = kq.t().contiguous(), sc.bfloat16()
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm")
            flops = 2 * M * K * N
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, flops)
            for key, val in (("ms", ms), ("plain", plain_ms), ("addmm", addmm_ms), ("bound", b_ms)):
                total[key] += val
            log("times", f"{card}: quant_matmul {path} {name} M={M} K={K} N={N} bf16: kernel "
                         f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the "
                         f"bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                         f"int8pack_mm {'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 addmm "
                         f"{addmm_ms:.4f} ms (reads 2 bytes a weight)")
            if TIMINGS:
                tile_plan_times(tq, x, kq, sc, b, name, card)
            if name == "mlp.c_fc" and M in (144, 1040):
                rows[path if M != 144 else "tile_m144"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib if lib is not None else addmm_ms, addmm_ms=addmm_ms)
        log("times", f"{card}: quant_matmul {path}, M={M}, one layer's four projections: kernel "
                     f"{total['ms']:.4f} ms, plain {total['plain']:.4f} ms, bf16 addmm "
                     f"{total['addmm']:.4f} ms, bound {total['bound']:.4f} ms; x 24 layers: "
                     f"kernel {24 * total['ms']:.3f} ms, bf16 addmm {24 * total['addmm']:.3f} ms")
    if TIMINGS:
        rows["prefill"] = prefill_projection_times(tq, dev, card)
    return rows


def tile_plan_times(tq, x, kq, sc, b, name: str, card: str) -> None:
    """The wgmma tile at each height (rows of x a block) and split of K that
    tile_plan weighs, launched directly (bf16 out), beside the plan
    tile_plan picks: the figures its fixed rule is held to."""
    M, K = x.shape
    N = kq.shape[1]
    parts, times = [], {}
    for tile_x in tq.TILE_XS:
        for want in range(1, 9):
            kc = 2 * tq.TILE_K * -(-K // (want * 2 * tq.TILE_K))
            splits = -(-K // kc)
            if (tile_x, splits) in times:
                continue
            times[tile_x, splits] = cuda_ms(lambda: tq.launch_kernel(
                x, kq, sc, b, torch.bfloat16, "wgmma", tile_x, splits, kc))
            parts.append(f"{tile_x} x{splits} {times[tile_x, splits]:.4f}")
    tile_x, splits, _ = tq.tile_plan(M, K, N)
    fastest = min(times, key=times.get)
    log("times", f"{card}: quant_matmul tile {name} M={M}: ms by rows of x a block x splits of "
                 f"K: {', '.join(parts)}; tile_plan picks {tile_x} x{splits} "
                 f"({times[tile_x, splits]:.4f} ms), the fastest is {fastest[0]} x{fastest[1]}")


def prefill_projection_times(tq, dev, card: str, layers: int = 24) -> dict:
    """One prefill's 96 int8 projections (24 layers x 4, each with its own
    codes: about 1 GB, so they come from HBM and not from the 50 MB L2, as
    a single reused weight would) captured as one graph, at M = 260 (B=1)
    and M = 1040 (B=4), beside the same 96 bf16 cuBLAS addmm calls over the
    dequantized weights (2 GB). Returns {M: (kernel ms, addmm ms)}."""
    g = torch.Generator(device=dev).manual_seed(12)
    weights = []
    for _ in range(layers):
        for _, K, N in QMM_SHAPES:
            kq = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            sc = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4
            weights.append((kq, sc, torch.randn((N,), generator=g, device=dev).bfloat16()))
    w16 = [(kq.float() * sc).bfloat16() for kq, sc, _ in weights]
    out = {}
    for M in (260, 1040):
        xs = {K: torch.randn((M, K), generator=g, device=dev).bfloat16()
              for K in {K for _, K, _ in QMM_SHAPES}}

        def kernel():
            for kq, sc, b in weights:
                tq.quant_matmul(xs[kq.shape[0]], kq, sc, b, out_dtype=torch.bfloat16)

        def addmm():
            for (kq, _, b), w in zip(weights, w16):
                torch.addmm(b, xs[kq.shape[0]], w)

        ms, addmm_ms = cuda_ms(kernel, iters=4), cuda_ms(addmm, iters=4)
        flops = 2 * M * layers * sum(K * N for _, K, N in QMM_SHAPES)
        codes = sum(w.numel() for w, _, _ in weights) / 1e9
        log("times", f"{card}: quant_matmul, one prefill's {len(weights)} projections over "
                     f"{layers} layers' own weights ({codes:.2f} GB of codes), M={M}, one "
                     f"graph: kernel {ms:.3f} ms "
                     f"({flops / ms / 1e9:.1f} TFLOP/s), bf16 addmm {addmm_ms:.3f} ms "
                     f"({flops / addmm_ms / 1e9:.1f} TFLOP/s)")
        out[M] = (ms, addmm_ms)
    del weights, w16
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4b: the decoding variants and GRPO at full 1B width
# ---------------------------------------------------------------------------

class BatchSpy:
    """Within `with BatchSpy(module) as spy:`, spy.rows lists the batch of
    every call of module.forward (the decoders' cached and training
    forward) and module.forward_decode_static (generate's decode steps), in
    call order, to show where a prefill ran at B rows and the steps at
    more. A graph replay calls neither: a captured block's rows, recorded
    at its capture, are listed once a replay."""

    NAMES = ("forward", "forward_decode_static")

    def __init__(self, module):
        self.module, self.rows = module, []

    def __enter__(self):
        from starvector_tpu_torch.generation import graphs

        self.saved = {name: getattr(self.module, name) for name in self.NAMES}
        self.init, self.replay = graphs.StepGraph.__init__, graphs.StepGraph.replay
        capturing = []

        def spied(fn):
            def call(params, cfg, x, *a, **kw):
                (capturing[-1] if capturing else self.rows).append(x.shape[0])
                return fn(params, cfg, x, *a, **kw)
            return call

        def capture(graph, fn, *a, **kw):
            capturing.append([])
            try:
                self.init(graph, fn, *a, **kw)
            finally:
                graph.spied_rows = capturing.pop()

        def replay(graph):
            self.rows.extend(getattr(graph, "spied_rows", []))
            return self.replay(graph)

        for name, fn in self.saved.items():
            setattr(self.module, name, spied(fn))
        graphs.StepGraph.__init__, graphs.StepGraph.replay = capture, replay
        return self

    def __exit__(self, *exc):
        from starvector_tpu_torch.generation import graphs

        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        graphs.StepGraph.__init__, graphs.StepGraph.replay = self.init, self.replay


def expect_counts(what: str, counts: dict, **expected) -> dict:
    """Raise unless each named launch count is as given and every other
    kernel (the training ones, int8 decode, quant_matmul) launched none."""
    want = {"flash_prefill": 0, "decode_attention": 0, "decode_attention_int8": 0,
            "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0), **expected}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what} launches {got}, expected {want}")
    return got


def spec_ids(P: int, prompt: torch.Tensor) -> torch.Tensor:
    """The draft context of an im2svg prefix of P tokens: -1 over the
    visual tokens, then the prompt ids."""
    B, Sp = prompt.shape
    return torch.cat([torch.full((B, P - Sp), -1, dtype=torch.int64, device=prompt.device),
                      prompt], dim=1)


def first_parting(tokens: torch.Tensor, ref: torch.Tensor) -> int | None:
    """The first position where two rows of ids differ, or None."""
    diff = (tokens != ref).nonzero()
    return int(diff[0]) if len(diff) else None


def same_as_greedy(tokens, lengths, ref, ref_len) -> list[bool]:
    """Per row: the same length and the same ids up to it."""
    return [int(a) == int(b) and torch.equal(t[:int(a)], r[:int(b)])
            for t, a, r, b in zip(tokens, lengths, ref, ref_len)]


def request_turns(card: str, what: str, requests: dict, images_of, rounds: int = 2) -> dict:
    """{label: (median seconds, median tokens/s)} of requests taken in turns
    a, b, ..., b, a each round on the same images (images_of(round)); tokens/s
    counts each row's emitted tokens (its length) over the request's wall
    time."""
    labels = list(requests)
    secs = {k: [] for k in labels}
    rates = {k: [] for k in labels}
    for r in range(rounds):
        images = images_of(r)
        for label in labels + labels[::-1]:
            _, lengths, t = requests[label](images)
            secs[label].append(t)
            rates[label].append(float(lengths.sum()) / t)
    out = {k: (statistics.median(secs[k]), statistics.median(rates[k])) for k in labels}
    log("times", f"{card}: {what}, in turns ({2 * rounds} requests each): "
                 + "; ".join(f"{k} {v[0] * 1e3:.1f} ms ({[round(x * 1e3, 1) for x in secs[k]]}), "
                             f"{v[1]:.1f} tokens/s" for k, v in out.items()))
    return out


def decoding_1b(tfa, model, cfg, p16, p32, q16, dev, card: str) -> dict:
    """Phase 4b, the decoding variants at full 1B width on phase 4's weights
    (projections scaled by 3, the fixed "<svg" / "</svg>" ids), each with
    exact launch counts, through the API unless said:
      * beam search, num_beams=2, B=2, 128 new tokens: one flash_prefill a
        layer over B x K = 4 rows, one decode_attention a layer a step;
        fp32 ids kernels == plain;
      * num_return_sequences=4 over B=2, greedy: the prefill once at B=2
        rows, the steps at 8; each group of 4 rows the same, and in fp32
        equal to its n=1 row; fp32 ids kernels == plain. Then over the int8
        decoder and an int8 cache (engine.generate): kernel 14's GEMV at
        M = 8 and kernel 2's int8 instantiation over the tiled codes and
        scales;
      * speculative decoding, B=1 (linear cache) and B=4 (ragged):
        flash_prefill only (the verify is the chunk step, plain PyTorch);
        n_forwards and tokens a forward (generate_greedy_speculative*
        directly); fp32 ids == plain greedy generate with the kernels; in
        bf16, the rows that part from plain greedy (near-tie flips between
        the verify's and the decode step's arithmetic);
      * times in turns: B=1 latency of greedy, speculative and beam K=2;
        B=4 tokens/s of greedy and batched speculative;
      * GRPO: grpo_step (below).
    Random weights: an acceptance rate here is no forecast for real SVG."""
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation import speculative
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = model.policy
    request = api_requester(model)
    m32 = {k: StarVectorForCausalLM(p32, cfg, policy=f32, device=dev, kernels=k)
           for k in (True, False)}
    two = synthetic_images(2, 31)
    x2 = model.process_images(two)
    greedy2 = {**GREEDY, "prompt_ids": [PROMPT_IDS] * 2}
    fp32_2 = {**greedy2, "max_new_tokens": 32}

    # --- beam search ---
    request(two, num_beams=2, max_new_tokens=4, prompt_ids=[PROMPT_IDS] * 2)  # warm-up
    reset_counts(tfa)
    with BatchSpy(gpt_bigcode) as spy:
        tokens, lengths, _ = request(two, num_beams=2, prompt_ids=[PROMPT_IDS] * 2)
    counts = read_counts(tfa)
    steps = len(spy.rows) - 1
    expect_counts("beam", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [4] * (steps + 1) or not int(lengths.max()) - 1 <= steps <= 127 or \
            tokens.shape != (2, 128):
        raise AssertionError(f"beam: forwards at rows {spy.rows}, lengths {lengths.tolist()}")
    ids = {k: m32[k].generate_im2svg_ids({"image": x2}, num_beams=2, **fp32_2)[1:]
           for k in (True, False)}
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"beam fp32 ids differ:\n{ids[True]}\n{ids[False]}")
    log("decoding", f"beam search, num_beams=2, B=2, 128 new tokens, bf16: lengths "
                    f"{lengths.tolist()}; {steps + 1} forwards, all at B x K = 4 rows; launches "
                    f"flash_prefill {counts['flash_prefill']} = {L} x 1 prefill, decode_attention "
                    f"{counts['decode_attention']} = {L} x {steps} steps; fp32, 32 tokens: ids and "
                    f"lengths with the kernels == plain ({ids[True][1].tolist()})")

    # --- num_return_sequences ---
    n = 4
    reset_counts(tfa)
    with BatchSpy(gpt_bigcode) as spy:
        tokens, lengths, _ = request(two, num_return_sequences=n, prompt_ids=[PROMPT_IDS] * 2)
    counts = read_counts(tfa)
    steps = decode_steps(tokens, lengths)
    expect_counts("num_return_sequences", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [2] + [2 * n] * steps or tokens.shape != (2 * n, 128):
        raise AssertionError(f"num_return_sequences: forwards at rows {spy.rows}")
    groups = tokens.view(2, n, -1)
    if not all(torch.equal(g[0], g[i]) for g in groups for i in range(n)):
        raise AssertionError("num_return_sequences: a greedy group's rows differ")
    one, one_len, _ = request(two, prompt_ids=[PROMPT_IDS] * 2)
    agree = (groups[:, 0] == one).float().mean().item()
    rep32 = {k: m32[k].generate_im2svg_ids({"image": x2}, num_return_sequences=n, **fp32_2)[1:]
             for k in (True, False)}
    one32 = m32[True].generate_im2svg_ids({"image": x2}, **fp32_2)[1:]
    if not all(torch.equal(a, b) for a, b in zip(rep32[True], rep32[False])) or \
            not torch.equal(rep32[True][0], one32[0].repeat_interleave(n, 0)) or \
            not torch.equal(rep32[True][1], one32[1].repeat_interleave(n, 0)):
        raise AssertionError(f"num_return_sequences fp32: kernels {rep32[True]}, plain "
                             f"{rep32[False]}, n=1 {one32}")
    log("decoding", f"num_return_sequences={n}, B=2, greedy, 128 new tokens, bf16: one prefill "
                    f"at 2 rows, {steps} steps at {2 * n}; launches flash_prefill "
                    f"{counts['flash_prefill']} = {L} x 1, decode_attention "
                    f"{counts['decode_attention']} = {L} x {steps}; each group's {n} rows "
                    f"identical, agreeing with the n=1 rows on {agree:.4f} of the positions "
                    f"(bf16: the decode kernel splits its keys by batch size); fp32, 32 tokens: "
                    f"kernels == plain, and every row == its n=1 row")

    prompt2 = torch.tensor([PROMPT_IDS] * 2, device=dev)

    def int8_rep(params, policy, kernels, max_new_tokens, kv_cache_dtype=torch.int8):
        emb, mask = im2svg_prefix(params, cfg, x2, prompt2, policy=policy)
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                               stop_sequences=STOP_IDS, num_return_sequences=n)
        return generate(params["svg_transformer"], cfg.llm, emb, mask, gen, prompt_ids=prompt2,
                        policy=policy, kernels=kernels, kv_cache_dtype=kv_cache_dtype)

    reset_counts(tfa)
    tokens, lengths = int8_rep(q16, bf16, True, 128)
    counts = read_counts(tfa)
    steps = decode_steps(tokens, lengths)
    got = expect_counts("num_return_sequences int8", counts, flash_prefill=L,
                        decode_attention=L * steps, decode_attention_int8=L * steps,
                        quant_matmul=4 * L * (1 + steps))
    want = {**gemv_counts(tq, [(K, N) for _, K, N in QMM_SHAPES], [(2 * n, L * steps)]),
            "quant_matmul_wgmma": 4 * L}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"num_return_sequences int8: quant_matmul paths {counts}, "
                             f"expected {want}")
    groups = tokens.view(2, n, -1)
    if not all(torch.equal(g[0], g[i]) for g in groups for i in range(n)):
        raise AssertionError("num_return_sequences int8: a greedy group's rows differ")
    # fp32 ids, kernels against plain, with the int8 weights and an fp32
    # cache: over an int8 cache the two paths' k/v differ in fp32 sum order,
    # some round to the next code, and greedy ids part by chance (PR 12,
    # call 1: at token 26 of 32 in one of the 2 prompts; PERF.md section 6)
    q32 = quantized(p32)
    ids = {k: int8_rep(q32, f32, k, 32, torch.float32) for k in (True, False)}
    del q32
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"num_return_sequences int8 fp32 ids differ:\n{ids[True]}\n"
                             f"{ids[False]}")
    log("decoding", f"num_return_sequences={n} over the int8 decoder and an int8 cache, B=2, "
                    f"128 new tokens: {steps} steps at {2 * n} rows; launches quant_matmul "
                    f"{got['quant_matmul']} (GEMV {counts['quant_matmul_gemv']} = 96 x {steps} "
                    f"steps at M = {2 * n}, tile {counts['quant_matmul_wgmma']} = 96 x 1 prefill), "
                    f"int8 decode_attention {got['decode_attention_int8']} = {L} x {steps} over "
                    f"the tiled codes and scales, flash_prefill {got['flash_prefill']}; groups "
                    f"identical; fp32, int8 weights and an fp32 cache, 32 tokens: ids kernels "
                    f"== plain")

    # --- speculative decoding ---
    four = synthetic_images(4, 41)
    x4 = model.process_images(four)
    prompt4 = torch.tensor([PROMPT_IDS] * 4, device=dev)
    spec = dict(use_speculative=True, draft_len=8)
    tallies = {}
    for B in (1, 4):
        request(four[:B], max_new_tokens=8, prompt_ids=[PROMPT_IDS] * B, **spec)  # warm-up
        reset_counts(tfa)
        tokens, lengths, _ = request(four[:B], prompt_ids=[PROMPT_IDS] * B, **spec)
        expect_counts(f"speculative B={B}", read_counts(tfa), flash_prefill=L)
        tallies[B] = graph_tally()
    log("decoding", f"speculative decoding through the API (use_speculative, draft_len 8), bf16, "
                    f"B=1 and B=4, 128 new tokens, the verify rounds as CUDA graphs ({tallies}): "
                    f"launches flash_prefill {L} a request (the prefill), no decode_attention: "
                    f"each verify is the chunk step, plain PyTorch")
    sp = speculative_checks(tfa, "1B", cfg, p16, bf16, cfg, p32, f32, x4, prompt4, card)
    # --- times, in turns (--timings) ---
    b1 = b4 = None
    if TIMINGS:
        t_times = time.perf_counter()
        b1 = request_turns(card, "1B bf16 B=1 image -> SVG latency, 128 new tokens", {
            "greedy": lambda im: request(im, prompt_ids=[PROMPT_IDS]),
            "speculative": lambda im: request(im, prompt_ids=[PROMPT_IDS], **spec),
            "beam K=2": lambda im: request(im, prompt_ids=[PROMPT_IDS], num_beams=2),
        }, lambda r: synthetic_images(1, 300 + r), rounds=3)
        b4 = request_turns(card, "1B bf16 B=4 request, 128 new tokens (tokens/s = emitted "
                                 "tokens / wall time)", {
            "greedy": lambda im: request(im),
            "speculative": lambda im: request(im, **spec),
        }, lambda r: synthetic_images(4, 400 + r))
        timed_only("4b's request turns", t_times)
    del m32
    return dict(b1=b1, b4=b4, **sp)


def speculative_checks(tfa, label: str, cfg, p16, bf16, cfg32, p32, f32, x, prompt,
                       card: str) -> dict:
    """Speculative decoding through generate_greedy_speculative (row 0) and
    generate_greedy_speculative_batched (all rows of x), draft_len 8, each
    a loop of static verify rounds replayed as CUDA graphs. In bf16 at 128
    new tokens: each loop's line, uncaptured against graphed
    (loop_times), the graphed call's launches exactly kernel 1's prefill
    (every verify is the chunk step) and the uncaptured call's;
    n_forwards, tokens a verify forward and the rows that part from plain
    greedy generate (near-tie flips between the verify's chunk arithmetic
    and the decode kernel's; printed, not checked). In fp32 at 32 tokens on
    (cfg32, p32): ids, lengths and n_forwards graphed == uncaptured bit for
    bit, and ids and lengths == plain greedy generate with the kernels
    (checked)."""
    from starvector_tpu_torch.generation import speculative
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix

    out = {}
    B = x.shape[0]
    for what, c, params, policy, new in (("bf16", cfg, p16, bf16, 128),
                                         ("fp32", cfg32, p32, f32, 32)):
        dec = params["svg_transformer"]
        L = c.llm.n_layer if hasattr(c.llm, "n_layer") else c.llm.num_hidden_layers
        emb, mask = im2svg_prefix(params, c, x, prompt, policy=policy)
        ids = spec_ids(emb.shape[1], prompt)
        kw = dict(max_new_tokens=new, draft_len=8, stop_sequences=STOP_IDS, policy=policy)
        ref, ref_len = generate(dec, c.llm, emb, mask, GenerationConfig(
            max_new_tokens=new, do_sample=False, stop_sequences=STOP_IDS), policy=policy)
        runs = {"B=1": lambda g: speculative.generate_greedy_speculative(
                    dec, c.llm, emb[:1], mask[:1], ids[:1], cuda_graphs=g, **kw),
                f"batched B={B}": lambda g: speculative.generate_greedy_speculative_batched(
                    dec, c.llm, emb, mask, ids, cuda_graphs=g, **kw)}
        res, captures = {}, {}
        for name, run in runs.items():
            if what == "bf16":
                t = loop_times(card, f"{label} speculative {name}, bf16, draft_len 8, {new} new "
                                     f"tokens", run, lambda r: r[2] - 1, "round", tfa=tfa)
                g, u = t["graphed"], t["uncaptured"]
                expect_counts(f"{label} speculative {name} bf16, graphed", g["counts"],
                              flash_prefill=L)
                if g["counts"] != u["counts"]:
                    raise AssertionError(f"{label} speculative {name} bf16: launches graphed "
                                         f"{g['counts']} != uncaptured {u['counts']}")
                res[name], captures[name] = g["result"], g["captures"]
            else:
                res[name] = run(True)
                same_run(f"{label} speculative {name} fp32 (ids, lengths, n_forwards), graphed "
                         f"against uncaptured", res[name], run(False))
        (t1, l1, f1), (tb, lb, fb) = res.values()
        same = same_as_greedy(t1, l1, ref[:1], ref_len[:1]) + same_as_greedy(tb, lb, ref, ref_len)
        parts = [first_parting(t, r) for t, r in zip(torch.cat([t1[:, :new], tb]),
                                                      torch.cat([ref[:1], ref]))]
        if what == "fp32" and not all(same):
            raise AssertionError(f"{label} speculative fp32 ids differ from greedy:\n"
                                 f"{t1.tolist()}\n{tb.tolist()}\n{ref.tolist()}")
        log("decoding", f"{label} speculative decoding, {what}, draft_len 8, {new} new tokens, "
                        f"rounds replayed as CUDA graphs: "
                        f"B=1 length {int(l1[0])}, n_forwards {f1} "
                        f"({int(l1[0]) / max(f1 - 1, 1):.2f} tokens a verify forward); batched "
                        f"B={B}: lengths {lb.tolist()}, n_forwards {fb} "
                        f"({float(lb.sum()) / max(fb - 1, 1):.2f} tokens a round over {B} rows); "
                        + (f"graphs captured a call {captures}; launches flash_prefill {L} a call "
                           f"(the prefill), nothing else, == the uncaptured calls'; rows parting "
                           f"from plain greedy generate: B=1 {int(not same[0])} of 1, "
                           f"batched {same[1:].count(False)} of {B}, at token {parts} (None: "
                           f"never; bf16 near-tie flips between the verify and the decode step)"
                           if what == "bf16" else "ids, lengths and n_forwards graphed == "
                                                  "uncaptured (cuda_graphs=False) bit for bit; "
                                                  "ids and lengths == plain greedy generate "
                                                  "with the kernels, every row"))
        out[what] = dict(n_forwards=(f1, fb), lengths=(l1.tolist(), lb.tolist()), parts=parts)
    log("decoding", f"{label}: random weights, so the acceptance above is no forecast for real "
                    f"SVG")
    return out


GRPO_B, GRPO_G, GRPO_NEW, GRPO_LR = 2, 4, 64, 1e-5


def grpo_rollout(roll: dict) -> dict:
    """The update's inputs from a generate_im2svg_grpo result, as
    GRPOTrainer.step builds them."""
    ids, P = roll["outputs"], roll["prompt_len"]
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    attn = (pos < P + roll["lengths"][:, None]).to(torch.int32)
    return {"vision_embeds": roll["inputs_embeds"][:, :roll["inputs_embeds"].shape[1] - P],
            "ids": ids, "attn_mask": attn, "loss_mask": attn * (pos >= P).to(torch.int32)}


def grpo_phase(sv, tfa, cfg, dev, card: str) -> dict:
    """GRPO at full 1B width: one GRPOTrainer.step (fp32 masters, bf16
    compute, remat "dots", AdamW at lr 1e-5; the decoder alone trains) at
    B=2 images, G=4 rollouts each, 64 new tokens, against a synthetic target
    raster (where this machine has no librsvg/cairo, a stand-in reward):
    the rollout launches flash_prefill once a layer (at B=2 rows) and
    decode_attention once a layer a step (at 8); the update 2 x 24
    forwards-with-lse (remat "dots" runs each layer's forward twice) and 24
    of each backward kernel; the loss finite; then the same step again,
    warm; the tower and the adapter unchanged, the decoder changed unless
    every group was scored alike; wall time split into rollout, reward and
    update for both steps, and peak memory. Then,
    on one rollout with fixed advantages, one fp32 update with the kernels
    against one with the plain attention from the same weights: loss rtol
    1e-4, grad_norm rtol 1e-3, updated weights within 3 lr (phase 5's
    bounds)."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.rasterize import rasterizer_available
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train import grpo
    from starvector_tpu_torch.train.optim import build_optimizer, tree_leaves

    L = cfg.llm.n_layer
    tok = build_test_tokenizer("v1")
    target = np.full((224, 224, 3), 255, np.uint8)  # a red square on white
    target[56:168, 56:168] = (220, 40, 40)
    p32 = full_width_params(sv, cfg, dev, torch.float32, seed=5)
    model = StarVectorForCausalLM(p32, cfg, tok, device=dev,
                                  policy=DTypePolicy(torch.float32, torch.bfloat16),
                                  generator=torch.Generator(device=dev).manual_seed(5))
    before = {k: [t.clone() for t in tree_leaves(v)] for k, v in p32.items()}
    trainer = grpo.GRPOTrainer(model, grpo.GRPOConfig(num_generations=GRPO_G,
                                                      max_new_tokens=GRPO_NEW),
                               lr=GRPO_LR, remat="dots")
    images = model.process_images(synthetic_images(GRPO_B, 51))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    rewards = []
    batch_rewards = grpo.batch_rewards
    raster = rasterizer_available()
    if raster:
        reward_fn = batch_rewards
    else:
        # no librsvg/cairo here: every rollout would fall to the placeholder
        # and score 0 (after a worker process or two each), so the advantages
        # would be 0 and the update would move nothing. A stand-in reward,
        # the mean of each rollout's generated ids over the vocabulary's size
        # (its text says little: the byte-level test tokenizer decodes the
        # ids past its 261 to nothing), keeps the update real; the reward
        # chain itself is held to JAX's on the CPU (tests/test_torch_grpo.py)
        rollout = model.generate_im2svg_grpo

        def spied(*a, **kw):
            roll = rollout(*a, **kw)
            model.last_rollout = roll
            return roll

        model.generate_im2svg_grpo = spied

        def reward_fn(raw_svgs, targets, **kw):
            roll = model.last_rollout
            P = roll["prompt_len"]
            return np.asarray([row[P:P + n].double().mean().item() / cfg.llm.vocab_size
                               for row, n in zip(roll["outputs"].cpu(), roll["lengths"].tolist())],
                              np.float32)
    grpo.batch_rewards = lambda *a, **kw: rewards.append(reward_fn(*a, **kw)) or rewards[-1]
    try:
        with BatchSpy(cfg.decoder_module) as spy:
            out = trainer.step(images, [target] * GRPO_B)
        counts = read_counts(tfa)
        warm = trainer.step(images, [target] * GRPO_B)  # the same step again, warm
    finally:
        grpo.batch_rewards = batch_rewards
    peak = torch.cuda.max_memory_allocated()
    steps = len(spy.rows) - 2  # the rollout's prefill and steps, then the update's forward
    rows = [GRPO_B] + [GRPO_B * GRPO_G] * steps + [GRPO_B * GRPO_G]
    expect_counts("GRPO step", counts, flash_prefill=L, decode_attention=L * steps,
                  flash_prefill_with_lse=2 * L, flash_bwd_dkdv=L, flash_bwd_dq=L)
    if spy.rows != rows or not 0 <= steps < GRPO_NEW or not np.isfinite(out["loss"]):
        raise AssertionError(f"GRPO step: forwards at rows {spy.rows}, metrics {out}")
    source = ("svg_pixel_reward against the target" if raster else
              "a stand-in (no librsvg/cairo on this machine: rasterizer_available() is False)")
    moved = {k: [not torch.equal(a, b.detach()) for a, b in zip(before[k], tree_leaves(p32[k]))]
             for k in p32}
    # the updates move the decoder only if a group's rewards differ (a group
    # scored alike has advantages 0, and so no gradient)
    varies = any(bool((r.reshape(GRPO_B, GRPO_G).std(axis=1) > 0).any()) for r in rewards)
    if any(any(m) for k, m in moved.items() if k != "svg_transformer") or \
            varies != any(moved["svg_transformer"]) or not np.isfinite(warm["loss"]):
        raise AssertionError(f"GRPO step: leaves moved {moved}, metrics {out}")
    log("grpo", f"GRPOTrainer.step, StarVector-1B full width, B={GRPO_B} x G={GRPO_G}, "
                f"{GRPO_NEW} new tokens (sampled, T 1.0, top-p 0.9), fp32 masters / bf16 compute, "
                f"remat dots, AdamW lr {GRPO_LR}: rollout at rows {spy.rows[0]} then {steps} "
                f"steps at {GRPO_B * GRPO_G}; launches {counts['flash_prefill']} flash_prefill "
                f"+ {counts['decode_attention']} decode_attention (rollout), "
                f"{counts['flash_prefill_with_lse']} flash_prefill_with_lse + "
                f"{counts['flash_bwd_dkdv']} dkdv + {counts['flash_bwd_dq']} dq (update); "
                f"reward: {source}, "
                f"{[[round(float(x), 4) for x in r] for r in rewards]} over two steps (a group's "
                f"differ: {varies}); loss {out['loss']:.6f}, {warm['loss']:.6f}, grad_norm "
                f"{out['grad_norm']:.4e}, {warm['grad_norm']:.4e}; decoder leaves moved "
                f"{sum(moved['svg_transformer'])} of {len(moved['svg_transformer'])}, tower and "
                f"adapter none")
    log("times", f"{card}: GRPO step at 1B, B={GRPO_B} x G={GRPO_G}, {GRPO_NEW} new tokens, the "
                 f"first step and the same step again: "
                 + "; ".join(f"{(o['rollout_s'] + o['reward_s'] + o['update_s']) * 1e3:.1f} ms = "
                             f"rollout {o['rollout_s'] * 1e3:.1f} + reward "
                             f"{o['reward_s'] * 1e3:.1f} + update {o['update_s'] * 1e3:.1f} ms"
                             for o in (out, warm))
                 + f"; peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
                 f"the {base / 2**30:.2f} GiB held before (fp32 masters, their copy for the "
                 f"check, the decoder's AdamW state)")

    # fp32: one update with the kernels against one with the plain attention
    roll = grpo_rollout(model.generate_im2svg_grpo({"image": images}, num_return_sequences=GRPO_G,
                                                   max_new_tokens=GRPO_NEW))
    adv = torch.linspace(-1.0, 1.0, GRPO_B * GRPO_G, device=dev)
    del trainer, model, p32, before
    torch.cuda.empty_cache()
    f32 = DTypePolicy(torch.float32, torch.float32)
    res = {}
    for kernels in (True, False):
        params = full_width_params(sv, cfg, dev, torch.float32, seed=5)
        for t in tree_leaves(params["svg_transformer"]):
            t.requires_grad_()
        opt = build_optimizer(params, lr=GRPO_LR, weight_decay=0.0, train_image_encoder=False,
                              train_connector=False)
        step = grpo.make_grpo_step(cfg, opt, num_generations=GRPO_G, policy=f32, remat="dots",
                                   kernels=kernels)
        start = [t.detach().clone() for t in tree_leaves(params)]
        reset_counts(tfa)
        _, _, m = step(params, opt.init(params), roll, adv)
        n = {k: read_counts(tfa)[k] for k in TRAIN_KERNELS}
        moved = [not torch.equal(a, b.detach()) for a, b in zip(start, tree_leaves(params))]
        res[kernels] = (float(m["loss"]), float(m["grad_norm"]), n,
                        [t.detach() for t in tree_leaves(params["svg_transformer"])])
        del params, opt, step, start
    (l_k, g_k, n_k, w_k), (l_p, g_p, n_p, w_p) = res[True], res[False]
    diff = max((a - b).abs().max().item() for a, b in zip(w_k, w_p))
    n_dec = len(w_k)  # the decoder's leaves come first in the tree
    if not all(moved[:n_dec]) or any(moved[n_dec:]):
        raise AssertionError(f"GRPO fp32 update: leaves moved {moved}")
    if n_k != {"flash_prefill_with_lse": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L} or \
            any(n_p.values()) or abs(l_k - l_p) > 1e-4 * abs(l_p) or \
            abs(g_k - g_p) > 1e-3 * abs(g_p) or diff > 3 * GRPO_LR or not g_k > 0:
        raise AssertionError(f"GRPO fp32 update: kernels {l_k}, {g_k}, {n_k}; plain {l_p}, "
                             f"{g_p}, {n_p}; weights max |diff| {diff}")
    log("grpo", f"fp32 update on one rollout, advantages -1..1, kernels vs plain attention: loss "
                f"{l_k:.7f} vs {l_p:.7f} (rtol 1e-4), grad_norm {g_k:.6e} vs {g_p:.6e} (rtol "
                f"1e-3), updated decoder weights max |diff| {diff:.3e} (bound 3 lr = "
                f"{3 * GRPO_LR:.0e}); every decoder leaf moved, no tower or adapter leaf; "
                f"launches {n_k} with the kernels, none with plain")
    del res, w_k, w_p
    torch.cuda.empty_cache()
    return dict(out=out, peak=peak, counts=counts)


# ---------------------------------------------------------------------------
# phases 4c and 6d: continuous-batching serving (serve/engine.py, worker.py,
# controller.py) at full width
# ---------------------------------------------------------------------------

SERVE_PROMPTS = (  # prompt ids after the visual tokens: 4 prefixes of different lengths
    PROMPT_IDS, PROMPT_IDS + (312, 88), PROMPT_IDS + tuple(range(400, 412)),
    PROMPT_IDS + tuple(range(500, 531)))
SERVE_NEW = 128      # new tokens a request in the timed runs (no stop: every request runs them)
SERVE_CHECK_NEW = 32  # new tokens a request in the id checks


def serve_requests(engine, reqs, timeout: float = 600) -> list[dict]:
    """Submit `reqs` at once, then start the engine if it has not started
    (requests queued before the start admit as one group); read each
    request's events on a thread of its own and return, per request, its
    ids, time to first token and latency (host clock from the submission).
    Raises unless every request ended in ("done", ids) within `timeout`
    seconds an event."""
    import threading

    results: list = [None] * len(reqs)
    t0 = time.perf_counter()

    def consume(i, r):
        first = None
        while True:
            kind, payload = r.out_queue.get(timeout=timeout)
            now = time.perf_counter()
            if kind == "token" and first is None:
                first = now
            if kind != "token":
                results[i] = dict(kind=kind, ids=payload, ttft=(first or now) - t0,
                                  latency=now - t0)
                return

    threads = [threading.Thread(target=consume, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    for r in reqs:
        engine.submit(r)
    engine.start()
    for th in threads:
        th.join(timeout + 5)
    bad = [(i, res) for i, res in enumerate(results) if res is None or res["kind"] != "done"]
    if bad:
        raise AssertionError(f"serving: requests that did not end done: "
                             f"{[(i, None if r is None else (r['kind'], str(r['ids'])[:300])) for i, r in bad]}")
    return results


def serve_prefixes(params, cfg, images, policy, prompts=SERVE_PROMPTS) -> list[torch.Tensor]:
    """The im2svg prefix (1, P, E) of each image with its prompt ids."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix

    dev = images.device
    return [im2svg_prefix(params, cfg, images[i:i + 1], torch.tensor([p], device=dev),
                          policy=policy)[0] for i, p in enumerate(prompts)]


def engine_ids(params, cfg, prefixes, policy, dev, tfa, *, kernels=True, kv=None,
               new=SERVE_CHECK_NEW, stops=STOP_IDS, slots: int = 8):
    """(greedy ids of each prefix, `new` tokens with the stops, through a
    fresh engine of `slots` slots at steps_per_tick 4; the launch counts;
    the engine's ticks): all requests queued before the start, so they
    admit as one group."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder, max_batch=slots,
                         max_len=1024, policy=policy, kv_cache_dtype=kv, steps_per_tick=4,
                         device=dev, kernels=kernels)
    try:
        reqs = [Request(prefix_embeds=p, max_new_tokens=new, do_sample=False,
                        stop_sequences=stops) for p in prefixes]
        reset_counts(tfa)
        res = serve_requests(engine, reqs)
        counts = read_counts(tfa)
        ticks = engine.stats()["ticks"]
    finally:
        engine.stop()
    return [r["ids"] for r in res], counts, ticks


def offline_ids(model_cls, params, cfg, images, policy, dev) -> list[list[int]]:
    """Offline greedy ids through generate_im2svg_ids at B = 1, a request
    an image with its SERVE_PROMPTS entry, cut at each one's length."""
    m = model_cls(params, cfg, policy=policy, device=dev)
    out = []
    for i, p in enumerate(SERVE_PROMPTS):
        _, toks, lengths = m.generate_im2svg_ids(
            {"image": images[i:i + 1]}, prompt_ids=[p], stop_sequences=STOP_IDS,
            max_new_tokens=SERVE_CHECK_NEW, use_nucleus_sampling=False)
        out.append(toks[0, :int(lengths[0])].tolist())
    return out


def serve_rates(card: str, label: str, runs: dict) -> dict:
    """Aggregate tokens/s, p50 time to first token and p50 latency of each
    serving run in `runs` {name: fn() -> per-request results, or (tokens,
    rows) of an offline call}, taken in turns a, b, ..., ..., b, a."""
    names = list(runs)
    rec = {n: [] for n in names}
    for n in names + names[::-1]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = runs[n]()
        torch.cuda.synchronize()
        rec[n].append((time.perf_counter() - t, res))
    out = {}
    for n in names:
        walls = [w for w, _ in rec[n]]
        res = rec[n][-1][1]
        if isinstance(res, tuple):  # offline: (tokens, rows)
            tokens = res[0]
            out[n] = dict(rate=tokens / statistics.median(walls), ttft=None, p50=None)
        else:
            tokens = sum(len(r["ids"]) for r in res)
            ttft = statistics.median(r["ttft"] for _, rs in rec[n] for r in rs)
            lat = statistics.median(r["latency"] for _, rs in rec[n] for r in rs)
            out[n] = dict(rate=tokens / statistics.median(walls), ttft=ttft, p50=lat)
        log("serve", f"{card}: {label} {n}: {out[n]['rate']:.1f} tokens/s ({tokens} tokens, "
                     f"walls {[round(w * 1e3, 1) for w in walls]} ms)"
                     + ("" if out[n]["ttft"] is None else
                        f", p50 time to first token {out[n]['ttft'] * 1e3:.1f} ms, p50 request "
                        f"latency {out[n]['p50'] * 1e3:.1f} ms"))
    return out


def throughput_runs(params, cfg, prefixes, policy, dev, *, kv=None, steps=(1, 4),
                    offline: bool = True) -> tuple[dict, list]:
    """{name: fn} of the timed runs: a warm engine a steps_per_tick value,
    all the prefixes submitted at once, greedy, SERVE_NEW tokens each
    without a stop; and offline generate at B = len(prefixes) over the same
    prefixes. Returns the runs and the engines (stop them after)."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    runs, engines = {}, []
    for spt in steps:
        engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder,
                             max_batch=max(8, len(prefixes)), max_len=2048, policy=policy,
                             kv_cache_dtype=kv, steps_per_tick=spt, device=dev)
        engines.append(engine)

        def run(engine=engine):
            return serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=SERVE_NEW,
                                                   do_sample=False) for p in prefixes])

        run()  # warm-up: the allocator's pools, cuBLAS handles
        runs[f"engine{' int8' if kv is not None else ''} steps_per_tick={spt}"] = run
    if offline:
        P = max(p.shape[1] for p in prefixes)
        emb = torch.cat([torch.nn.functional.pad(p, (0, 0, P - p.shape[1], 0)) for p in prefixes])
        mask = torch.stack([torch.arange(P, device=dev) >= P - p.shape[1] for p in prefixes]
                           ).to(torch.int32)
        gen = GenerationConfig(max_new_tokens=SERVE_NEW, min_new_tokens=SERVE_NEW,
                               do_sample=False, pad_token_id=0)

        def offline_run():
            toks, _ = generate(params["svg_transformer"], cfg.llm, emb, mask, gen, policy=policy,
                               kv_cache_dtype=kv)
            return (toks.numel(), len(prefixes))

        offline_run()
        runs[f"offline generate B={len(prefixes)}"] = offline_run
    return runs, engines


def png_b64(img: np.ndarray) -> str:
    """A uint8 RGB image as base64 PNG (the worker's im2svg payload)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def rest_phase(p16, cfg, dev, card: str) -> None:
    """The port's worker and controller on 127.0.0.1 (standard-library HTTP
    servers in threads): the worker registers, then 4 concurrent streamed
    im2svg requests (base64 PNG payloads: PIL is on the card's machine)
    through the controller's relay, greedy, sampled, a beam group and
    text2svg, every chunk error_code 0; and /v1/chat/completions."""
    import concurrent.futures
    import threading

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve import controller as ctl
    from starvector_tpu_torch.serve import worker as wk
    from starvector_tpu_torch.serve.httpd import post_json, post_json_reply

    model = StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v1"),
                                  policy=DTypePolicy(torch.bfloat16, torch.bfloat16), device=dev)
    worker = wk.ModelWorker(model, worker_addr="pending", max_batch=8, max_len=2048)
    servers = [wk.build_server(worker), ctl.build_server(ctl.Controller("shortest_queue"))]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for th in threads:
        th.start()
    wurl, curl = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)

    def stream(payload):
        t = time.perf_counter()
        with post_json(curl + "/worker_generate_stream", payload, 300) as resp:
            raw = resp.read()
        return [json.loads(c) for c in raw.split(b"\0") if c], time.perf_counter() - t

    try:
        worker.worker_addr, worker.controller_addr = wurl, curl
        worker.register()
        imgs = synthetic_images(3, 71)
        base = {"model": "starvector", "task": "im2svg", "max_new_tokens": SERVE_CHECK_NEW,
                "temperature": 0.0}
        payloads = [{**base, "image": png_b64(imgs[0])},
                    {**base, "image": png_b64(imgs[1]), "temperature": 0.8, "top_p": 0.9},
                    {**base, "image": png_b64(imgs[2]), "num_beams": 2},
                    {**base, "task": "text2svg", "prompt": "a red circle"}]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(stream, payloads, timeout=600))
        for (chunks, _), p in zip(outs, payloads):
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"REST: {p.get('task')} request failed: {chunks[-1:]}")
        chat = post_json_reply(wurl + "/v1/chat/completions", {
            "model": "starvector", "max_tokens": 8, "temperature": 0.0,
            "messages": [{"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": "data:image/png;base64," + png_b64(imgs[0])}}]}]}, 300)
        if chat.get("object") != "chat.completion" or not chat["choices"][0]["message"][
                "content"].startswith("<svg"):
            raise AssertionError(f"REST: /v1/chat/completions answered {str(chat)[:300]}")
        status = post_json_reply(wurl + "/worker_get_status", {}, 60)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for th in threads:
            th.join(60)
        worker.shutdown()
    log("serve", f"{card}: REST: the port's worker and controller on 127.0.0.1; 4 concurrent "
                 f"streamed requests through the controller (greedy, sampled, beam K=2 im2svg "
                 f"as base64 PNG; text2svg), {SERVE_CHECK_NEW} new tokens, bf16: chunks "
                 f"{[len(c) for c, _ in outs]}, every error_code 0, seconds "
                 f"{[round(s, 2) for _, s in outs]}; /v1/chat/completions answered; the "
                 f"engine emitted {status['engine']['tokens_emitted']} tokens in "
                 f"{status['engine']['ticks']} ticks")


def mixed_batch(params, cfg, prefixes, policy, dev, card: str) -> None:
    """bf16, one engine with speculative ticks (spec_drafts=4): greedy,
    sampled, a stop sequence, a logit_bias, a beam group (K=2) and a
    greedy request whose prompt ids seed the drafts, all at once; every
    request must end done."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder, max_batch=8,
                         max_len=1024, policy=policy, spec_drafts=4, device=dev)
    p0, p1, p2, p3 = prefixes
    ref = serve_requests(engine, [Request(prefix_embeds=p0, max_new_tokens=24,
                                           do_sample=False)])[0]["ids"]
    reqs = dict(
        greedy=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False),
        sampled=Request(prefix_embeds=p1, max_new_tokens=48, temperature=0.9, top_p=0.9),
        stop=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False,
                     stop_sequences=((ref[10], ref[11]),)),
        logit_bias=Request(prefix_embeds=p2, max_new_tokens=48, do_sample=False,
                           logit_bias={ref[3]: 5.0}),
        beam=Request(prefix_embeds=p3, max_new_tokens=24, do_sample=False, num_beams=2),
        speculative=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False,
                            prompt_token_ids=list(PROMPT_IDS) + ref))
    try:
        res = dict(zip(reqs, serve_requests(engine, list(reqs.values()))))
        stats = engine.stats()
    finally:
        engine.stop()
    if res["greedy"]["ids"][:24] != ref or res["speculative"]["ids"][:24] != ref:
        log("serve", f"{card}: bf16 mixed batch: a greedy stream parted from the lone request's "
                     f"(bf16 verify and decode steps differ in sum order; not a check)")
    log("serve", f"{card}: bf16 mixed batch under speculative ticks (spec_drafts=4): "
                 + ", ".join(f"{k} {len(v['ids'])} tokens" for k, v in res.items())
                 + f", every request done; {stats['ticks']} ticks, {stats['spec_ticks']} "
                 f"speculative, {stats['spec_extra_tokens']} tokens from accepted drafts")


def profile_tick(engine_run, prefill_run, ticks: int, wall: float, wall0: float, card: str,
                 out_dir: Path, label: str) -> None:
    """The device-busy share of a serving tick: torch.profiler over a
    serving run and over an admission-only run (1 new token: no tick); the
    difference over the ticks against the unprofiled walls' difference."""
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        return sum(e.self_device_time_total for e in rows) / 1e3, prof

    full, prof = device_ms(engine_run)
    admit, _ = device_ms(prefill_run)
    if not full:
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_serve_{label}.txt").write_text(
        f"{card}\n{label}\n" + prof.key_averages().table(sort_by="self_device_time_total",
                                                         row_limit=50))
    dev_tick, wall_tick = (full - admit) / ticks, (wall - wall0) * 1e3 / ticks
    log("profile", f"{card}: serving tick, {label}: wall {wall_tick:.3f} ms without the "
                   f"profiler, device {dev_tick:.3f} ms under it, busy {dev_tick / wall_tick:.1%} "
                   f"({ticks} ticks; table in {out_dir}/profile_serve_{label}.txt)")


def tick_times(card: str, label: str, params, cfg, prefixes, policy, dev) -> dict:
    """A serving tick (steps_per_tick 4, the prefixes submitted at once,
    SERVE_NEW greedy tokens each with no stop) of the graphed engine against
    the same static tick uncaptured (cuda_graphs=False), each on its own warm
    engine (the graphed one's graphs captured by the warm-up): the wall a
    tick is the host clock around a serving run less an admission-only run
    (1 new token: no tick), over the ticks, in turns (uncaptured, graphed,
    graphed, uncaptured); the device time a tick torch.profiler's kernel time over the
    same two runs; busy is device over wall."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engines, runs = {}, {}
    try:
        for graphed in (False, True):
            engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder,
                                 max_batch=max(8, len(prefixes)), max_len=2048, policy=policy,
                                 steps_per_tick=4, device=dev, cuda_graphs=graphed)
            engines[graphed] = engine

            def run(n, engine=engine):
                return serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=n,
                                                       do_sample=False) for p in prefixes])

            runs[graphed] = run
            run(SERVE_NEW)  # warm-up: the allocator, the graphs
            run(1)
        walls = {False: [], True: []}
        for graphed in (False, True, True, False):
            engine = engines[graphed]
            torch.cuda.synchronize()
            ticks0, t = engine.stats()["ticks"], time.perf_counter()
            runs[graphed](SERVE_NEW)
            torch.cuda.synchronize()
            full, ticks = time.perf_counter() - t, engine.stats()["ticks"] - ticks0
            t = time.perf_counter()
            runs[graphed](1)
            torch.cuda.synchronize()
            walls[graphed].append((full - (time.perf_counter() - t)) * 1e3 / ticks)
        out = {}
        for graphed, name in ((False, "uncaptured"), (True, "graphed")):
            ticks0 = engines[graphed].stats()["ticks"]
            full = profiled_device_ms(lambda: runs[graphed](SERVE_NEW))
            ticks = engines[graphed].stats()["ticks"] - ticks0
            device = (full - profiled_device_ms(lambda: runs[graphed](1))) / ticks
            wall = statistics.mean(walls[graphed])
            out[name] = dict(wall_ms=wall, device_ms=device if device > 0 else None,
                             busy=device / wall if device > 0 else None, ticks=ticks,
                             walls=walls[graphed])
        out["graphs"] = len(engines[True]._graphs)
    finally:
        for engine in engines.values():
            engine.stop()

    def fmt(r):
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        busy = "" if r["busy"] is None else f", busy {r['busy']:.1%}"
        return f"wall {r['wall_ms']:.3f} ms, device {dev}{busy}"

    log("serve", f"{card}: {label} serving tick, 4 steps at {len(prefixes)} slots, "
                 f"{SERVE_NEW} greedy tokens a request ({out['graphed']['ticks']} ticks a run): "
                 f"uncaptured (cuda_graphs=False) {fmt(out['uncaptured'])}; graphed "
                 f"{fmt(out['graphed'])} "
                 f"({out['graphs']} graphs captured); walls a tick in turns "
                 f"{[round(w, 3) for w in out['uncaptured']['walls']]} uncaptured, "
                 f"{[round(w, 3) for w in out['graphed']['walls']]} graphed")
    return out


def serving_1b(tfa, cfg, p16, p32, q16, dev, card: str, profile_dir: Path | None) -> dict:
    """Phase 4c, on phase 4's 1B weights: the continuous-batching engine's
    id checks with exact launch counts, a mixed bf16 batch, int8 serving,
    the REST worker and controller, and the serving numbers."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch(
        synthetic_images(4, 31))
    # fp32: 4 concurrent requests (prefixes of 260 to 291 tokens: one
    # admission of 4 rows in bucket 512, one chunk) against offline B = 1
    # and against the engine with the plain attention
    pre32 = serve_prefixes(p32, cfg, images, f32)
    ids_k, counts, ticks = engine_ids(p32, cfg, pre32, f32, dev, tfa)
    ids_p, counts_p, _ = engine_ids(p32, cfg, pre32, f32, dev, tfa, kernels=False)
    ref = offline_ids(StarVectorForCausalLM, p32, cfg, images, f32, dev)
    if ids_k != ref or ids_p != ids_k:
        raise AssertionError(f"1B fp32 engine ids: kernels {ids_k}\nplain {ids_p}\noffline {ref}")
    expect_counts("1B engine fp32", counts, flash_prefill=L, decode_attention=L * 4 * ticks)
    expect_counts("1B engine fp32, plain", counts_p)
    log("serve", f"{card}: 1B engine, fp32, 4 concurrent requests (prefixes "
                 f"{[p.shape[1] for p in pre32]} tokens, one admission), {SERVE_CHECK_NEW} new "
                 f"tokens greedy with the stop: ids == offline generate_im2svg_ids B=1 == the "
                 f"engine with the plain attention (lengths {[len(i) for i in ids_k]}); "
                 f"launches flash_prefill {counts['flash_prefill']} = {L} x 1 chunk, "
                 f"decode_attention {counts['decode_attention']} = {L} x 4 x {ticks} ticks")
    # int8 weights and an int8 cache: fp32 ids against offline int8
    # generate; bf16 launch counts (96 kernel-14 launches a step and a chunk)
    q32 = _cast_tree(q16, torch.float32)
    i8k, _, _ = engine_ids(q32, cfg, pre32, f32, dev, tfa, kv=torch.int8)
    i8ref = offline_int8_ids(q32, cfg, pre32, f32)
    if i8k != i8ref:
        raise AssertionError(f"1B int8 fp32 engine ids {i8k}\noffline {i8ref}")
    del q32
    pre16 = serve_prefixes(p16, cfg, images, bf16)
    _, c8, ticks8 = engine_ids(q16, cfg, pre16, bf16, dev, tfa, kv=torch.int8)
    steps8 = 4 * ticks8
    expect_counts("1B engine int8", c8, flash_prefill=L, decode_attention=L * steps8,
                  decode_attention_int8=L * steps8, quant_matmul=4 * L * (1 + steps8))
    log("serve", f"{card}: 1B engine, int8 weights and an int8 KV cache: fp32 ids == offline "
                 f"int8 generate's ({[len(i) for i in i8k]} tokens); bf16 launches "
                 f"quant_matmul {c8['quant_matmul']} = {4 * L} x (1 chunk + {steps8} steps; "
                 f"tensor-core GEMV {c8['quant_matmul_gemv_tc']}, GEMV pair "
                 f"{c8['quant_matmul_gemv']}, tile {c8['quant_matmul_wgmma']}), decode_attention "
                 f"{c8['decode_attention']} = {L} x {steps8}, all over the int8 cache")
    mixed_batch(p16, cfg, pre16, bf16, dev, card)
    rest_phase(p16, cfg, dev, card)
    # the numbers: 8 concurrent greedy requests of 128 new tokens
    imgs8 = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch(
        synthetic_images(8, 41))
    pre8 = serve_prefixes(p16, cfg, imgs8, bf16, prompts=(PROMPT_IDS,) * 8)
    ticks_1b = tick_times(card, "1B bf16", p16, cfg, pre8, bf16, dev)
    runs, engines = throughput_runs(p16, cfg, pre8, bf16, dev)
    runs8, engines8 = throughput_runs(q16, cfg, pre8, bf16, dev, kv=torch.int8, steps=(4,),
                                      offline=False)
    try:
        rates = serve_rates(card, "1B bf16, 8 concurrent greedy im2svg requests of 128 tokens",
                            runs)
        rates.update(serve_rates(card, "1B, 8 concurrent requests, int8 against bf16",
                                 {**runs8, "engine steps_per_tick=4": runs["engine steps_per_tick=4"]}))
        if profile_dir is not None:
            from starvector_tpu_torch.serve.engine import Request

            engine = engines[1]
            t = time.perf_counter()
            ticks0 = engine.stats()["ticks"]
            runs["engine steps_per_tick=4"]()
            torch.cuda.synchronize()
            wall, ticks = time.perf_counter() - t, engine.stats()["ticks"] - ticks0

            def admit_only():
                return serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=1,
                                                       do_sample=False) for p in pre8])

            t = time.perf_counter()
            admit_only()
            torch.cuda.synchronize()
            wall0 = time.perf_counter() - t
            profile_tick(runs["engine steps_per_tick=4"], admit_only, ticks, wall, wall0, card,
                         profile_dir, "1b_bf16_steps4")
    finally:
        for e in engines + engines8:
            e.stop()
    # the serving path's launches (the fp32 run for kernels 1 and 2, the
    # bf16 int8 run for 2' and 14), beside phase 4's in the kernels' JSON
    launches = dict(flash_prefill=counts["flash_prefill"],
                    decode_attention=counts["decode_attention"],
                    decode_attention_int8=c8["decode_attention_int8"],
                    quant_matmul_gemv_tc=c8["quant_matmul_gemv_tc"],
                    quant_matmul_gemv=c8["quant_matmul_gemv"],
                    quant_matmul_tile=c8["quant_matmul_wgmma"])
    return dict(rates=rates, launches=launches, ticks=ticks_1b)


# ---------------------------------------------------------------------------
# phase 4d: the eval harness (validation/, metrics/) at full 1B width
# ---------------------------------------------------------------------------

EVAL_SEED = 51
EVAL_NEW = 64  # greedy new tokens a sample
EVAL_TOL = (1e-4, 1e-5)  # (rtol, atol): LPIPS and pool3 features, fp32 on the card against the CPU


class EvalDataset:
    """Phase 4d's in-memory dataset (a validator's `dataset.target`): the
    probe SVGs of validation/parity_samples.py as ground truth, and as the
    model's input seeded synthetic images (not rasters of those SVGs, so
    the inputs differ whether or not librsvg/cairo is there), processed by
    the port's processor on the host, beside the same images as PIL."""

    def __init__(self, n: int, seed: int, image_size: int):
        from PIL import Image

        from starvector_tpu_torch.data.processor import processor_for_encoder
        from starvector_tpu_torch.validation.parity_samples import SAMPLES

        raw = synthetic_images(n, seed)
        processed = processor_for_encoder("clip", image_size, device="cpu").batch(raw).numpy()
        self.items = [{"svg": SAMPLES[i][1], "id": f"{SAMPLES[i][0]}.svg", "caption": "",
                       "image": processed[i], "image_pil": Image.fromarray(raw[i])}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class IdsSpy:
    """Within `with IdsSpy(model) as spy:`, spy.calls lists (tokens,
    lengths) of every im2svg generation the API ran for `model`."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        inner = self.model._im2svg

        def run(*a, **kw):
            out = inner(*a, **kw)
            self.calls.append((out[1].clone(), out[2].clone()))
            return out

        self.model._im2svg = run
        return self

    def __exit__(self, *exc):
        del self.model._im2svg


def eval_config(out_dir: str, n: int, image_size: int, metrics: dict, engine: str = "jax",
                **model) -> dict:
    return {"run": {"out_dir": out_dir},
            "model": {"task": "im2svg", "name": "starvector-1b", "generation_engine": engine,
                      "from_checkpoint": None, **model},
            "dataset": {"target": f"{__name__}.EvalDataset", "dataset_name": "phase-4d",
                        "batch_size": 2, "num_samples": n,
                        "params": {"n": n, "seed": EVAL_SEED, "image_size": image_size}},
            "generation_params": {"max_new_tokens": EVAL_NEW, "temperature": 0.0,
                                  "generation_sweep": False},
            "metrics": metrics}


def timed_validator(v) -> dict:
    """Wrap the validator's stages in host-clock timers (synchronised);
    returns the dict they add seconds to."""
    secs: dict = {}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    v.generate_svg = timed("generation", v.generate_svg)
    v.post_process_svg = timed("post-processing", v.post_process_svg)
    v.save_results = timed("saving and rasterizing", v.save_results)
    v.calculate_and_save_metrics = timed("metrics", v.calculate_and_save_metrics)
    for name, m in v.metrics.active_metrics.items():
        if hasattr(m, "calculate_score"):
            m.calculate_score = timed(f"metric {name}", m.calculate_score)
    return secs


def within(a: torch.Tensor, b: torch.Tensor, tol=EVAL_TOL) -> tuple[bool, float, float]:
    """(|a - b| <= atol + rtol |b| everywhere, max |a - b|, max |a - b| / |b|)."""
    d = (a - b).abs()
    return (bool((d <= tol[1] + tol[0] * b.abs()).all()), d.max().item(),
            (d / b.abs().clamp_min(1e-30)).max().item())


def neural_metrics_card_vs_cpu(dev, card: str, weights: Path) -> dict:
    """LPIPS-VGG16 at 224 and InceptionV3 pool3 at 299 on the full-size
    random weights in `weights`, fp32 with TF32 off, on the card and on the
    CPU: per-pair distances and features within EVAL_TOL, the FID from the
    card's features against the CPU's, and ms per pair / per 16 images."""
    from PIL import Image

    from starvector_tpu_torch.metrics import inception_v3, lpips_vgg
    from starvector_tpu_torch.metrics.model_metrics import frechet_distance

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 leaves them
    torch.backends.cudnn.allow_tf32 = False
    gt = [Image.fromarray(im) for im in synthetic_images(8, EVAL_SEED)]
    gen = [Image.fromarray(im) for im in synthetic_images(8, EVAL_SEED + 1)]
    vgg_sd, lin_sd = (torch.load(weights / "lpips-vgg" / f, weights_only=True)
                      for f in ("vgg16.pth", "lpips_vgg.pth"))
    inc_sd = torch.load(weights / "inception" / "inception_v3.pth", weights_only=True)
    nets = {
        "LPIPS": (lambda d: lpips_vgg.LPIPSVGG.from_torch_state_dicts(vgg_sd, lin_sd, device=d),
                  (lpips_vgg.preprocess(gt[:4]), lpips_vgg.preprocess(gen[:4])),
                  lpips_vgg.lpips_distance, 1),
        "Inception": (lambda d: inception_v3.InceptionV3.from_torch_state_dict(inc_sd, device=d),
                      (inception_v3.preprocess(gt + gen),), inception_v3.features, 16)}
    out = {}
    for name, (make, inputs, run, timed_rows) in nets.items():
        res = {}
        for d in (dev, "cpu"):
            net = make(d)
            args = tuple(x.to(d) for x in inputs)
            res["card" if d is dev else "cpu"] = run(net, *args).cpu()
            one = tuple(x[:timed_rows] for x in args)
            if d is dev:
                res["card_ms"] = event_ms(lambda: run(net, *one), iters=10)
            else:
                t = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    run(net, *one)
                    t.append(time.perf_counter() - t0)
                res["cpu_ms"] = min(t) * 1e3
            del net
        ok, err, rel = within(res["card"], res["cpu"])
        if not ok or not torch.isfinite(res["card"]).all():
            raise AssertionError(f"{name} on the card against the CPU: max |diff| {err:.3e}, "
                                 f"max relative {rel:.3e}, over rtol {EVAL_TOL[0]} atol "
                                 f"{EVAL_TOL[1]}")
        out[name] = dict(res, err=err, rel=rel)
    fid = {}
    for d in ("card", "cpu"):
        f = out["Inception"][d].double().numpy()
        a, b = f[:8], f[8:]
        fid[d] = frechet_distance(a.mean(0), np.cov(a, rowvar=False), b.mean(0),
                                  np.cov(b, rowvar=False))
    if not np.isfinite(fid["card"]) or abs(fid["card"] - fid["cpu"]) > 1e-3 * abs(fid["cpu"]):
        raise AssertionError(f"FID from the card's features {fid['card']!r}, from the CPU's "
                             f"{fid['cpu']!r}: over rtol 1e-3")
    lp, inc = out["LPIPS"], out["Inception"]
    log("eval", f"{card}: full-size random weights, fp32, TF32 off, the card against the CPU: "
                f"LPIPS-VGG16 at 224, 4 pairs {[round(x, 6) for x in lp['card'].tolist()]}, max "
                f"|diff| {lp['err']:.3e} (relative {lp['rel']:.3e}); InceptionV3 pool3 at 299, "
                f"16 images x 2048 (max |feature| {inc['cpu'].abs().max().item():.3f}), max "
                f"|diff| {inc['err']:.3e} (relative {inc['rel']:.3e}); tolerance rtol "
                f"{EVAL_TOL[0]} atol {EVAL_TOL[1]}; FID (8 against 8) from the card's features "
                f"{fid['card']:.6f}, from the CPU's {fid['cpu']:.6f} (rtol 1e-3)")
    log("times", f"{card}: LPIPS-VGG16 a pair at 224: card {lp['card_ms']:.3f} ms (CUDA events, "
                 f"10 calls), CPU {lp['cpu_ms']:.1f} ms; InceptionV3 16 images at 299: card "
                 f"{inc['card_ms']:.3f} ms, CPU {inc['cpu_ms']:.1f} ms (host clock, best of 2)")
    return dict(lpips_ms=lp["card_ms"], lpips_cpu_ms=lp["cpu_ms"], inception_ms=inc["card_ms"],
                inception_cpu_ms=inc["cpu_ms"], fid=fid)


def eval_1b(tfa, cfg, p16, p32, dev, card: str) -> dict:
    """Phase 4d, on phase 4's 1B weights: the in-process validator over
    EvalDataset (8 samples, B = 2, EVAL_NEW greedy tokens, the
    configs/metrics/im2svg.yaml set with LPIPS and FID on full-size random
    weights in a temporary STARVECTOR_METRICS_DIR): bf16 texts and ids equal
    offline generate_im2svg's on the same batches, exact launch counts,
    every file of the output tree, every configured key; on the fp32 copy,
    ids and texts with the kernels equal those with the plain attention;
    the neural metrics on the card against the CPU; the REST validator
    through the port's worker and controller serving the fp32 copy, each
    text equal to offline fp32 generate_im2svg at B = 1; times beside the
    card's name and power limit."""
    import os
    import tempfile
    import threading

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.config import ConfigNode, load_yaml
    from starvector_tpu_torch.data.rasterize import rasterizer_available
    from starvector_tpu_torch.metrics import inception_v3, lpips_vgg
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve import controller as ctl
    from starvector_tpu_torch.serve import worker as wk
    from starvector_tpu_torch.validation.serve_validator import StarVectorServeValidator
    from starvector_tpu_torch.validation.torch_validator import StarVectorTorchValidator

    L, n, size = cfg.llm.n_layer, 8, cfg.image_size
    raster = rasterizer_available()
    log("eval", f"rasterizer_available() {raster}"
        + ("" if raster else ": no librsvg/cairo here, so every raster is the reference's white "
           "fallback and L2, Masked-L2, SSIM and LPIPS read white against white: their values "
           "below are no measure of quality"))
    tok = build_test_tokenizer("v1")
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    metrics = {**load_yaml("configs/metrics/im2svg.yaml")["metrics"], "LPIPS": True, "FID": True}
    light = {"L2": False}  # the ratio metrics only: the fp32 and REST runs check texts
    tmp = Path(tempfile.mkdtemp(prefix="phase4d_"))
    weights = tmp / "weights"
    (weights / "lpips-vgg").mkdir(parents=True)
    (weights / "inception").mkdir()
    vgg_sd, lin_sd = lpips_vgg.random_state_dicts(EVAL_SEED)
    torch.save(vgg_sd, weights / "lpips-vgg" / "vgg16.pth")
    torch.save(lin_sd, weights / "lpips-vgg" / "lpips_vgg.pth")
    torch.save(inception_v3.random_state_dict(EVAL_SEED), weights / "inception" / "inception_v3.pth")
    del vgg_sd, lin_sd
    saved_env = os.environ.get("STARVECTOR_METRICS_DIR")
    os.environ["STARVECTOR_METRICS_DIR"] = str(weights)
    try:
        # bf16: the validator against offline generate_im2svg on the same batches
        model = StarVectorForCausalLM(p16, cfg, tok, policy=bf16, device=dev)
        v = StarVectorTorchValidator(ConfigNode(eval_config(str(tmp / "bf16"), n, size, metrics)),
                                     model=model)
        secs = timed_validator(v)
        reset_counts(tfa)
        t = time.perf_counter()
        with IdsSpy(model) as spy:
            avg, per = v.validate()
        wall = time.perf_counter() - t
        counts = read_counts(tfa)
        steps = [decode_steps(tokens, lengths) for tokens, lengths in spy.calls]
        expect_counts("eval bf16", counts, flash_prefill=L * len(spy.calls),
                      decode_attention=L * sum(steps))
        if len(spy.calls) != n // 2:
            raise AssertionError(f"eval: {len(spy.calls)} generations, expected {n // 2}")
        items = EvalDataset(n, EVAL_SEED, size)
        sids = [it["id"].split(".")[0] for it in items.items]
        texts = []
        with IdsSpy(model) as ref:
            for b in range(0, n, 2):
                images = np.stack([items[i]["image"] for i in (b, b + 1)])
                texts += model.generate_im2svg({"image": torch.as_tensor(images, device=dev)},
                                               max_new_tokens=EVAL_NEW, use_nucleus_sampling=False)
        same_ids = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(spy.calls, ref.calls)]
        raws = [v.results[s]["svg_raw"] for s in sids]
        if raws != texts or len(ref.calls) != len(spy.calls) or not all(same_ids):
            raise AssertionError(f"eval bf16: validator texts {raws}\noffline {texts}\nids equal "
                                 f"per batch {same_ids}")
        missing = [f"{s}/{s}{x}" for s in sids for x in (".svg", "_raw.svg", "_gt.svg",
                                                         "_generated.png", "_original.png")
                   if not os.path.exists(os.path.join(v.out_dir, s, s + x))]
        missing += [f"{s}/metadata.json" for s in sids
                    if not os.path.exists(os.path.join(v.out_dir, s, "metadata.json"))]
        missing += [f for f in ("results/results_avg.json", "results/all_results.csv",
                                "metrics.jsonl", "config.yaml")
                    if not os.path.exists(os.path.join(v.out_dir, f))]
        on_disk = json.load(open(os.path.join(v.out_dir, "results", "results_avg.json")))
        want = {k for k, on in metrics.items() if on}
        if missing or set(on_disk) != want or len(per) != n:
            raise AssertionError(f"eval output tree: missing {missing}; results_avg.json keys "
                                 f"{sorted(on_disk)}, configured {sorted(want)}; {len(per)} rows")
        distinct = [len(set(row[:int(l)].tolist())) for tk, ln in spy.calls for row, l in zip(tk, ln)]
        log("eval", f"in-process validator, bf16, {n} samples at B=2, {EVAL_NEW} greedy tokens: "
                    f"texts and ids == offline generate_im2svg on the same batches (lengths "
                    f"{[ln.tolist() for _, ln in spy.calls]}, distinct ids per row {distinct}); "
                    f"launches flash_prefill {counts['flash_prefill']} = {L} x {len(spy.calls)} "
                    f"batches, decode_attention {counts['decode_attention']} = {L} x {sum(steps)} "
                    f"steps; the output tree complete; results_avg.json "
                    + ", ".join(f"{k} {avg[k]:.6g}" for k in sorted(avg)))
        log("times", f"{card}: validator, bf16, {n} samples, {EVAL_NEW} greedy tokens at B=2: "
                     f"{wall / n:.3f} s a sample ({wall:.2f} s); a sample's seconds by stage: "
                     + ", ".join(f"{k} {s / n:.4f}" for k, s in secs.items()))
        eval_launches = {"flash_prefill": counts["flash_prefill"],
                         "decode_attention": counts["decode_attention"]}
        del model, v

        # fp32: the kernels against the plain attention, ids and texts
        runs = {}
        for kernels in (True, False):
            m32 = StarVectorForCausalLM(p32, cfg, tok, policy=f32, device=dev, kernels=kernels)
            v32 = StarVectorTorchValidator(ConfigNode(eval_config(
                str(tmp / f"fp32_{kernels}"), n, size, light)), model=m32)
            with IdsSpy(m32) as spy32:
                v32.validate()
            runs[kernels] = ([v32.results[s]["svg_raw"] for s in sids], spy32.calls)
        (tk, ik), (tp, ip) = runs[True], runs[False]
        if tk != tp or not all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                               for a, b in zip(ik, ip)):
            raise AssertionError(f"eval fp32: texts with the kernels {tk}\nplain {tp}")
        log("eval", f"in-process validator, fp32: texts and ids with the kernels == with the "
                    f"plain attention ({n} samples, lengths {[ln.tolist() for _, ln in ik]})")

        neural = neural_metrics_card_vs_cpu(dev, card, weights)

        # the REST validator through the port's worker and controller (fp32)
        m32 = StarVectorForCausalLM(p32, cfg, tok, policy=f32, device=dev)
        worker = wk.ModelWorker(m32, worker_addr="pending", max_batch=8, max_len=1024)
        servers = [wk.build_server(worker), ctl.build_server(ctl.Controller("shortest_queue"))]
        threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
        for th in threads:
            th.start()
        wurl, curl = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        try:
            worker.worker_addr, worker.controller_addr = wurl, curl
            worker.register()
            rv = StarVectorServeValidator(ConfigNode(eval_config(
                str(tmp / "rest"), n, size, light, engine="vllm", api_endpoint=curl,
                name=worker.model_names[0])))
            t = time.perf_counter()
            rv.validate()
            rest_wall = time.perf_counter() - t
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()
            for th in threads:
                th.join(60)
            worker.shutdown()
        rest = [rv.results[s]["svg_raw"] for s in sids]
        offline = [m32.generate_im2svg({"image": m32.process_images([it["image_pil"]])},
                                       max_new_tokens=EVAL_NEW, use_nucleus_sampling=False)[0]
                   for it in items.items]
        if rest != offline:
            raise AssertionError(f"eval REST fp32 texts {rest}\noffline B=1 {offline}")
        log("eval", f"REST validator through the port's worker and controller on 127.0.0.1 "
                    f"(fp32): {n} requests done, every text == offline fp32 generate_im2svg at "
                    f"B=1 on the same PIL image")
        log("times", f"{card}: REST validator, fp32, {n} samples one request at a time, "
                     f"{EVAL_NEW} greedy tokens: {rest_wall / n:.3f} s a sample")
        del m32
    finally:
        if saved_env is None:
            os.environ.pop("STARVECTOR_METRICS_DIR", None)
        else:
            os.environ["STARVECTOR_METRICS_DIR"] = saved_env
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=eval_launches, seconds=wall / n, stages={k: s / n for k, s in secs.items()},
                rest_seconds=rest_wall / n, neural=neural)


# ---------------------------------------------------------------------------
# phase 4e: offline pipelined generation (generate_pipelined, and with
# speculative rounds generate_pipelined_spec) at full 1B width
# ---------------------------------------------------------------------------

PIPE_BATCHES, PIPE_B, PIPE_P, PIPE_NEW = 4, 16, 1024, 128  # the JAX bench's offline 1k-prefill shape
SPEC_BATCHES, SPEC_B, SPEC_NEW, SPEC_DRAFT = 3, 8, 64, 8
SPEC_LENGTHS = (256, 243, 230, 217, 204, 191, 178, 165)  # right-padded rows of a spec batch
SPEC_IDS = (44, 5727, 2262, 1053, 48, 307, 912, 3001, 77, 1409, 2718, 8081)  # drafts recur


def pipe_batches(E: int, dev, n: int, B: int, P: int, seed: int = 15) -> list:
    """n batches of (embeds (B, P, E) fp32, mask (B, P) of ones): random
    prompt embeddings 0.02 N(0, 1) from a seeded generator on the card, as
    the JAX bench's offline workload builds them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((B, P, E), generator=g, device=dev) * 0.02,
             torch.ones((B, P), dtype=torch.int32, device=dev)) for _ in range(n)]


def cast_batches(batches: list, dtype) -> list:
    return [(e.to(dtype),) + tuple(rest) for e, *rest in batches]


def pipelined_steps(outs: list, n_chunks: int, n: int) -> dict:
    """Steps of a static generate_pipelined run by kind, from each batch's
    lengths (generation/engine.py::_decode_overlap): every batch but the
    last runs n_chunks fused steps (a decode and a chunk, whatever its
    rows' state, as the JAX loop); then, while a row is live, decode-only
    steps up to token n - 2, to the end of the block of DECODE_GRAPH_STEPS
    in which the last row stopped (the host reads `done` once a block)."""
    from starvector_tpu_torch.generation.engine import DECODE_GRAPH_STEPS

    counts = dict(decode=0, fused=0, decode_only=0)
    for i, (_, lengths) in enumerate(outs):
        t0 = n_chunks if i + 1 < len(outs) else 0
        last, end = int(lengths.max()) - 1, t0  # the step that samples the last row's stop
        while last >= t0 and end < n - 1:
            end = min(end + DECODE_GRAPH_STEPS, n - 1)
            if end > last:
                break
        counts["fused"] += t0
        counts["decode_only"] += end - t0
        counts["decode"] += end
    return counts


def loop_times(card: str, label: str, run, steps_of, unit: str = "step", tfa=None) -> dict:
    """One loop's line: run(graphed) -> result, steps_of(result) -> the
    steps (or rounds) it ran. The wall a step is the host clock around a
    whole synchronised call over its steps (the call's prefill included),
    uncaptured (cuda_graphs=False) then graphed, the graphed one also
    without its captures' host seconds; the device time a step is
    torch.profiler's kernel time over one more graphed call (the same
    kernels either way); busy is device over wall. Returns {"uncaptured":
    ..., "graphed": ...} of wall_ms, device_ms, busy, each call's captures
    and result, and with `tfa` its launches (read_counts)."""
    from starvector_tpu_torch.generation import graphs

    out = {}
    for name, graphed in (("uncaptured", False), ("graphed", True)):
        if tfa is None:
            graphs.reset_tally()
        else:
            reset_counts(tfa)
        res, wall = timed(lambda: run(graphed))
        n = steps_of(res)
        t = graphs.tally()
        out[name] = dict(wall_ms=wall * 1e3 / n, steps=n, captures=t["captures"],
                         replay_wall_ms=(wall - t["capture_s"]) * 1e3 / n, result=res,
                         counts=None if tfa is None else read_counts(tfa))
    device = profiled_device_ms(lambda: run(True)) / out["graphed"]["steps"]
    for r in out.values():
        r["device_ms"] = device if device > 0 else None
        r["busy"] = device / r["wall_ms"] if device > 0 else None

    def fmt(r):
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        busy = "" if r["busy"] is None else f", busy {r['busy']:.1%}"
        return f"wall {r['wall_ms']:.3f} ms, device {dev}{busy}"

    g = out["graphed"]
    log("steps", f"{card}: {label}, {g['steps']} {unit}s: uncaptured (cuda_graphs=False) "
                 f"{fmt(out['uncaptured'])}; graphed {fmt(g)} ({g['replay_wall_ms']:.3f} ms a "
                 f"{unit} without the call's {g['captures']} captures)")
    return out


def timed(fn):
    """(fn(), wall seconds of it, synchronised)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def same_ids(what: str, outs: list, refs: list) -> None:
    """Raise unless each batch's (tokens, lengths) equal the reference's."""
    for i, ((t, l), (rt, rl)) in enumerate(zip(outs, refs)):
        if not (torch.equal(t, rt) and torch.equal(l, rl)):
            raise AssertionError(f"{what}, batch {i}: first parting per row "
                                 f"{[first_parting(a, b) for a, b in zip(t, rt)]}, lengths "
                                 f"{l.tolist()} vs {rl.tolist()}")


def same_run(what: str, out, ref) -> None:
    """Raise unless two runs' results (tensors, ints, and lists or tuples of
    them) are equal, tensors bit for bit."""
    if isinstance(out, torch.Tensor):
        same = torch.equal(out, ref)
    elif isinstance(out, (list, tuple)):
        same = len(out) == len(ref)
        for i, (a, b) in enumerate(zip(out, ref)):
            same_run(f"{what} [{i}]", a, b)
    else:
        same = out == ref
    if not same:
        raise AssertionError(f"{what}: {out!r} != {ref!r}")


def fused_step_logits(cfg, dec: dict, batches: list, policy, kernels: bool, kv,
                      tokens: torch.Tensor) -> torch.Tensor:
    """generate_pipelined's first steps teacher-forced: batch 0 prefilled,
    then one fused decode+chunk step a column of tokens (B, n) while batch
    1's first n chunks are written. Returns the decode logits (B, n, V)."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), (e1, m1) = batches[:2]
    B, Pn, _ = e0.shape
    C = engine._chunk_plan(Pn, PIPE_NEW, None)[0]
    _, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, kernels, kv)
    nxt = gpt_bigcode.init_cache(cfg.llm, B, Pn + PIPE_NEW, dtype=kv or policy.compute_dtype,
                                 device=e0.device)
    out = []
    for t in range(tokens.shape[1]):
        x = gpt_bigcode.embed_tokens(dec, tokens[:, t:t + 1]).to(policy.compute_dtype)
        logits, cache, _, nxt = gpt_bigcode.forward_decode_with_chunk(
            dec, cfg.llm, x, cache, policy.cast(e1[:, t * C:(t + 1) * C]),
            m1[:, t * C:(t + 1) * C], nxt, policy=policy, kernels=kernels, chunk_logits=False)
        out.append(logits)
    return torch.stack(out, 1)


def chunk_written_decode(cfg, dec: dict, batches: list, policy, kv) -> tuple:
    """Batch 1's decode over the cache that generate_pipelined's fused steps
    wrote: batch 0 prefilled, then its n_chunks fused steps
    (forward_decode_with_chunk: the static fused step at the caches' host
    indices, the kernels on), each fed batch 0's greedy token, writing batch
    1's chunks; then batch 1's first decode step over that cache, once with
    the kernels (kernel 2, or 2' over an int8 cache) and once with the plain
    attention, each on its own copy of the cache. Both read the same codes
    and scales and the step's own k/v enter unquantized (the merged self
    token), so the logits differ by fp32 sum order alone: held to TOL, not
    to a quantization gap. Returns (max |diff|, a line for the log, batch
    0's greedy tokens (B, n_chunks))."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), (e1, m1) = batches[:2]
    B, Pn, _ = e0.shape
    C, n_chunks = engine._chunk_plan(Pn, PIPE_NEW, None)
    logits, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, True, kv)
    nxt = gpt_bigcode.init_cache(cfg.llm, B, Pn + PIPE_NEW, dtype=kv or policy.compute_dtype,
                                 device=e0.device)
    tokens = []
    for t in range(n_chunks):
        tokens.append(logits.argmax(-1))
        x = gpt_bigcode.embed_tokens(dec, tokens[-1][:, None]).to(policy.compute_dtype)
        logits, cache, last, nxt = gpt_bigcode.forward_decode_with_chunk(
            dec, cfg.llm, x, cache, policy.cast(e1[:, t * C:(t + 1) * C]),
            m1[:, t * C:(t + 1) * C], nxt, policy=policy, kernels=True,
            chunk_logits=t == n_chunks - 1)
    x = gpt_bigcode.embed_tokens(dec, last.argmax(-1)[:, None]).to(policy.compute_dtype)
    ones = torch.ones((B, 1), dtype=torch.int32, device=e0.device)
    logits = {k: gpt_bigcode.forward(dec, cfg.llm, x, attention_mask=ones,
                                     cache={n: v.clone() if torch.is_tensor(v) else v
                                            for n, v in nxt.items()},
                                     policy=policy, kernels=k)[0][:, -1] for k in (True, False)}
    torch.cuda.synchronize()
    err = compare(f"batch 1's decode over the chunk-written {kv or 'fp32'} cache", logits[True],
                  logits[False], torch.float32)
    return err, (f"batch 1's first decode step over the cache the {n_chunks} fused steps wrote "
                 f"(B={B}, T={Pn + PIPE_NEW}), kernels against plain: logits max |diff| "
                 f"{err:.3e} (TOL, fp32)"), torch.stack(tokens, 1)


def spec_batches(dec: dict, embed, dev, seed: int = 25) -> list:
    """SPEC_BATCHES batches of SPEC_B right-padded rows of SPEC_LENGTHS ids
    drawn from SPEC_IDS (so that prompt-lookup drafts exist): (embeds fp32,
    mask, prompt ids -1 at the holes)."""
    rng = np.random.default_rng(seed)
    P = max(SPEC_LENGTHS)
    out = []
    for _ in range(SPEC_BATCHES):
        ids = torch.from_numpy(rng.choice(SPEC_IDS, (SPEC_B, P))).to(dev)
        mask = (torch.arange(P, device=dev)[None, :]
                < torch.tensor(SPEC_LENGTHS, device=dev)[:, None]).int()
        out.append((embed(dec, ids).float() * mask[:, :, None], mask,
                    torch.where(mask > 0, ids, -1)))
    return out


def left_padded(batch) -> tuple:
    """A right-padded (embeds, mask, ids) batch's rows moved to the right,
    pads on the left (generate's and generate_pipelined's layout)."""
    emb, mask, ids = batch
    P = mask.shape[1]
    shift = P - mask.sum(dim=1)
    src = (torch.arange(P, device=mask.device)[None, :] - shift[:, None]) % P
    return (emb.gather(1, src[:, :, None].expand_as(emb)), mask.gather(1, src),
            ids.gather(1, src))


def pipelined_1b(tfa, cfg, p16, p32, q16, dev, card: str, profile_dir: Path | None) -> dict:
    """Phase 4e, offline pipelined generation at full 1B width on phase 4's
    trees cut to their first DEPTH_1B_EARLIER layers (L; since PR 21, for
    the script's time): PIPE_BATCHES batches of B=16, P=1024 random prompt
    embeddings, 128 greedy new tokens, C = max(4, ceil(1024 / 128)) = 8, so
    128 chunks: every step of a batch but the last is the static fused step
    (forward_decode_with_chunk_static: kernel 2 for the decode half with
    its key bounds on the device, the chunk step for the next prompt's
    chunk), the last batch's are static decode steps, each kind and key
    bucket one CUDA graph captured once a stream; batch 0 prefills
    through kernel 1.
      * fp32: each batch's ids and lengths graphed equal the uncaptured
        stream's (cuda_graphs=False) bit for bit, with the same launches;
        equal the plain attention's and the first two batches' per-batch
        generate's; launches exactly L flash_prefill (batch 0) and L
        decode_attention a decode step (pipelined_steps);
      * bf16: the launches, the graphs a stream of 4 batches captures (no
        more than one of 2: the loop line's), each batch's first token that
        parts from per-batch generate (recorded: the fused GEMMs round M =
        144 rows); the stream's line, uncaptured against graphed, over 2
        batches (loop_times);
      * int8 weights over an fp32 cache: fp32 ids equal per-batch
        generate's. An int8 KV cache (fp32 weights), and int8 weights with
        it: per-batch int8 generate is no exact reference there (its one
        prefill attends over every prompt key quantized, a chunk step over
        its own chunk's keys unquantized, in both packages), so 16
        teacher-forced fused steps' logits, kernels against plain, within
        twice what generate's route shows on the same tokens (both share
        batch 0's int8 prefill, where the two's k/v round to neighbouring
        codes), and batch 1's first decode step over the cache the fused
        steps wrote, kernels against plain on one copy each of that cache,
        to TOL (chunk_written_decode). In bf16 the launches over kernel 2'
        and kernel 14 (4 L a forward: the tile at M = 16 x 1024 for the
        prefill and 144 a fused step, the GEMV at M = 16 a decode-only
        step), graphed;
      * generate_pipelined_spec (pipelined_spec_1b);
      * tokens/s of serial per-batch generate, the stream and the stream
        over an int8 KV cache (bf16, one run each, graphed); with --timings
        or `profile_dir` a fused step against the unfused pair in
        alternating blocks (pipelined_step_times), and with `profile_dir` a
        fused step's and a decode-only step's wall against device time.
    Returns the launch counts of the checked bf16 runs, the stream's
    tokens/s, the captures, the spec results and the step times."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    gen = engine.GenerationConfig(max_new_tokens=PIPE_NEW, do_sample=False,
                                  stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    C, n_chunks = engine._chunk_plan(PIPE_P, PIPE_NEW, None)
    batches32 = pipe_batches(cfg.llm.hidden_size, dev, PIPE_BATCHES, PIPE_B, PIPE_P)
    batches16 = cast_batches(batches32, torch.bfloat16)
    d32, d16, dq16 = (t["svg_transformer"] for t in (p32, p16, q16))

    def pipelined(dec, batches, policy, kernels=True, kv=None, graphed=True):
        return engine.generate_pipelined(dec, cfg.llm, batches, gen, policy=policy,
                                         kernels=kernels, kv_cache_dtype=kv,
                                         cuda_graphs=graphed)

    def serial(dec, batches, policy, kv=None):
        return [engine.generate(dec, cfg.llm, e, m, gen, policy=policy, kv_cache_dtype=kv)
                for e, m in batches]

    def counted(fn):
        reset_counts(tfa)
        out = fn()
        return out, read_counts(tfa)

    # fp32: graphed against uncaptured, per-batch generate and the plain attention
    out32, counts = counted(lambda: pipelined(d32, batches32, f32))
    tally32 = graph_tally()
    steps = pipelined_steps(out32, n_chunks, PIPE_NEW)
    expect_counts("pipelined fp32", counts, flash_prefill=L, decode_attention=L * steps["decode"])
    unc32, unc_counts = counted(lambda: pipelined(d32, batches32, f32, graphed=False))
    same_ids("pipelined fp32, graphed against uncaptured", out32, unc32)
    if unc_counts != counts:
        raise AssertionError(f"pipelined fp32: launches graphed {counts} != uncaptured "
                             f"{unc_counts}")
    # per-batch generate for the first two batches only: each batch is
    # generated alone, so the third and fourth would repeat the same check
    # (the script's time budget)
    same_ids("pipelined fp32 against per-batch generate", out32[:2],
             serial(d32, batches32[:2], f32))
    same_ids("pipelined fp32, kernels against plain", out32,
             pipelined(d32, batches32, f32, kernels=False))
    log("pipelined", f"generate_pipelined, fp32, {PIPE_BATCHES} batches of B={PIPE_B}, P={PIPE_P}, "
                     f"{PIPE_NEW} new tokens, C={C} ({n_chunks} chunks a prompt): lengths per "
                     f"batch {[sorted(set(l.tolist())) for _, l in out32]}; {steps['fused']} fused "
                     f"steps, {steps['decode_only']} decode-only, as CUDA graphs ({tally32}); "
                     f"launches flash_prefill {counts['flash_prefill']} = {L} x 1 (batch 0), "
                     f"decode_attention {counts['decode_attention']} = {L} x {steps['decode']} "
                     f"decode steps, == the uncaptured stream's; ids and lengths == the "
                     f"uncaptured stream's (cuda_graphs=False) bit for bit, == the plain "
                     f"attention's, every batch, and == per-batch generate's, batches 0 and 1")

    # int8 weights over an fp32 cache: fp32 ids against per-batch generate
    q32 = quantized(p32)["svg_transformer"]
    two = batches32[:2]
    same_ids("pipelined fp32 int8 weights against per-batch generate",
             pipelined(q32, two, f32), serial(q32, two, f32))
    log("pipelined", "generate_pipelined, int8 weights and an fp32 cache, fp32, 2 batches: ids "
                     "and lengths == per-batch generate's")
    # an int8 KV cache, fp32: batch 1's first decode step over the cache the
    # fused steps wrote, kernels against plain on one cache, to TOL; then,
    # fed batch 0's tokens, teacher-forced fused steps, kernels against
    # plain, within twice generate's route's own gap on the same tokens (the
    # floor: both routes share batch 0's int8 prefill, where the two's k/v
    # round to neighbouring codes)
    int8_fp32 = {}
    for label, dec32 in (("int8 KV", d32), ("int8 weights + int8 KV", q32)):
        _, step_text, fed = chunk_written_decode(cfg, dec32, two, f32, torch.int8)
        fed = fed[:, :16]
        forced = [fused_step_logits(cfg, dec32, two, f32, k, torch.int8, fed)
                  for k in (True, False)]
        floor = [forced_logits(gpt_bigcode, dec32, cfg.llm, *two[0], 17, f32, k, torch.int8,
                               ids=fed)[0][:, 1:] for k in (True, False)]
        err = (forced[0] - forced[1]).abs().max().item()
        err_floor = (floor[0] - floor[1]).abs().max().item()
        if not torch.isfinite(forced[0]).all() or err > 2.0 * err_floor + 1e-3:
            raise AssertionError(f"pipelined fp32 {label}: teacher-forced fused-step logits, "
                                 f"kernels against plain, max |diff| {err:.4e}, over twice "
                                 f"generate's route's {err_floor:.4e}")
        int8_fp32[label] = (f"fp32, 2 batches: 16 teacher-forced fused steps' logits, kernels "
                            f"against plain, max |diff| {err:.4e}, generate's route on the same "
                            f"tokens {err_floor:.4e} (bound: fused <= 2 x generate's + 1e-3); "
                            f"{step_text}")
    del q32

    # pipelined speculative decoding
    spec = pipelined_spec_1b(tfa, cfg, d16, d32, bf16, f32, dev, card)

    # bf16, one run each, graphed, one after the other beside the card; each
    # run also gives its launches, captures and ids
    runs = {"serial generate": lambda: serial(d16, batches16, bf16),
            "generate_pipelined": lambda: pipelined(d16, batches16, bf16),
            "generate_pipelined int8 KV": lambda: pipelined(d16, batches16, bf16, kv=torch.int8)}
    med, first, captures, tallies = {}, {}, {}, {}
    for label, run in runs.items():
        reset_counts(tfa)
        out, wall = timed(run)
        first[label] = (out, read_counts(tfa))
        captures[label], tallies[label] = graphs_captured(), graph_tally()
        med[label] = sum(float(l.sum()) for _, l in out) / wall
    log("times", f"{card}: 1B offline, {PIPE_BATCHES} batches of B={PIPE_B}, P={PIPE_P}, "
                 f"{PIPE_NEW} greedy tokens, bf16, the steps as CUDA graphs, one run each (a, b, "
                 f"c), emitted tokens / wall: "
                 + "; ".join(f"{k} {v:.1f} tokens/s" for k, v in med.items())
                 + f"; pipelined / serial {med['generate_pipelined'] / med['serial generate']:.3f}"
                 f", int8 KV / serial "
                 f"{med['generate_pipelined int8 KV'] / med['serial generate']:.3f}")

    def bf16_launches(label, out, counts) -> tuple[dict, str]:
        """Exact launches of a bf16 run of the stream ("bf16", "int8 KV",
        "int8 weights + int8 KV"): kernel 1 for batch 0, kernel 2 (2' over
        the int8 cache) a decode step, kernel 14 (by rows: the GEMV up to
        GEMV_MAX_ROWS, else the tile) 4 L a forward."""
        steps = pipelined_steps(out, n_chunks, PIPE_NEW)
        int8, quant = label != "bf16", label.startswith("int8 weights")
        fwd = 1 + steps["fused"] + steps["decode_only"]
        got = expect_counts(f"pipelined bf16 {label}", counts, flash_prefill=L,
                            decode_attention=L * steps["decode"],
                            decode_attention_int8=L * steps["decode"] if int8 else 0,
                            quant_matmul=4 * L * fwd if quant else 0)
        rows = {"decode_only": PIPE_B, "fused": PIPE_B * (1 + C)}
        by_path = gemv_counts(tq, [(K, N) for _, K, N in QMM_SHAPES],
                              [(m, L * steps[k]) for k, m in rows.items()
                               if m <= tq.GEMV_MAX_ROWS])
        gemv = sum(by_path.values())
        tile = 4 * L * fwd - gemv
        if quant and {**{k: counts[k] for k in by_path}, "tile": counts["quant_matmul_wgmma"]} \
                != {**by_path, "tile": tile}:
            raise AssertionError(f"pipelined {label}: quant_matmul paths {counts}, expected GEMV "
                                 f"{by_path}, tile {tile}")
        text = (f"bf16 launches flash_prefill {got['flash_prefill']} = {L} x 1 (batch 0), "
                f"decode_attention {got['decode_attention']} = {L} x {steps['decode']} decode "
                f"steps ({steps['fused']} fused, {steps['decode_only']} decode-only)"
                + (f", of them over the int8 cache {got['decode_attention_int8']}" if int8 else "")
                + (f", quant_matmul {got['quant_matmul']} = {4 * L} x {fwd} forwards (tile {tile}: "
                   f"the prefill at M = {PIPE_B * PIPE_P}, the fused steps at M = "
                   f"{PIPE_B * (1 + C)}; GEMV {gemv}: the decode-only steps at M = {PIPE_B}, "
                   f"tensor-core {by_path['quant_matmul_gemv_tc']}, pair "
                   f"{by_path['quant_matmul_gemv']})" if quant else ""))
        return {**got, **({**by_path, "quant_matmul_wgmma": tile}
                          if quant else {})}, text

    out16 = first["generate_pipelined"][0]
    launches = {"spec": spec["launches"]}
    launches["bf16"], text = bf16_launches("bf16", *first["generate_pipelined"])
    ref16 = first["serial generate"][0]
    parts = [[first_parting(t, r) for t, r in zip(o[0], ref[0])] for o, ref in zip(out16, ref16)]
    agree = [round(float((o[0] == ref[0]).float().mean()), 4) for o, ref in zip(out16, ref16)]
    # the stream's line over its first 2 batches; their captures against the 4 batches'
    line = loop_times(card, f"1B generate_pipelined, bf16, 2 batches of B={PIPE_B}, "
                            f"P={PIPE_P}, {PIPE_NEW} tokens, {L} layers",
                      lambda g: pipelined(d16, batches16[:2], bf16, graphed=g),
                      lambda out: sum(pipelined_steps(out, n_chunks, PIPE_NEW)[k]
                                      for k in ("fused", "decode_only")))
    n2, n4 = line["graphed"]["captures"], captures["generate_pipelined"]
    if n4 != n2:
        raise AssertionError(f"pipelined bf16: a stream of {PIPE_BATCHES} batches captured {n4} "
                             f"graphs, one of 2 {n2}")
    log("pipelined", f"generate_pipelined, bf16: {text}; {tallies['generate_pipelined']} for "
                     f"{PIPE_BATCHES} batches, {n2} captured for 2; against per-batch generate, "
                     f"ids agree on {agree} of each batch's positions; first parting token per "
                     f"row (None: never; the fused GEMMs round M = {PIPE_B * (1 + C)} rows where "
                     f"a decode step rounds {PIPE_B}, and the chunk step's attention is not "
                     f"kernel 1's): {parts}")
    launches["int8 KV"], text = bf16_launches("int8 KV", *first["generate_pipelined int8 KV"])
    log("pipelined", f"generate_pipelined, int8 KV: {int8_fp32['int8 KV']}; {text}; "
                     f"{tallies['generate_pipelined int8 KV']}")
    label = "int8 weights + int8 KV"
    launches[label], text = bf16_launches(label, *counted(
        lambda: pipelined(dq16, batches16, bf16, kv=torch.int8)))
    log("pipelined", f"generate_pipelined, {label}: {int8_fp32[label]}; {text}; {graph_tally()}")
    step_ms = None
    if TIMINGS or profile_dir is not None:
        t_times = time.perf_counter()
        step_ms = pipelined_step_times(cfg, d16, bf16, batches16, C, card, profile_dir)
        timed_only("4e's fused-step timing", t_times)
    return dict(launches=launches, rates=med, spec=spec, step_ms=step_ms,
                line={k: {n: v for n, v in r.items() if n != "result"}
                      for k, r in line.items()}, captures=(n4, n2))


def pipelined_spec_1b(tfa, cfg, d16, d32, bf16, f32, dev, card: str) -> dict:
    """generate_pipelined_spec on phase 4e's trees (see pipelined_1b): 3
    batches of 8 right-padded prompts of 165-256 ids from a set of 12, 64
    new tokens, draft_len 8, every round static and replayed as a CUDA
    graph. fp32: ids, lengths and rounds a batch graphed == uncaptured bit
    for bit, ids == generate_pipelined's on the rows left-padded and ==
    per-batch generate's. bf16: rounds a batch, tokens a round, launches
    (kernel 1 for batch 0's adopt only: every verify is the chunk step),
    the graphs the 3-batch stream captures against a 2-batch one's, and the
    stream's line over 2 batches (loop_times)."""
    from starvector_tpu_torch.generation import engine, speculative
    from starvector_tpu_torch.models import gpt_bigcode

    L = cfg.llm.n_layer
    gen = engine.GenerationConfig(max_new_tokens=SPEC_NEW, do_sample=False,
                                  stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    batches32 = spec_batches(d32, gpt_bigcode.embed_tokens, dev)
    batches16 = cast_batches(batches32, torch.bfloat16)

    def spec(dec, batches, policy, graphed=True):
        stats = []
        out = speculative.generate_pipelined_spec(dec, cfg.llm, batches, gen, policy=policy,
                                                  draft_len=SPEC_DRAFT, stats=stats,
                                                  cuda_graphs=graphed)
        return out, stats

    out, stats32 = spec(d32, batches32, f32)
    same_run("pipelined_spec fp32 (ids, lengths, rounds), graphed against uncaptured",
             (out, stats32), spec(d32, batches32, f32, graphed=False))
    left = [left_padded(b) for b in batches32]
    pipe = engine.generate_pipelined(d32, cfg.llm, [b[:2] for b in left], gen, policy=f32)
    plain = [engine.generate(d32, cfg.llm, e, m, gen, policy=f32) for e, m, _ in left]
    same_ids("pipelined_spec fp32 against generate_pipelined", out, pipe)
    same_ids("pipelined_spec fp32 against per-batch generate", out, plain)
    log("pipelined", f"generate_pipelined_spec, fp32, {SPEC_BATCHES} batches of {SPEC_B} "
                     f"right-padded rows of {min(SPEC_LENGTHS)}-{max(SPEC_LENGTHS)} ids from a set "
                     f"of {len(SPEC_IDS)}, {SPEC_NEW} new tokens, draft_len {SPEC_DRAFT}: rounds a "
                     f"batch {stats32}; ids, lengths and rounds graphed == uncaptured "
                     f"(cuda_graphs=False) bit for bit; ids and lengths == generate_pipelined's "
                     f"on the rows left-padded and == per-batch generate's, every batch")
    reset_counts(tfa)
    out16, stats = spec(d16, batches16, bf16)
    got = expect_counts("pipelined_spec bf16", read_counts(tfa), flash_prefill=L)
    n3 = graphs_captured()
    line = loop_times(card, f"1B generate_pipelined_spec, bf16, 2 batches of {SPEC_B}, "
                            f"draft_len {SPEC_DRAFT}, {SPEC_NEW} tokens, {L} layers",
                      lambda g: spec(d16, batches16[:2], bf16, graphed=g),
                      lambda r: sum(r[1]), "round")
    n2 = line["graphed"]["captures"]
    if n3 != n2:
        raise AssertionError(f"pipelined_spec bf16: a stream of {SPEC_BATCHES} batches captured "
                             f"{n3} graphs, one of 2 {n2}")
    emitted = [int(l.sum()) for _, l in out16]
    per_round = [round(e / (r * SPEC_B), 3) for e, r in zip(emitted, stats)]
    log("pipelined", f"generate_pipelined_spec, bf16: rounds a batch {stats} (verify and "
                     f"chunk-only), emitted tokens {emitted}, {per_round} tokens a row a round; "
                     f"graphs captured {n3} for {SPEC_BATCHES} batches, {n2} for 2; launches "
                     f"flash_prefill {got['flash_prefill']} = {L} x 1 (batch 0's adopt), "
                     f"decode_attention {got['decode_attention']}: every verify is the chunk step; "
                     f"random weights, so the acceptance is no forecast for real SVG")
    return dict(launches=got, rounds=stats, per_round=per_round, captures=(n3, n2),
                line={k: {n: v for n, v in r.items() if n != "result"}
                      for k, r in line.items()})


def pipelined_step_times(cfg, dec, policy, batches, C: int, card: str, out_dir: Path | None,
                         pairs: int = 10, n: int = 8) -> dict:
    """A fused decode+chunk step against the unfused pair that
    generate_pipelined runs where a decoder has no fused forward (the
    decode forward, then the chunk step), at phase 4e's bf16 shapes: batch
    0 prefilled, batch 1's chunks written from slot 0, each block of n
    steps from that same state; `pairs` pairs of blocks in alternating
    order after one warm-up block of each. Logs the wall ms a step of each
    (synchronised host clock), the ratio of the medians, the quartiles and
    how many pairs the fused step won. With `out_dir`, then a fused step's
    and a decode-only step's wall against device time (torch.profiler over
    n more). Returns the median ms a step by kind."""
    from torch.profiler import ProfilerActivity, profile

    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), (e1, m1) = batches[:2]
    B, Pn, _ = e0.shape
    _, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, True, None)
    nxt = gpt_bigcode.init_cache(cfg.llm, B, Pn + PIPE_NEW, dtype=policy.compute_dtype,
                                 device=e0.device)
    tok = gpt_bigcode.embed_tokens(dec, torch.full((B, 1), 44, device=e0.device)).to(
        policy.compute_dtype)
    ones = torch.ones((B, 1), dtype=torch.int32, device=e0.device)
    i0 = cache["index"]
    step = {"t": 0}

    def reset():
        cache["index"], nxt["index"], step["t"] = i0, 0, 0
        cache["kv_mask"][:, i0:] = 0
        nxt["kv_mask"].zero_()

    def chunk():
        t = step["t"]
        step["t"] += 1
        return e1[:, t * C:(t + 1) * C], m1[:, t * C:(t + 1) * C]

    def fused():
        ce, cm = chunk()
        gpt_bigcode.forward_decode_with_chunk(dec, cfg.llm, tok, cache, ce, cm, nxt,
                                              policy=policy, chunk_logits=False)

    def decode():
        gpt_bigcode.forward(dec, cfg.llm, tok, attention_mask=ones, cache=cache, policy=policy)

    def unfused():
        ce, cm = chunk()
        decode()
        gpt_bigcode.forward(dec, cfg.llm, ce, attention_mask=cm, cache=nxt, policy=policy,
                            return_hidden=True, last_logits_only=True)

    def block(fn) -> float:
        """ms a step over n steps of fn from the reset state."""
        reset()
        _, wall = timed(lambda: [fn() for _ in range(n)])
        return wall * 1e3 / n

    kinds = {"fused": fused, "unfused": unfused}
    for fn in kinds.values():
        block(fn)  # warm-up
    ms = {k: [] for k in kinds}
    for i in range(pairs):
        for k in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
            ms[k].append(block(kinds[k]))
    med = {k: statistics.median(v) for k, v in ms.items()}
    wins = sum(f < u for f, u in zip(ms["fused"], ms["unfused"]))
    quart = {k: [round(q, 3) for q in statistics.quantiles(v, n=4)] for k, v in ms.items()}
    log("times", f"{card}: 1B pipelined step, bf16, B={B}, C={C}, {pairs} pairs of {n}-step "
                 f"blocks in alternating order: fused decode+chunk {med['fused']:.3f} ms a step "
                 f"(quartiles {quart['fused']}), unfused (the decode forward, then the chunk "
                 f"step) {med['unfused']:.3f} ms (quartiles {quart['unfused']}); unfused ms / "
                 f"fused ms {med['unfused'] / med['fused']:.3f}; the fused step faster in {wins} of "
                 f"{pairs} pairs")
    if out_dir is None:
        return med
    parts = []
    for label, fn in (("fused decode+chunk", fused), ("decode-only", decode)):
        wall = block(fn)
        reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
        if not dev_ms:
            raise AssertionError("the profiler recorded no device time")
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"profile_pipelined_{label.split()[0].replace('-', '_')}.txt"
        (out_dir / name).write_text(f"{card}\n{label}, B={B}, C={C}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=50))
        parts.append(f"{label} wall {wall:.3f} ms, device {dev_ms:.3f} ms, busy "
                     f"{dev_ms / wall:.1%} ({name})")
    log("profile", f"{card}: 1B pipelined step, bf16, B={B}, C={C} (M = {B * (1 + C)} rows a "
                   f"fused projection): " + "; ".join(parts))
    return med


def offline_int8_ids(q32, cfg, prefixes, f32) -> list[list[int]]:
    """Offline greedy ids of each prefix at B = 1 through generate with an
    int8 KV cache, cut at the stop."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate

    gen = GenerationConfig(max_new_tokens=SERVE_CHECK_NEW, do_sample=False,
                           stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    out = []
    for p in prefixes:
        toks, lengths = generate(q32["svg_transformer"], cfg.llm, p,
                                 torch.ones(p.shape[:2], dtype=torch.int32, device=p.device),
                                 gen, policy=f32, kv_cache_dtype=torch.int8)
        out.append(toks[0, :int(lengths[0])].tolist())
    return out


def serving_8b(tfa, model, cfg, p16, p32, cfg32, dev, card: str, depth: str) -> dict:
    """Phase 6d, on phase 6's 8B weights (`depth`): 4 concurrent bf16
    requests with a decode_attention (G = 9) launch a layer a step; fp32
    engine ids against offline generate's on phase 6's fp32 copy; at 2
    layers in fp32, a 4700-token prefix beside a short one decoded past the
    4096-key window, kernels against plain; tokens/s beside offline B = 4."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    L = cfg.llm.num_hidden_layers
    f32 = DTypePolicy(torch.float32, torch.float32)
    images = model.process_images(synthetic_images(4, 33))
    pre16 = serve_prefixes(p16, cfg, images, model.policy)
    _, counts, ticks = engine_ids(p16, cfg, pre16, model.policy, dev, tfa)
    expect_counts("8B engine bf16", counts, flash_prefill=L, decode_attention=L * 4 * ticks)
    pre32 = serve_prefixes(p32, cfg32, images, f32)
    ids_k, _, _ = engine_ids(p32, cfg32, pre32, f32, dev, tfa)
    ref = offline_ids(StarVectorForCausalLM, p32, cfg32, images, f32, dev)
    if ids_k != ref:
        raise AssertionError(f"8B fp32 engine ids {ids_k}\noffline {ref}")
    log("serve", f"{card}: 8B engine, bf16 at {depth}, 4 concurrent requests (prefixes "
                 f"{[p.shape[1] for p in pre16]}): launches flash_prefill {counts['flash_prefill']}"
                 f" = {L} x 1 chunk, decode_attention (G = 9) {counts['decode_attention']} = {L} x "
                 f"4 x {ticks} ticks; fp32 at {depth}: ids == offline generate_im2svg_ids B=1 "
                 f"(lengths {[len(i) for i in ids_k]})")
    # the window: 2 layers, fp32, a 4700-token prefix beside a 579-token one
    q2, cfg2 = first_layers(p16, cfg, 2)
    p2 = _cast_tree(q2, torch.float32)
    n_visual = cfg.encoder_config.geometry[1]
    long_ids = tuple(np.random.default_rng(16).integers(0, cfg.llm.vocab_size,
                                                        PREFIX_8B - n_visual).tolist())
    pre = serve_prefixes(p2, cfg2, images[:2], f32, prompts=(long_ids, PROMPT_IDS))
    ids = {}
    for kernels in (True, False):
        engine = ServeEngine(p2["svg_transformer"], cfg2.llm, cfg2.decoder, max_batch=2,
                             max_len=8192, policy=f32, device=dev, kernels=kernels)
        try:
            reset_counts(tfa)
            res = serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=SERVE_CHECK_NEW,
                                                  do_sample=False) for p in pre])
            wc = read_counts(tfa)
        finally:
            engine.stop()
        ids[kernels] = [r["ids"] for r in res]
        if kernels:
            win_counts = wc
    if ids[True] != ids[False]:
        raise AssertionError(f"8B engine window: fp32 ids kernels {ids[True]}\nplain {ids[False]}")
    from starvector_tpu_torch.serve.engine import _bucket_len

    chunks = [max(min(_bucket_len(p.shape[1]), 8192) // 1024, 1) for p in pre]
    if win_counts["flash_prefill"] != 2 * sum(chunks) or not win_counts["decode_attention"]:
        raise AssertionError(f"8B engine window launches {win_counts}: expected 2 x {chunks} "
                             f"admission chunks of flash_prefill")
    log("serve", f"{card}: 8B engine, the window at full width, fp32, 2 layers: a {PREFIX_8B}-token "
                 f"prefix ({chunks[0]} admission chunks of 1024 through kernel 1, the later "
                 f"ones at q_offset > 0) beside a {pre[1].shape[1]}-token one, {SERVE_CHECK_NEW} tokens "
                 f"each, the long row past the {cfg.llm.sliding_window}-key window in its mask: "
                 f"ids with the kernels == plain; launches flash_prefill "
                 f"{win_counts['flash_prefill']}, decode_attention {win_counts['decode_attention']}")
    del p2, q2
    torch.cuda.empty_cache()
    runs, engines = throughput_runs(p16, cfg, pre16, model.policy, dev, steps=(4,))
    try:
        rates = serve_rates(card, "8B bf16, 4 concurrent greedy im2svg requests of 128 tokens",
                            runs)
    finally:
        for e in engines:
            e.stop()
    return rates


# ---------------------------------------------------------------------------
# phase 6e: StarVector-8B and -1B served over tensor, fsdp, sequence and
# stage meshes (parallel/tensor.py::ServingGroup)
# ---------------------------------------------------------------------------

TP8_LEAF = "configs/generation/serve/starvector-8b/im2svg-tp8-int8kv.yaml"
TP_SPEC_NEW = 16  # the use_speculative request of 1b-tp2dp4, on data group 0's leader
# each run: name, model, its serve leaf (a path in the repo, or a `serve:`
# block that the phase writes to a temporary file, which the rank reads as
# worker.main reads --serve-config), compute dtype, int8 weights (None;
# "whole": each rank's slices of quantize_tree of the whole bf16 tree;
# "rank": each rank quantizes its own bf16 slices with the group's column
# maxima, as worker.main's --quantize loads them; "shards": each rank
# quantizes its own fsdp shards, parallel/sharding.py::quantize_shards),
# greedy new tokens a request, requests, and options: "depth" (the decoder
# cut to its first layers: every forward gathers every layer over gloo's
# host TCP), "bitwise" (tensor 1: each
# data group's first-step or teacher-forced logits and greedy ids bit for
# bit one process's with the group's slots and requests), "spec" (one
# use_speculative request of that many new tokens on data group 0); the
# sharded runs take 5 new tokens, one engine tick of 4 steps
TP_CONFIGS = (
    ("tp4dp2", "8b", "configs/generation/serve/starvector-8b/im2svg-tp4dp2.yaml",
     torch.float32, None, 64, 4, {}),
    ("tp8-int8kv", "8b", TP8_LEAF, torch.bfloat16, None, 8, 4, {}),
    ("1b-tp2dp4", "1b", {"mesh": {"data": 4, "tensor": 2}, "max_batch": 8, "max_len": 1024,
                         "kv_cache_dtype": "bfloat16"}, torch.float32, None, 16, 4,
     {"spec": TP_SPEC_NEW}),
    ("1b-tp8-int8", "1b", {"mesh": {"tensor": 8}, "max_batch": 16, "max_len": 1024,
                           "kv_cache_dtype": "int8"}, torch.bfloat16, "whole", 8, 2, {}),
    ("tp8-int8kv-q", "8b", TP8_LEAF, torch.bfloat16, "rank", 8, 2, {}),
    ("1b-fsdp4dp2", "1b", {"mesh": {"data": 2, "fsdp": 4}, "max_batch": 8, "max_len": 1024,
                           "kv_cache_dtype": "bfloat16"}, torch.bfloat16, None, 5, 4,
     {"bitwise": True}),
    ("1b-stage2-seq2-tp2", "1b", {"mesh": {"stage": 2, "sequence": 2, "tensor": 2},
                                  "max_batch": 4, "max_len": 1024,
                                  "kv_cache_dtype": "bfloat16"}, torch.float32, None, 5, 4,
     {"spec": 8}),
    ("8b-fsdp8-int8", "8b", {"mesh": {"fsdp": 8}, "max_batch": 4, "max_len": 1024,
                             "kv_cache_dtype": "int8"}, torch.bfloat16, "shards", 5, 2,
     {"depth": 2, "bitwise": True}),
)
TP_WORLD = 8     # every run's ranks, each a process on the one card
# teacher-forced positions of the int8-cache checks (a decode step's 16
# all-reduces over gloo among 8 processes on one card took 0.3-0.9 s)
TP_FORCED = 8
TP_TIMEOUT = 900  # seconds the ranks may take before the phase fails
TP_PROJECTIONS = {"1b": 4, "8b": 6}  # kernel-14 launches a layer a forward of an int8 decoder


def _group_tensor(group, t: torch.Tensor | None, dtype, dev) -> torch.Tensor:
    """The tensor group leader's `t` on every rank of its group."""
    shape = group.broadcast_object(None if t is None else tuple(t.shape))
    return group.broadcast(t if t is not None else torch.empty(shape, dtype=dtype, device=dev))


def _tp_tree(run) -> str:
    """The key of a run's whole tree among the shared trees."""
    _, model, _, dtype, quant = run[:5]
    return f"{model}_" + ("int8" if quant == "whole" else
                          "fp32" if dtype == torch.float32 else "bf16")


def _serve_ctx(group):
    """The serving group's layout active on this thread (its shards
    gathered at use) for a forward outside the engine, where it has one."""
    return group.layout.serve() if group.layout is not None else contextlib.nullcontext()


def _codes_match(st: dict, ref: dict) -> int:
    """The count of a rank's int8 leaves (codes and scales) that equal its
    shards of the whole tree's quantize_tree `ref` bit for bit; raises at
    the first that does not."""
    from starvector_tpu_torch.parallel import zero
    from starvector_tpu_torch.parallel.sharding import _paths

    want, mine, n = dict(_paths(ref)), dict(_paths(st)), 0
    for codes in (p for p in mine if p.endswith("/kernel_q")):
        for path in (codes, codes[:-len("kernel_q")] + "scale"):
            info = zero.info_of(mine[path])
            expect = want[path] if info is None else info.local_of(want[path])
            if not torch.equal(mine[path], expect):
                raise AssertionError(f"6e: {path} on this rank is not its shard of "
                                     f"quantize_tree's")
            n += 1
    return n


def launches_of(counts: dict, heads: list, int8_kv: bool, quant) -> str:
    """The launches line of a phase 6e run on its first rank."""
    qmm = (f", quant_matmul {counts['quant_matmul']} (tensor-core GEMV "
           f"{counts['quant_matmul_gemv_tc']}, GEMV pair {counts['quant_matmul_gemv']}, "
           f"tile {counts['quant_matmul_wgmma']})" if quant else "")
    return (f"every rank launched flash_prefill {counts['flash_prefill']} (H={heads[0][0]}"
            f"{'/' + str(heads[-1][0]) if len(heads) > 1 else ''} Hkv={heads[0][1]}), "
            f"{'int8-cache ' if int8_kv else ''}decode_attention {counts['decode_attention']} "
            f"(G={'/'.join(str(h[0] // h[1]) for h in heads)}){qmm}")


def _heads(llm) -> tuple[int, int]:
    return getattr(llm, "num_attention_heads", None) or llm.n_head, llm.kv_heads


def _tp_config(tfa, run, kw: dict, whole: dict, cfg, images, forced_ids, int8_ref, dev) -> dict:
    """One rank's run of one serve config, through the functions
    serve/worker.py's main calls (tensor.serving_group, the rank's shards
    by starvector.serving_params: its tensor slices and, on a layout, its
    stage block and fsdp shards of them; with "rank" quantization those
    slices quantized by tensor.quantize_slices, with "shards" the rank's
    shards by sharding.quantize_shards, as from_pretrained(quantize=True,
    group=) does; worker.make_engine): the check's forward on every rank
    of the group (the first step's logits, or teacher-forced logits over
    the int8 cache), then the group's engine, the leader serving its data
    group's share of the run's greedy requests (request i on data group i
    % data), the followers replaying; with "spec", data group 0's leader
    then sends one use_speculative request through the engine
    (ServeEngine.generate_speculative, the worker's route). Returns the
    heads, the rank's resident decoder bytes, the launch counts of the
    engine run, with "shards" the count of its int8 leaves that equal its
    shards of `int8_ref` (quantize_tree of the whole tree), and on the
    leader its logits, ids, ticks and wall time."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.parallel.sharding import quantize_shards
    from starvector_tpu_torch.parallel.tensor import quantize_slices, serving_group
    from starvector_tpu_torch.serve.engine import Request
    from starvector_tpu_torch.serve.worker import make_engine, prefix_params

    name, _, _, dtype, quant, new, n_req, opts = run
    policy = DTypePolicy(dtype, dtype)
    axes, kv = kw["mesh_axes"], kw["kv_cache_dtype"]
    data = axes.get("data", 1)
    if opts.get("depth"):
        whole, cfg = first_layers(whole, cfg, opts["depth"])
    group = serving_group(axes)
    params, rcfg = sv.serving_params(whole, cfg, group)
    dec = cfg.decoder_module
    tg = group.tensor
    out = dict(heads=_heads(rcfg.llm), group_rank=group.rank, tensor_rank=tg.rank,
               data_rank=group.data_rank)
    if quant == "rank":
        params["svg_transformer"] = quantize_slices(
            params["svg_transformer"], dec.partition_rules(),
            [dec.tensor_units(cfg.llm, tg.size, r) for r in range(tg.size)], tg)
    elif quant == "shards":
        params["svg_transformer"] = quantize_shards(params["svg_transformer"])
        out["codes"] = _codes_match(params["svg_transformer"], int8_ref["svg_transformer"])
    out["bytes"] = tree_bytes(params["svg_transformer"])
    model = StarVectorForCausalLM(params, rcfg, policy=policy, device=dev)
    st, n = params["svg_transformer"], 2
    emb = None
    if group.is_leader:
        emb = im2svg_prefix(prefix_params(model.params), model.cfg, images[:n],
                            torch.tensor([PROMPT_IDS] * n, device=dev), policy=policy)[0]
    emb = _group_tensor(group, emb, policy.compute_dtype, dev)
    mask = torch.ones(emb.shape[:2], dtype=torch.int32, device=dev)
    with _serve_ctx(group):
        if kv is None:  # the first step's logits: the admission prefill's last position
            cache = dec.init_cache(rcfg.llm, n, emb.shape[1], dtype=policy.compute_dtype,
                                   device=dev)
            check = dec.forward(st, rcfg.llm, emb, mask, cache=cache, policy=policy,
                                last_logits_only=True)[0][:, -1]
        else:
            check = forced_logits(dec, st, rcfg.llm, emb, mask, TP_FORCED, policy, True, kv,
                                  forced_ids)[0]
    if group.is_leader:
        out["check"] = check.float().cpu()
    del emb, check
    engine = make_engine(model, group=group, max_batch=kw["max_batch"] // data, max_len=1024,
                         kv_cache_dtype=kv)
    torch.cuda.synchronize()
    reset_counts(tfa)
    t = time.perf_counter()
    if group.is_leader:
        mine = [i for i in range(n_req) if i % data == group.data_rank]
        pre = serve_prefixes(prefix_params(model.params), model.cfg, images[mine], policy,
                             prompts=[SERVE_PROMPTS[i] for i in mine])
        res = serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=new,
                                              do_sample=False) for p in pre])
        if opts.get("spec") and group.data_rank == 0:
            prompt = torch.tensor([SERVE_PROMPTS[0]], device=dev)
            tokens, length, n_fwd = engine.generate_speculative(
                pre[0], spec_ids(pre[0].shape[1], prompt), max_new_tokens=opts["spec"],
                draft_len=8, stop_sequences=(), pad_token_id=0)
            out["spec"] = (tokens[0, :int(length[0])].tolist(), n_fwd)
        stats = engine.stats()
        engine.stop()
        out.update(ids={i: r["ids"] for i, r in zip(mine, res)}, ticks=stats["ticks"],
                   prefill_chunks=stats["prefill_chunks"])
    else:
        engine.follow()
        out["checked"] = engine.checked_steps
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t, counts=read_counts(tfa))
    return out


def _tp_rank(rank: int, port: int, weights, kws: dict, cfgs: dict, results) -> None:
    """A rank of phase 6e, a process of its own on the one card: joins a
    gloo group of TP_WORLD ranks (NCCL refuses two ranks on one card),
    then runs each of TP_CONFIGS over it (_tp_config) on the weights the
    main process shares through the queue `weights` (CUDA IPC: the unsplit
    leaves are its tensors, each rank copies its slices; every reference
    is dropped before the rank reports, so that the main process can free
    them). Puts (rank, results) or (rank, the error) on `results`."""
    import traceback

    import torch.distributed as dist

    try:
        shared = weights.get(timeout=TP_TIMEOUT)
        dev = shared["images"]["8b"].device  # the card the main process shares its weights on
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=TP_WORLD)
        from starvector_tpu_torch.ops import flash_attention as tfa
        from starvector_tpu_torch.ops import kernel_lib

        kernel_lib.library()
        torch.backends.cuda.matmul.allow_tf32 = False
        out = {}
        for run in TP_CONFIGS:
            name, model = run[:2]
            out[name] = _tp_config(tfa, run, kws[name], shared["trees"][_tp_tree(run)],
                                   cfgs[model], shared["images"][model],
                                   shared["forced_ids"].get(name),
                                   shared["trees"].get(f"{name}_int8"), dev)
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        del shared
        gc.collect()
        results.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the main process reports it and stops the others
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def _tp_serve_kwargs(leaf, work: Path) -> dict:
    """serve_kwargs_from_leaf of a run's leaf: a path in the repo, or a
    `serve:` block written to a yaml file in `work` first."""
    from starvector_tpu_torch.config import load_yaml
    from starvector_tpu_torch.serve.worker import serve_kwargs_from_leaf

    if isinstance(leaf, dict):
        path = work / f"serve-{len(list(work.iterdir()))}.yaml"
        path.write_text(json.dumps({"serve": leaf}))  # JSON is YAML
    else:
        path = Path(__file__).parent / leaf
    return serve_kwargs_from_leaf(load_yaml(str(path)))


def _tp_references(tfa, models: dict, kws: dict, dev) -> dict:
    """One process's references of each run, on the run's whole tree (cut
    to its depth; quantized whole for "shards", kept in `models` for the
    ranks' code checks): the greedy ids of its requests through one engine
    (with "bitwise", each data group's through an engine of the group's
    slots); the first step's logits of 2 prefixes, or teacher-forced logits
    over the int8 cache with the kernels and with their plain versions and
    the ids they feed; with "spec" generate_greedy_speculative's ids and
    forward count on request 0's prefix; the decoder's bytes."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.generation.speculative import generate_greedy_speculative
    from starvector_tpu_torch.ops.layers import DTypePolicy

    refs = {}
    for run in TP_CONFIGS:
        name, model, _, dtype, quant, new, n_req, opts = run
        m, params = models[model], models[model]["trees"][_tp_tree(run)]
        cfg, images, kv = m["cfg"], m["images"], kws[name]["kv_cache_dtype"]
        if quant == "rank":  # the reference of per-rank quantization is the whole tree's
            params = models[model]["trees"][f"{model}_int8"]
        if opts.get("depth"):
            params, cfg = first_layers(params, cfg, opts["depth"])
        if quant == "shards":  # the whole tree's quantize_tree, which the ranks hold shards of
            params = models[model]["trees"][f"{name}_int8"] = quantized(params)
        policy = DTypePolicy(dtype, dtype)
        dec, st = cfg.decoder_module, params["svg_transformer"]
        pre = serve_prefixes(params, cfg, images[:n_req], policy, prompts=SERVE_PROMPTS[:n_req])
        ref = {"bytes": tree_bytes(st)}
        if opts.get("bitwise"):  # each data group's requests through an engine of its slots
            data = kws[name]["mesh_axes"].get("data", 1)
            by_group = [engine_ids(params, cfg, pre[d::data], policy, dev, tfa, kv=kv, new=new,
                                   stops=(), slots=kws[name]["max_batch"] // data)[0]
                        for d in range(data)]
            ref["ids"] = [by_group[i % data][i // data] for i in range(n_req)]
        else:
            ref["ids"] = engine_ids(params, cfg, pre, policy, dev, tfa, kv=kv, new=new,
                                    stops=())[0]
        emb, mask = im2svg_prefix(params, cfg, images[:2],
                                  torch.tensor([PROMPT_IDS] * 2, device=dev), policy=policy)
        if kv is None:
            cache = dec.init_cache(cfg.llm, 2, emb.shape[1], dtype=policy.compute_dtype,
                                   device=dev)
            ref["first"] = dec.forward(st, cfg.llm, emb, mask, cache=cache, policy=policy,
                                       last_logits_only=True)[0][:, -1]
        else:
            ref["forced"], ref["forced_ids"] = forced_logits(dec, st, cfg.llm, emb, mask,
                                                             TP_FORCED, policy, True, kv)
            ref["forced_plain"] = forced_logits(dec, st, cfg.llm, emb, mask, TP_FORCED, policy,
                                                False, kv, ref["forced_ids"])[0]
        if opts.get("spec"):
            prompt = torch.tensor([SERVE_PROMPTS[0]], device=dev)
            tokens, length, n_fwd = generate_greedy_speculative(
                st, cfg.llm, pre[0], torch.ones(pre[0].shape[:2], dtype=torch.int32, device=dev),
                spec_ids(pre[0].shape[1], prompt), max_new_tokens=opts["spec"], draft_len=8,
                stop_sequences=(), pad_token_id=0, policy=policy)
            ref["spec"] = (tokens[0, :int(length[0])].tolist(), n_fwd)
        refs[name] = ref
        del emb, mask, pre
    return refs


def tensor_serving(sv, tfa, model, cfg, p16, p32, dev, card: str, depth: str) -> dict:
    """Phase 6e: the serve configs of TP_CONFIGS over TP_WORLD ranks,
    processes on the one card over a gloo group (_tp_rank), on phase 6's
    8B weights (`depth`) and on phase 4c's 1B trees (phase 4's seed, the
    first DEPTH_1B_EARLIER of 24 layers, drawn again here). The 8B's
    tp4dp2 in fp32 (2 replicas of tensor 4, 32 slots each, the fp32 cache
    that "bfloat16" names under fp32 compute) and the 1B's 1b-tp2dp4 (4
    replicas of tensor 2, 2 slots each): the first step's logits within
    fp32 TOL of one process's, the requests' greedy ids equal to the
    one-process fp32 engine's, and on the 1B one use_speculative request's
    ids and forward count equal to one process's; tp8-int8kv (bf16, tensor
    8, 16 slots, int8 cache), 1b-tp8-int8 (the same over the 1B's
    quantize_tree) and tp8-int8kv-q (the 8B's leaf with --quantize, each
    rank quantizing its own slices): teacher-forced logits against one
    process's over the int8 cache (kernels) within twice that path's own
    gap to its plain version plus 1e-3, and the greedy agreement of the
    engines' ids. The sharded runs: 1b-fsdp4dp2 (bf16, 2 data groups of
    fsdp 4: each group's first-step logits and greedy ids bit for bit one
    process's with the group's 4 slots and requests), 1b-stage2-seq2-tp2
    (fp32, stage 2 x sequence 2 x tensor 2: as 1b-tp2dp4, with its
    use_speculative request) and 8b-fsdp8-int8 (the 8B's first 2 layers,
    bf16, fsdp 8, each rank quantizing its own shards: its codes and scales
    its shards of quantize_tree's, teacher-forced logits over the int8 cache
    and greedy ids bit for bit one process's on the whole quantize_tree).
    Every rank's launches: kernel 1 a layer an admission (and the
    speculative prefill), kernel 2 (2' over the int8 cache) a layer a step,
    kernel 14 a projection a layer a forward of an int8 decoder, equal
    across a group; each rank's resident decoder bytes beside the whole
    tree's. Wall times over gloo on one card are no serving speed. Returns
    the per-rank results by run."""
    import socket

    import torch.multiprocessing as mp

    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy

    t0 = time.perf_counter()
    f32 = DTypePolicy(torch.float32, torch.float32)
    cfg1 = sv.starvector_1b_config()
    full = full_width_params(sv, cfg1, dev, torch.float32)
    cut, cfg1 = first_layers(full, cfg1, DEPTH_1B_EARLIER)
    p32_1b = _map_tree(cut, lambda t: t.clone())  # the first layers alone: the rest goes
    del full, cut
    p16_1b = _cast_tree(p32_1b, torch.bfloat16)
    L1 = cfg1.llm.n_layer
    images1 = processor_for_encoder(cfg1.image_encoder_type, cfg1.image_size,
                                    device=dev).batch(synthetic_images(4, 33))
    models = {"8b": dict(cfg=cfg, images=model.process_images(synthetic_images(4, 33)),
                         trees={"8b_fp32": p32, "8b_bf16": p16, "8b_int8": quantized(p16)}),
              "1b": dict(cfg=cfg1, images=images1,
                         trees={"1b_fp32": p32_1b, "1b_bf16": p16_1b,
                                "1b_int8": quantized(p16_1b)})}
    del p16_1b
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-tp-"))
    try:
        kws = {run[0]: _tp_serve_kwargs(run[2], work) for run in TP_CONFIGS}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    refs = _tp_references(tfa, models, kws, dev)
    t_ref = time.perf_counter() - t0

    ctx = mp.get_context("spawn")
    results, weights = ctx.Queue(), ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cfgs = {k: m["cfg"] for k, m in models.items()}
    procs = [ctx.Process(target=_tp_rank, args=(r, port, weights, kws, cfgs, results))
             for r in range(TP_WORLD)]
    shared = dict(trees={k: t for m in models.values() for k, t in m["trees"].items()
                         if k != "8b_int8"},
                  images={k: m["images"] for k, m in models.items()},
                  forced_ids={k: r["forced_ids"] for k, r in refs.items() if "forced_ids" in r})
    t1 = time.perf_counter()
    for proc in procs:
        proc.start()
        weights.put(shared)
    ranks: dict[int, dict] = {}
    try:
        deadline = time.monotonic() + TP_TIMEOUT
        while len(ranks) < TP_WORLD:
            try:
                rank, res = results.get(timeout=5)
            except Exception:  # noqa: BLE001 — queue.Empty: look at the processes
                if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(f"phase 6e: ranks {sorted(ranks)} reported, exit codes "
                                         f"{[p.exitcode for p in procs]}")
                continue
            if "error" in res:
                raise AssertionError(f"phase 6e: rank {rank} failed:\n{res['error']}")
            ranks[rank] = res
        for proc in procs:
            proc.join(timeout=60)
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 6e: exit codes {[p.exitcode for p in procs]}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        del shared
        if dev.type == "cuda":  # the blocks the ranks held through CUDA IPC, released by them
            torch.cuda.ipc_collect()
    t_ranks = time.perf_counter() - t1

    out = {}
    for name, model_name, _, dtype, quant, new, n_req, opts in TP_CONFIGS:
        ref, kw = refs[name], kws[name]
        L = opts.get("depth") or (L1 if model_name == "1b" else cfg.llm.num_hidden_layers)
        runs = [ranks[r][name] for r in range(TP_WORLD)]
        axes = kw["mesh_axes"]
        data = axes.get("data", 1)
        tp = axes.get("tensor", 1)
        int8_kv = kw["kv_cache_dtype"] is not None
        leaders = [run for run in runs if run["group_rank"] == 0]
        for lead in leaders:  # every rank of a group launched what its leader's run needs
            group = [run for run in runs if run["data_rank"] == lead["data_rank"]]
            steps = 4 * lead["ticks"]
            want = {"flash_prefill": L * (lead["prefill_chunks"] + ("spec" in lead)),
                    "decode_attention": L * steps,
                    "decode_attention_int8": L * steps if int8_kv else 0,
                    "quant_matmul": L * TP_PROJECTIONS[model_name]
                    * (lead["prefill_chunks"] + steps) if quant else 0,
                    **dict.fromkeys(TRAIN_KERNELS, 0)}
            for run in group:
                got = {k: run["counts"][k] for k in want}
                if got != want:
                    raise AssertionError(f"6e {name}: data group {lead['data_rank']} rank "
                                         f"{run['group_rank']} launched {got}, its leader's run "
                                         f"needs {want}")
                if run is not lead and run["checked"] < (new - 4 if lead["ids"] else 0):
                    raise AssertionError(f"6e {name}: a follower checked {run['checked']} steps")
        ids = {i: v for lead in leaders for i, v in lead["ids"].items()}
        ids = [ids[i] for i in range(n_req)]
        heads = sorted({run["heads"] for run in runs})
        walls = [run["wall"] for run in leaders]
        counts = runs[0]["counts"]
        resident = sorted({run["bytes"] for run in runs})
        held = (f"; resident decoder bytes a rank {'/'.join(f'{b / 1e9:.3f}' for b in resident)} "
                f"GB of the whole tree's {ref['bytes'] / 1e9:.3f} GB")
        if quant == "shards":
            codes = [run["codes"] for run in runs]
            if len(set(codes)) != 1 or not codes[0]:
                raise AssertionError(f"6e {name}: int8 leaves checked a rank {codes}")
            held += (f"; every rank's {codes[0]} int8 leaves (codes and scales) == its shards of "
                     f"the whole tree's quantize_tree")
        mesh = " x ".join(f"{a} {n}" for a, n in axes.items() if a != "data" and n > 1)
        where = (f"{data} replicas of {mesh}, {kw['max_batch'] // data} slots each"
                 if data > 1 else f"{mesh}, {kw['max_batch']} slots")
        weights_kind = {None: "", "whole": ", int8 weights (the whole quantize_tree's slices)",
                        "rank": ", int8 weights (each rank quantizing its own slices)",
                        "shards": ", int8 weights (each rank quantizing its own fsdp shards)"
                        }[quant]
        at = f"{L} of 24 layers" if model_name == "1b" else (
            f"{L} of 32 layers" if opts.get("depth") else depth)
        if opts.get("bitwise"):
            what = "first-step logits" if kw["kv_cache_dtype"] is None else (
                f"teacher-forced logits over {TP_FORCED} positions")
            want = ref["first"] if kw["kv_cache_dtype"] is None else ref["forced"]
            for lead in leaders:
                if not torch.equal(lead["check"].to(dev), want.float()):
                    err = (lead["check"].to(dev) - want.float()).abs().max().item()
                    raise AssertionError(f"6e {name}: data group {lead['data_rank']}'s {what} "
                                         f"part from one process's (max |diff| {err:.3e})")
            if ids != ref["ids"]:
                raise AssertionError(f"6e {name}: greedy ids {ids}\none process with each "
                                     f"group's slots {ref['ids']}")
            log("tp", f"{card}: {name} ({where}, {str(dtype)[6:]}{weights_kind}, "
                      f"{'int8' if int8_kv else str(dtype)[6:]} cache, at {at}; heads a rank "
                      f"{heads}): each data group's {what} of 2 prefixes bit for bit one "
                      f"process's; {n_req} greedy requests of {new} tokens: ids bit for bit the "
                      f"one-process engine's with each group's slots and requests; "
                      f"{launches_of(counts, heads, int8_kv, quant)}{held}; wall "
                      f"{', '.join(f'{w:.2f}' for w in walls)} s a replica over gloo on one card "
                      f"(not a serving speed)")
            out[name] = dict(err=0.0, ranks=runs)
            continue
        launches = launches_of(counts, heads, int8_kv, quant)
        if dtype == torch.float32:
            err = compare(f"6e {name} first-step logits", leaders[0]["check"].to(dev),
                          ref["first"], torch.float32)
            if ids != ref["ids"]:
                raise AssertionError(f"6e {name}: fp32 greedy ids {ids}\none process "
                                     f"{ref['ids']}")
            spec = ""
            if "spec" in ref:
                got_spec = next(run["spec"] for run in leaders if "spec" in run)
                if got_spec != ref["spec"]:
                    raise AssertionError(f"6e {name}: use_speculative ids and forwards "
                                         f"{got_spec}, one process {ref['spec']}")
                spec = (f"; one use_speculative request of {opts['spec']} tokens on data group "
                        f"0: ids and forward count ({got_spec[1]}) == one process's "
                        f"generate_greedy_speculative")
            log("tp", f"{card}: {name} ({where}, fp32 at {at}; "
                      f"heads a rank {heads} as (query, KV)): first-step logits of 2 prefixes "
                      f"within fp32 TOL of one process (max |diff| {err:.3e}); {n_req} "
                      f"concurrent greedy requests of {new} tokens: ids == the one-process fp32 "
                      f"engine's{spec}; {launches}{held}; wall "
                      f"{', '.join(f'{w:.2f}' for w in walls)} s a replica over gloo on one card "
                      f"(not a serving speed)")
            out[name] = dict(err=err, ranks=runs)
            continue
        got = leaders[0]["check"].to(dev)
        gap_tp = (got - ref["forced"]).abs().max().item()
        gap_plain = (ref["forced_plain"] - ref["forced"]).abs().max().item()
        if not torch.isfinite(got).all() or gap_tp > 2.0 * gap_plain + 1e-3:
            raise AssertionError(f"6e {name}: teacher-forced logits {gap_tp:.3e} from one "
                                 f"process's, over twice its plain path's {gap_plain:.3e}")
        agree = (got[:, :-1].argmax(-1) == ref["forced_ids"]).float().mean().item()
        same = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
                for x, y in zip(ids, ref["ids"])]
        log("tp", f"{card}: {name} ({where}, bf16{weights_kind}, int8 cache, at "
                  f"{at}; heads a rank "
                  f"{heads}): teacher-forced logits over {TP_FORCED} positions, B=2, max |diff| "
                  f"from one process {gap_tp:.4f} (one process's plain path: {gap_plain:.4f}; "
                  f"bound 2 x that + 1e-3), argmax == the fed ids at {agree:.4f}; {n_req} greedy "
                  f"requests of {new}: ids equal to the one-process engine's for the first "
                  f"{same} tokens; {launches}{held}; wall {walls[0]:.2f} s over gloo on one card "
                  f"(not a serving speed)")
        out[name] = dict(err=gap_tp, plain_gap=gap_plain, agree=agree, same=same, ranks=runs)
    log("phase", f"6e took {time.perf_counter() - t0:.0f} s: one-process references "
                 f"{t_ref:.0f} s, {TP_WORLD} ranks (start, shards, {len(TP_CONFIGS)} runs) "
                 f"{t_ranks:.0f} s")
    del models, refs
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4f: the other vision towers behind the 1B decoder
# ---------------------------------------------------------------------------

TOWERS_4F = (("vqgan", 224), ("convnext", 224), ("open-clip", 224), ("siglip_512", 512),
             ("siglip_256", 256))  # image_encoder_type, its stock image size
TOWER_PROMPT = PROMPT_IDS[:2]  # so that S = qlen + 2: phase 3's TOWER_PREFIXES
# the bf16 tower forward's relative L2 distance from the fp32 one: a few
# bf16 steps (2^-8) compounded over a tower's layers
TOWER_REL_TOL = 3e-2
TOWER_NEW, TOWER_FP32_NEW = 32, 16


def towers_1b(sv, tfa, dc, cfg, p16, p32, dev, card: str) -> dict:
    """Phase 4f, on phase 4's 1B decoder (all 24 layers, its projections
    scaled): each of vqgan, convnext, open-clip (224 px), siglip_512 and
    siglip_256 at its stock geometry, with its tower and an adapter of its
    width (256 / 1024 / 1024 / 768 / 768 -> 2048) drawn from a seeded
    generator (sv.init_vision_params), 2 synthetic images through its own
    processor:
      * the bf16 tower forward within TOWER_REL_TOL (relative L2) of the
        fp32 one; each one's device time at B = 2 (graph-replayed);
      * bf16 greedy generate_im2svg_ids at B = 2, 32 new tokens, a 2-id
        prompt: 24 flash_prefill at S = qlen + 2 (none for convnext's 51,
        which is the chunk step's, as in the JAX package, S <= 64) and 24
        decode_attention a decode step, exactly;
      * fp32 greedy ids with the kernels equal those with the plain
        attention on the first DEPTH_1B_EARLIER layers, 16 tokens.
    Returns {tower: its launches and times}."""
    import dataclasses

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.models import image_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    req = dict(prompt_ids=[TOWER_PROMPT] * 2, stop_sequences=STOP_IDS, use_nucleus_sampling=False)
    out = {}
    for i, (t, size) in enumerate(TOWERS_4F):
        t0 = time.perf_counter()
        tcfg = dataclasses.replace(cfg, image_encoder_type=t, image_size=size)
        enc = tcfg.encoder_config
        hidden, qlen = enc.geometry
        v32 = sv.init_vision_params(tcfg, torch.Generator(device=dev).manual_seed(40 + i),
                                    device=dev)
        v16 = _cast_tree(v32, torch.bfloat16)
        images = processor_for_encoder(t, size, device=dev).batch(synthetic_images(2, 40 + i))
        fwd = {label: functools.partial(image_encoder.forward, v["image_encoder"], enc, images,
                                        policy=policy)
               for label, v, policy in (("fp32", v32, f32), ("bf16", v16, bf16))}
        with torch.no_grad():
            e32, e16 = fwd["fp32"](), fwd["bf16"]()
            torch.cuda.synchronize()
            if e32.shape != (2, qlen, hidden) or not torch.isfinite(e16).all():
                raise AssertionError(f"4f {t}: tower output {tuple(e32.shape)}, finite "
                                     f"{bool(torch.isfinite(e16).all())}")
            rel = ((e16.float() - e32).norm() / e32.norm()).item()
            if rel > TOWER_REL_TOL:
                raise AssertionError(f"4f {t}: bf16 tower forward {rel:.3e} (relative L2) from "
                                     f"fp32, over {TOWER_REL_TOL}")
            ms = {label: cuda_ms(fn, iters=5) for label, fn in fwd.items()}

        S = qlen + len(TOWER_PROMPT)
        m16 = StarVectorForCausalLM({"svg_transformer": p16["svg_transformer"], **v16}, tcfg,
                                    policy=bf16, device=dev)
        reset_counts(tfa)
        _, toks, lengths = m16.generate_im2svg_ids({"image": images}, max_new_tokens=TOWER_NEW,
                                                   **req)
        torch.cuda.synchronize()
        steps = decode_steps(toks, lengths)
        got = expect_counts(f"4f {t} bf16", read_counts(tfa),
                            flash_prefill=L if S > dc.CHUNK_STEP_MAX else 0,
                            decode_attention=L * steps)

        s32, cut = first_layers({"svg_transformer": p32["svg_transformer"], **v32}, tcfg,
                                DEPTH_1B_EARLIER)
        ids = {}
        for kernels in (True, False):
            m32 = StarVectorForCausalLM(s32, cut, policy=f32, device=dev, kernels=kernels)
            _, ids[kernels], _ = m32.generate_im2svg_ids({"image": images},
                                                         max_new_tokens=TOWER_FP32_NEW, **req)
        if not torch.equal(ids[True], ids[False]):
            raise AssertionError(f"4f {t}: fp32 greedy ids differ, kernels against plain:\n"
                                 f"{ids[True].tolist()}\n{ids[False].tolist()}")
        out[t] = dict(S=S, launches=got, tower_ms=ms, rel=rel)
        log("towers", f"{card}: {t} at {size} px ({hidden} wide, {qlen} tokens) behind the 1B "
                      f"decoder: bf16 tower forward {rel:.3e} (relative L2) from fp32 (bound "
                      f"{TOWER_REL_TOL}); B=2 tower forward bf16 {ms['bf16']:.3f} ms, fp32 "
                      f"{ms['fp32']:.3f} ms; bf16 greedy, {TOWER_NEW} tokens, S = {S}: "
                      f"flash_prefill {got['flash_prefill']}"
                      + (f" = {L} x 1" if got["flash_prefill"] else
                         f" (S <= {dc.CHUNK_STEP_MAX}: the chunk step)")
                      + f", decode_attention {got['decode_attention']} = {L} x {steps} steps, "
                      f"{[len(set(r.tolist())) for r in toks]} distinct ids a row; fp32 greedy "
                      f"ids at {DEPTH_1B_EARLIER} layers, {TOWER_FP32_NEW} tokens, kernels == "
                      f"plain; {time.perf_counter() - t0:.1f} s")
        del v32, v16, m16, s32
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS, LR = 8, 1e-4
SVG_LENGTHS = (512, 431, 300, 187)  # ragged rows; the longest sets T = 257 + 512


def training_batch(cfg, process_images, dev, seed: int = 0, lengths=SVG_LENGTHS) -> dict:
    """One batch in the loader's format, from a seeded numpy generator:
    images normalised for the tower (len(lengths), size, size, 3), svg ids
    in the vocabulary, right-padded to the longest row."""
    rng = np.random.default_rng(seed)
    B, S = len(lengths), max(lengths)
    ids = rng.integers(0, cfg.llm.vocab_size, (B, S))
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return {"image": process_images(synthetic_images(B, 1000 + seed)),
            "svg_ids": np.where(mask > 0, ids, 0), "svg_mask": mask}


def _optimizer(params):
    """AdamW with configs/models/default.yaml's betas, eps, weight decay and
    clip, at lr 1e-4 without warmup (its 500 warmup steps would give these
    few steps almost no learning rate); cosine over its 100000 steps."""
    from starvector_tpu_torch.train.optim import build_optimizer

    return build_optimizer(params, lr=LR, warmup_steps=0, betas=(0.95, 0.999), eps=1e-8,
                           weight_decay=1e-6, grad_clip=1.0, total_steps=100_000)


def _run_training(sv, tfa, cfg, dev, batch, steps: int, policy, kernels: bool = True,
                  hook=None, *, optimizer=_optimizer, remat="dots_flash", grad_dtype=None):
    """`steps` steps of the port's train loop from fresh seeded weights;
    (params, per-step records of loss, grad_norm, wall time and launches).
    `optimizer(params)` builds the optimizer; `hook(step)` runs after each
    step's record."""
    from starvector_tpu_torch.train.train import train_loop

    params = sv.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    recs = []
    t_last = [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        recs.append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                         seconds=now - t_last[0], launches=read_counts(tfa)))
        if hook is not None:
            hook(step)
        t_last[0] = time.perf_counter()

    torch.cuda.synchronize()
    t_last[0] = time.perf_counter()
    params, _, _ = train_loop(params, cfg, optimizer(params),
                              ((0, batch) for _ in range(steps)), total_steps=steps, device=dev,
                              policy=policy, remat=remat, grad_dtype=grad_dtype, kernels=kernels,
                              on_step=on_step)
    return params, recs


def train_slice(sv, tfa, dev, process_images) -> dict:
    """8 steps of full-width 1B training on one fixed batch (overfitting
    it): fp32 master weights, bf16 compute, dots_flash. Checks the loss
    falls, every value is finite, and each step launched each training
    kernel once per layer."""
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = sv.starvector_1b_config()
    L = cfg.llm.n_layer
    batch = training_batch(cfg, process_images, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # the inference phases' weights, still held
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    params, recs = _run_training(sv, tfa, cfg, dev, batch, TRAIN_STEPS,
                                 DTypePolicy(torch.float32, torch.bfloat16))
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, per_step = check_train_run("training", recs, counts, L)
    T = 257 + max(SVG_LENGTHS)
    log("train", f"StarVector-1B at full width, B={len(SVG_LENGTHS)}, T={T} (svg lengths "
                 f"{list(SVG_LENGTHS)}), fp32 masters / bf16 compute, dots_flash, AdamW lr {LR}: "
                 f"{TRAIN_STEPS} steps on one batch, loss {[round(x, 4) for x in losses]}, "
                 f"grad_norm {[round(x, 4) for x in norms]}; launches per step "
                 f"{per_step[0]} (each = {L} layers), in all {counts}; peak memory "
                 f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
                 f"{base / 2**30:.2f} GiB held before the first step")
    return dict(recs=recs, counts=counts, T=T, B=len(SVG_LENGTHS), peak=peak, base=base,
                params=params, cfg=cfg)


def check_train_run(what: str, recs: list, counts: dict, L: int, forwards: int = 1,
                    every_step: bool = False):
    """Raise unless every loss and grad norm is finite, the loss fell (the
    last below every loss of the first half; with `every_step`, each below
    the one before), and each step launched each training kernel once a
    layer (the forward `forwards` times) and no other kernel; (losses, grad
    norms, launches per step)."""
    losses = [r["loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    per_step = [{k: b[k] - a[k] for k in TRAIN_KERNELS}
                for a, b in zip([dict.fromkeys(TRAIN_KERNELS, 0)] + [r["launches"] for r in recs],
                                [r["launches"] for r in recs])]
    fell = losses[-1] < min(losses[:max(len(losses) // 2, 1)])
    if every_step:
        fell = fell and all(b < a for a, b in zip(losses, losses[1:]))
    if not all(np.isfinite(losses + norms)) or not fell:
        raise AssertionError(f"{what}: losses {losses}, grad norms {norms}")
    expected = {k: L * (forwards if k == "flash_prefill_with_lse" else 1) for k in TRAIN_KERNELS}
    if any(n != expected for n in per_step) or \
            counts["flash_prefill"] or counts["decode_attention"] or counts["quant_matmul"]:
        raise AssertionError(f"{what} launches per step {per_step}, in all {counts}")
    return losses, norms, per_step


def fp32_check(sv, tfa, dev, cfg, batch, what: str) -> None:
    """From the same weights and batch, 2 fp32 steps with the kernels and 2
    with the plain attention. Bound on the updated weights: each AdamW step
    moves an element by at most about lr (the first by exactly lr x sign),
    so elements whose gradient is rounding noise may differ by up to
    2 lr a step; the bound is 3 lr x steps. The kernels' run launches each
    training kernel once a layer a step, the plain run none."""
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import tree_leaves

    f32 = DTypePolicy(torch.float32, torch.float32)
    L = cfg.llm.n_layer
    reset_counts(tfa)
    p_k, r_k = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=True)
    p_k = [t.detach() for t in tree_leaves(p_k)]
    reset_counts(tfa)
    p_p, r_p = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=False)
    n_k, n_p = ({k: r[-1]["launches"][k] for k in TRAIN_KERNELS} for r in (r_k, r_p))
    if n_k != dict.fromkeys(TRAIN_KERNELS, 2 * L) or any(n_p.values()):
        raise AssertionError(f"{what} fp32 training launches: kernels {n_k}, plain {n_p}")
    diffs = [(a - b.detach()).abs() for a, b in zip(p_k, tree_leaves(p_p))]
    max_diff = max(d.max().item() for d in diffs)
    n = sum(d.numel() for d in diffs)
    close = sum((d <= 1e-6).sum().item() for d in diffs) / n
    bound = 3 * LR * 2
    for a, b in zip(r_k, r_p):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or \
                abs(a["grad_norm"] - b["grad_norm"]) > 1e-3 * abs(b["grad_norm"]):
            raise AssertionError(f"{what} fp32 training: kernels {r_k}, plain {r_p}")
    if max_diff > bound:
        raise AssertionError(f"{what} fp32 training: updated weights differ by {max_diff:.3e} > "
                             f"{bound}")
    log("train", f"{what} fp32, 2 steps, kernels vs plain attention: loss "
                 f"{[r['loss'] for r in r_k]} vs {[r['loss'] for r in r_p]} (rtol 1e-4), "
                 f"grad_norm {[r['grad_norm'] for r in r_k]} vs {[r['grad_norm'] for r in r_p]} "
                 f"(rtol 1e-3); updated weights: max |diff| {max_diff:.3e} (bound 3 lr x 2 steps "
                 f"= {bound:.1e}), {close:.6f} of {n} elements within 1e-6; launches "
                 f"{n_k} with the kernels (2 steps x {L} layers), none with plain")
    del p_k, p_p, diffs
    torch.cuda.empty_cache()


def export_round_trip(sv, tfa, dev, train: dict, images, out: str) -> dict:
    """Phase 5b: the trained 1B (phase 5's fp32 masters) through
    train/hub.py's export_hf_checkpoint into the directory `out`, back
    through models/builder.py's load_pretrained_model at fp32; the loaded
    model's fp32 greedy ids for `images` (2, phase 4's) equal the in-memory
    weights', each generation launching flash_prefill once a layer and
    decode_attention once a layer a step. Phase 5c reads the directory;
    main deletes it after."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models.builder import load_pretrained_model
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.train.optim import tree_map

    cfg = train["cfg"]
    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    params = tree_map(lambda p: p.detach(), train.pop("params"))
    t0 = time.perf_counter()
    export_hf_checkpoint(params, cfg, build_test_tokenizer("v1"), out)
    t_export = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(out).iterdir())
    t0 = time.perf_counter()
    loaded, cfg2, tok, _, context_len = load_pretrained_model(out, torch.float32, dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if cfg2.llm != cfg.llm or context_len != cfg.max_length_train or tok.version != "v1":
        raise AssertionError(f"export round trip: config {cfg2.llm} vs {cfg.llm}, context "
                             f"{context_len} vs {cfg.max_length_train}, tokenizer {tok.version}")
    kw = {**GREEDY, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32}
    ids, launches = {}, {}
    for name, tree, c in (("in memory", params, cfg), ("reloaded", loaded, cfg2)):
        reset_counts(tfa)
        _, ids[name], lengths = StarVectorForCausalLM(tree, c, policy=f32, device=dev) \
            .generate_im2svg_ids({"image": images}, **kw)
        torch.cuda.synchronize()
        counts = read_counts(tfa)
        steps = decode_steps(ids[name], lengths)
        launches[name] = {k: counts[k] for k in ("flash_prefill", "decode_attention")}
        if launches[name] != {"flash_prefill": L, "decode_attention": L * steps} or steps < 1:
            raise AssertionError(f"export round trip, {name}: launches {launches[name]}, "
                                 f"{steps} decode steps")
    if not torch.equal(ids["in memory"], ids["reloaded"]):
        raise AssertionError(f"export round trip: greedy ids differ\n{ids['in memory'].tolist()}"
                             f"\n{ids['reloaded'].tolist()}")
    log("export", f"the trained 1B through export_hf_checkpoint ({size / 1e9:.3f} GB written in "
                  f"{t_export:.1f} s) and load_pretrained_model at fp32 ({t_load:.1f} s; "
                  f"context_len {context_len}): fp32 greedy ids for 2 images, 32 tokens, equal "
                  f"to the in-memory weights' ({[len(set(r.tolist())) for r in ids['reloaded']]} "
                  f"distinct ids a row); launches {launches['reloaded']} (each = {L} layers)")
    del params, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return launches["reloaded"]


# ---------------------------------------------------------------------------
# phases 5c and 5d: the entry points at full 1B width and depth
# ---------------------------------------------------------------------------

class CallSpy:
    """Within `with CallSpy(owner, name) as spy:`, owner.name (a function
    of a module, or a classmethod) is wrapped: spy.calls lists (result,
    seconds) of each call, the card synchronised at its end."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.raw, fn = vars(self.owner)[self.name], getattr(self.owner, self.name)

        def spied(*a, **kw):
            t = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((result, time.perf_counter() - t))
            return result

        setattr(self.owner, self.name, spied)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)


ENTRY_NEW, SERVE_IMAGES, SERVE_ENTRY_NEW, WEBUI_NEW = 64, 4, 128, 32


def entry_points_1b(tfa, dev, card: str, ckpt: str, work: Path) -> dict:
    """Phase 5c, on phase 5b's exported 1B (`ckpt`, all 24 layers):
      * `python -m starvector_tpu_torch.quickstart ckpt image 64` through its
        main, on one synthetic PNG, its stdout captured: the printed SVG
        starts with '<svg'; launches exactly 24 flash_prefill and 24
        decode_attention a decode step; the load's and the generation's
        seconds;
      * quickstart_serve's serve_images on the model main loaded, 4 images,
        128 new tokens: every request done; flash_prefill 24 an engine
        prefill chunk (stats()["prefill_chunks"]), decode_attention 24 a
        step (4 a tick), exactly;
      * the web UI (serve/webui.py) over a ModelWorker on that model, both on
        127.0.0.1: one greedy im2svg request of 32 tokens streams its chunks
        through /api/generate, each error_code 0; one vote lands in
        votes.jsonl.
    Returns the launches of each."""
    import threading

    from PIL import Image

    from starvector_tpu_torch import api, quickstart
    from starvector_tpu_torch.quickstart_serve import serve_images
    from starvector_tpu_torch.serve import webui, worker as wk
    from starvector_tpu_torch.serve.httpd import post_json

    paths = []
    for i, img in enumerate(synthetic_images(SERVE_IMAGES, 81)):
        paths.append(str(work / f"image{i}.png"))
        Image.fromarray(img).save(paths[-1])
    launches = {}

    reset_counts(tfa)
    with CallSpy(api.StarVectorForCausalLM, "from_pretrained") as load, \
            CallSpy(api, "generate") as gen, contextlib.redirect_stdout(io.StringIO()) as stdout:
        quickstart.main([ckpt, paths[0], str(ENTRY_NEW)])
    counts = read_counts(tfa)
    printed = stdout.getvalue()
    (model, t_load), = load.calls
    ((tokens, lengths), t_gen), = gen.calls
    L = model.cfg.llm.n_layer
    steps = decode_steps(tokens, lengths)
    launches["quickstart"] = expect_counts("5c quickstart", counts, flash_prefill=L,
                                           decode_attention=L * steps)
    if not printed.startswith("<svg"):
        raise AssertionError(f"5c quickstart printed {printed[:200]!r}")
    log("entry", f"{card}: quickstart.main on the exported 1B (bf16, {L} layers), one image, "
                 f"{ENTRY_NEW} greedy tokens: from_pretrained {t_load:.2f} s, generation "
                 f"{t_gen:.2f} s ({int(lengths[0])} tokens); printed {len(printed)} characters "
                 f"from '<svg'; launches {launches['quickstart']} ({L} x {steps} decode steps)")

    reset_counts(tfa)
    t0 = time.perf_counter()
    texts, stats = serve_images(model, paths, SERVE_ENTRY_NEW)
    wall = time.perf_counter() - t0
    counts = read_counts(tfa)
    launches["quickstart_serve"] = expect_counts(
        "5c quickstart_serve", counts, flash_prefill=L * stats["prefill_chunks"],
        decode_attention=L * 4 * stats["ticks"])
    if len(texts) != SERVE_IMAGES or not all(t.startswith("<svg") for t in texts):
        raise AssertionError(f"5c quickstart_serve: {[t[:40] for t in texts]}")
    log("entry", f"{card}: quickstart_serve.serve_images on that model, {SERVE_IMAGES} images, "
                 f"{SERVE_ENTRY_NEW} greedy tokens: every request done in {wall:.2f} s, "
                 f"{stats['tokens_emitted']} tokens in {stats['ticks']} ticks, "
                 f"{stats['prefill_chunks']} prefill chunks; launches "
                 f"{launches['quickstart_serve']} ({L} a chunk, {L} x 4 a tick)")

    worker = wk.ModelWorker(model, worker_addr="pending", max_batch=2, max_len=1024)
    votes = work / "votes"
    servers = [wk.build_server(worker)]
    servers.append(webui.build_server(f"http://127.0.0.1:{servers[0].server_address[1]}",
                                      str(votes)))
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for th in threads:
        th.start()
    ui = f"http://127.0.0.1:{servers[1].server_address[1]}"
    try:
        reset_counts(tfa)
        t0 = time.perf_counter()
        payload = {"task": "im2svg", "image": png_b64(synthetic_images(1, 82)[0]),
                   "max_new_tokens": WEBUI_NEW, "temperature": 0.0}
        with post_json(ui + "/api/generate", payload, 300) as resp:
            raw = resp.read()
        wall = time.perf_counter() - t0
        counts = read_counts(tfa)
        chunks = [json.loads(c) for c in raw.split(b"\0") if c]
        with post_json(ui + "/api/vote", {"vote": 1, "svg": chunks[-1]["text"] if chunks else ""},
                       60) as resp:
            resp.read()
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for th in threads:
            th.join(60)
        worker.shutdown()
    if not chunks or any(c["error_code"] != 0 or not c["text"].startswith("<svg")
                         for c in chunks):
        raise AssertionError(f"5c web UI: chunks {chunks[-1:]}")
    records = [json.loads(line) for line in open(votes / "votes.jsonl")]
    if len(records) != 1 or records[0]["vote"] != 1:
        raise AssertionError(f"5c web UI: votes.jsonl holds {records}")
    if counts["flash_prefill"] % L or not counts["flash_prefill"] or \
            counts["decode_attention"] % L or not counts["decode_attention"]:
        raise AssertionError(f"5c web UI: launches {counts}")
    launches["webui"] = {k: counts[k] for k in ("flash_prefill", "decode_attention")}
    log("entry", f"{card}: the web UI over a ModelWorker on that model (127.0.0.1): one greedy "
                 f"im2svg request of {WEBUI_NEW} tokens streamed {len(chunks)} chunks through "
                 f"/api/generate in {wall:.2f} s, every error_code 0; one vote in votes.jsonl; "
                 f"launches {launches['webui']}")
    del model, worker
    gc.collect()
    torch.cuda.empty_cache()
    return launches


GRPO_YAML = "configs/models/starvector-1b/im2svg-grpo.yaml"
MESH_YAML = "configs/models/starvector-1b/im2svg-icons.yaml"
MESH_STEPS = 3


class LongSVGDataset:
    """Phase 5e's in-memory dataset (the train split's `target`): seeded
    synthetic images processed for the CLIP tower at `size` px, and SVGs
    of 120 paths, long enough that every row fills the loader's 512 svg
    tokens (T = 257 + 512 at 224 px). The yaml's hub keys are taken and
    ignored."""

    def __init__(self, n: int = 4, seed: int = 0, size: int = 224, **_):
        from starvector_tpu_torch.data.processor import processor_for_encoder

        images = processor_for_encoder("clip", size, device="cpu").batch(
            synthetic_images(n, seed)).numpy()
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            paths = "".join(f'<path d="M{a} {b} L{c} {d} Z" fill="#{e:06x}"/>'
                            for a, b, c, d, e in rng.integers(0, size, (120, 5)))
            self.items.append({"svg": f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
                                      f'height="{size}">{paths}</svg>',
                               "image": images[i], "caption": "", "id": f"long-{i}"})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_train_1b(tfa, dev, card: str, work: Path, overrides: tuple = ()) -> dict:
    """Phase 5e: `python -m starvector_tpu_torch.train.train` through its
    main on MESH_YAML at full 1B width and all 24 layers (LongSVGDataset,
    B=2, T=769, bf16 compute, dots_flash, no warm-up, MESH_STEPS steps),
    first in a process group of world size 1 over NCCL (torchrun's
    variables set in this process: main joins the group, lays out the mesh,
    fsdp: -1 over the one rank, and ends the group), then as one plain
    process. Each run's checkpoint at the last step is recorded, not
    written (the 1B's state is 17 GB). The runs must log the same losses
    (the first bit for bit, the others 1e-4 relative) and end with the same
    parameters, each within 2 x lr x MESH_STEPS (AdamW moves an element at
    most lr a step; the embedding's backward adds in an order of its own a
    run), and the mesh run must launch exactly 24 forwards (kernel 5) and
    24 + 24 backward kernels (kernel 6) a step and nothing else. `overrides`
    are more dotlist entries (a rehearsal's smaller model). Returns the
    launches, peak memory and seconds of the mesh run."""
    import torch.distributed as dist

    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.train import checkpoint as ckpt
    from starvector_tpu_torch.train import train as train_mod
    from starvector_tpu_torch.train.optim import tree_leaves

    if not overrides:  # every row fills the 512 svg tokens: T = 257 + 512
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

        tok = build_test_tokenizer("v1")
        lengths = [tok([item["svg"]], max_length=4096)["input_ids"].shape[1]
                   for item in LongSVGDataset(4, 31).items]
        if min(lengths) < 512:
            raise AssertionError(f"5e: svg token lengths {lengths}")

    def run(name: str, env: dict) -> dict:
        out = work / name
        argv = [f"config={Path(__file__).resolve().parent / MESH_YAML}",
                f"data.train.target={__name__}.LongSVGDataset", "data.train.params.n=4",
                "data.train.params.seed=31", "data.val=null", "data.batch_size=2",
                "data.max_length=512", "data.num_workers=2", f"training.steps={MESH_STEPS}",
                "training.grad_accum_steps=1", "training.lr_warmup_steps=0",
                "training.log_every=1", "project.snapshot_code=false",
                f"project.out_dir={out}", *overrides]
        config = get_config(argv, default_path=resolve_repo_config())
        saved = []
        real_save = ckpt.save_checkpoint
        ckpt.save_checkpoint = lambda base, step, state, **kw: saved.append(
            (step, len(tree_leaves(state["params"]))))
        os.environ.update(env)
        reset_counts(tfa)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as stdout:
                params = train_mod.main(config)
            torch.cuda.synchronize()
        finally:
            ckpt.save_checkpoint = real_save
            for k in env:
                os.environ.pop(k, None)
        wall = time.perf_counter() - t0
        logged = [json.loads(line) for line in open(out / "metrics.jsonl")]
        return dict(params=params, losses=[r["loss"] for r in logged if "loss" in r],
                    steps=[r["step"] for r in logged if "loss" in r], counts=read_counts(tfa),
                    peak=torch.cuda.max_memory_allocated(), wall=wall, saved=saved,
                    printed=stdout.getvalue(), lr=float(config.get_path("training.lr")))

    mesh = run("mesh", {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                        "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())})
    if dist.is_initialized():
        raise AssertionError("5e: train.main left its process group open")
    summary = [line for line in mesh["printed"].splitlines() if line.startswith("Mesh(")]
    plain = run("plain", {})
    n_layers = mesh["params"]["svg_transformer"]["layers"]["ln_1"]["scale"].shape[0]
    per_step = {k: mesh["counts"][k] / MESH_STEPS for k in TRAIN_KERNELS}
    others = {k: mesh["counts"][k] for k in ("flash_prefill", "decode_attention", "quant_matmul")}
    if any(v != n_layers for v in per_step.values()) or any(others.values()):
        raise AssertionError(f"5e launches {mesh['counts']}")
    if mesh["steps"] != list(range(1, MESH_STEPS + 1)) or plain["steps"] != mesh["steps"]:
        raise AssertionError(f"5e steps logged {mesh['steps']} / {plain['steps']}")
    if mesh["saved"] != [(MESH_STEPS, len(tree_leaves(plain["params"])))] or \
            mesh["saved"] != plain["saved"]:
        raise AssertionError(f"5e checkpoints {mesh['saved']} / {plain['saved']}")
    if len(summary) != 1 or "; 1 devices)" not in summary[0]:
        raise AssertionError(f"5e mesh summary {summary}")
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"])]
    diffs = [float((a.detach() - b.detach()).abs().max())
             for a, b in zip(tree_leaves(mesh["params"]), tree_leaves(plain["params"]))]
    moved = sum(d > 0 for d in diffs)
    bound_p = 2 * mesh["lr"] * MESH_STEPS
    if mesh["losses"][0] != plain["losses"][0] or max(rel) > 1e-4 or max(diffs) > bound_p:
        raise AssertionError(f"5e: losses {mesh['losses']} / {plain['losses']}, parameter "
                             f"max |diff| {max(diffs):.3e} (bound {bound_p:.1e})")
    log("mesh", f"{card}: train.main on {MESH_YAML} at full 1B width, {n_layers} layers, bf16 "
                f"compute, dots_flash, B=2, T=769, {MESH_STEPS} steps, in an NCCL process group "
                f"of world size 1 ({summary[0]}): losses {mesh['losses']} == one plain "
                f"process's {plain['losses']} (first bit for bit, max relative "
                f"{max(rel):.2e}); parameters after step {MESH_STEPS}: max |diff| "
                f"{max(diffs):.3e} over {len(diffs)} leaves, {moved} not bit for bit (bound "
                f"{bound_p:.1e}); launches a step {per_step} ({n_layers} layers: kernel 5 "
                f"forward, kernel 6 dkdv + dq); rank 0 wrote the checkpoint at step {MESH_STEPS}; "
                f"seconds: mesh {mesh['wall']:.1f}, plain {plain['wall']:.1f}")
    log("mesh", f"{card}: peak memory of the mesh run {mesh['peak'] / 2**30:.2f} GiB "
                f"(plain {plain['peak'] / 2**30:.2f} GiB)")
    del mesh["params"], plain["params"]
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=mesh["counts"], peak=mesh["peak"], wall=mesh["wall"])


# ---------------------------------------------------------------------------
# phase 5f: sequence parallelism's per-rank attention at the 8B's width
# ---------------------------------------------------------------------------

SP_RANKS = 2  # im2svg-stack-v5e8.yaml's mesh: fsdp 4 x sequence 2
SP_TOTALS = (576 + 8192, 576 + 4096)  # SigLIP's 576 visual tokens + the svg bucket
SP_H, SP_HKV, SP_WINDOW = 36, 4, 4096
# where the launches' q_offset sits among a training wrapper's positional arguments
Q_OFFSET_ARG = {"flash_prefill_with_lse": 4, "flash_bwd_dkdv": 7, "flash_bwd_dq": 7}


@contextlib.contextmanager
def launch_offsets(tfa):
    """{kernel: [q_offset of each launch]} of the three training kernels
    while within: each wrapper is replaced in the module, where the autograd
    Function looks it up and where the wrapper finds the counter it bumps
    (so the counter lives on the replacement while within, and goes back
    after); calls that take the plain version are not launches and are not
    recorded."""
    real = {name: getattr(tfa, name) for name in TRAIN_KERNELS}
    seen = {name: [] for name in TRAIN_KERNELS}

    def wrapped(name):
        fn, at = real[name], Q_OFFSET_ARG[name]

        def call(*args, **kw):
            before = call.launches
            out = fn(*args, **kw)
            if call.launches > before:
                seen[name].append(int(args[at] if len(args) > at else kw.get("q_offset", 0)))
            return out

        call.launches = fn.launches
        return call

    for name in TRAIN_KERNELS:
        setattr(tfa, name, wrapped(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            fn.launches = getattr(tfa, name).launches
            setattr(tfa, name, fn)


def sequence_attention_8b(tfa, dev, card: str) -> dict:
    """Phase 5f (see the module docstring). Returns each training kernel's
    launches (the bf16 ranks' run of both lengths) and each length's
    errors and times."""
    from starvector_tpu_torch.parallel.sequence import sp_chunk_attention

    def fwd_bwd(q, k, v, mask, do, rank=None, kernels=True):
        """(out, dq, dk, dv): one rank's chunk (rank given) or the whole
        sequence, through autograd as the training step runs it."""
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        if rank is None:
            out = tfa.flash_prefill_trainable(q, k, v, mask, window=SP_WINDOW, kernels=kernels)
        else:
            out = sp_chunk_attention(q, k, v, mask, rank, window=SP_WINDOW, kernels=kernels)
        out.backward(do)
        return out.detach(), q.grad, k.grad, v.grad

    g = torch.Generator(device=dev).manual_seed(19)
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    res = {}
    for T in SP_TOTALS:
        c = T // SP_RANKS
        q, do = (torch.randn((1, T, SP_H, 128), generator=g, device=dev).bfloat16() for _ in "qo")
        k, v = (torch.randn((1, T, SP_HKV, 128), generator=g, device=dev).bfloat16() for _ in "kv")
        mask = torch.ones((1, T), dtype=torch.int32, device=dev)
        chunk = [slice(r * c, (r + 1) * c) for r in range(SP_RANKS)]
        # bf16: the ranks' results assembled against one unsharded call
        reset_counts(tfa)
        with launch_offsets(tfa) as offsets:
            ranks = [fwd_bwd(q[:, sl], k, v, mask, do[:, sl], r) for r, sl in enumerate(chunk)]
        torch.cuda.synchronize()
        want = {name: [r * c for r in range(SP_RANKS)] for name in TRAIN_KERNELS}
        if offsets != want:
            raise AssertionError(f"5f T={T}: the kernels' q_offset by launch {offsets}, "
                                 f"expected {want}")
        for name in TRAIN_KERNELS:
            launches[name] += len(offsets[name])
        assembled = dict(out=torch.cat([r[0] for r in ranks], 1),
                         dq=torch.cat([r[1] for r in ranks], 1),
                         dk=sum(r[2].float() for r in ranks).bfloat16(),
                         dv=sum(r[3].float() for r in ranks).bfloat16())
        whole = dict(zip(("out", "dq", "dk", "dv"), fwd_bwd(q, k, v, mask, do)))
        ref32 = dict(zip(("out", "dq", "dk", "dv"),
                         fwd_bwd(*(t.float() for t in (q, k, v)), mask, do.float())))
        errs = {w: compare_training(f"5f T={T} sequence-parallel {w} (bf16)", assembled[w],
                                    whole[w], ref32[w], torch.bfloat16) for w in assembled}
        del assembled, whole, ref32, ranks
        # fp32: each rank's chunk, kernels against plain
        f32 = [t.float() for t in (q, k, v, do)]
        err32 = 0.0
        for r, sl in enumerate(chunk):
            got = fwd_bwd(f32[0][:, sl], f32[1], f32[2], mask, f32[3][:, sl], r)
            plain = fwd_bwd(f32[0][:, sl], f32[1], f32[2], mask, f32[3][:, sl], r,
                            kernels=False)
            err32 = max([err32] + [compare(f"5f T={T} rank {r} {w} (fp32)", a, b,
                                           torch.float32)
                                   for w, a, b in zip(("out", "dq", "dk", "dv"), got, plain)])
            del got, plain
        del f32
        torch.cuda.empty_cache()
        # times: each rank's forward + backward beside the unsharded call's
        ms = [event_ms(lambda sl=sl, r=r: fwd_bwd(q[:, sl], k, v, mask, do[:, sl], r), iters=10)
              for r, sl in enumerate(chunk)]
        ms_whole = event_ms(lambda: fwd_bwd(q, k, v, mask, do), iters=10)
        res[T] = dict(errs=errs, err32=err32, ms=ms, whole_ms=ms_whole)
        log("sp", f"{card}: S_total={T} (B=1 H={SP_H} Hkv={SP_HKV} window {SP_WINDOW} bf16) "
                  f"over sequence "
                  f"{SP_RANKS}, chunks of {c} at q_offset {[r * c for r in range(SP_RANKS)]}: "
                  f"assembled vs unsharded max |diff| "
                  + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
                  + f"; fp32 each rank kernels vs plain {err32:.3e}; launches a rank: one "
                  f"each of {', '.join(TRAIN_KERNELS)}, q_offset {offsets['flash_bwd_dq']}; "
                  f"forward + backward ms: rank 0 {ms[0]:.3f}, rank 1 {ms[1]:.3f}, unsharded "
                  f"{ms_whole:.3f} (unsharded / slowest rank {ms_whole / max(ms):.2f}x, rank 1 / "
                  f"rank 0 {ms[1] / ms[0]:.2f}x)")
        del q, k, v, do, mask
        torch.cuda.empty_cache()
    return dict(launches=launches, cases=res)


def grpo_driver_1b(tfa, dev, card: str, work: Path, overrides: tuple = ()) -> dict:
    """Phase 5d: `python -m starvector_tpu_torch.train.grpo` through its
    main at full 1B width and all 24 layers, on GRPO_YAML (kl_beta 0.02:
    the KL reference's log-probs each step) with ToySVGDataset at 224 px,
    B = 2, G = 2, 64 new tokens, 2 steps, a checkpoint at step 2: 2 steps
    logged to metrics.jsonl; checkpoint-2 restores to the trainer's
    parameters bit for bit; kernels 1 and 2 (the rollouts) and 5 and 6 (the
    update and the reference log-probs) launched, each a multiple of 24.
    The card's machine has no librsvg/cairo, so every reward is 0 (the
    update's gradients are zero; its kernels run all the same). `overrides`
    are more dotlist entries (a rehearsal's smaller model). Returns the
    launches and the steps' seconds."""
    from starvector_tpu_torch.config import get_config
    from starvector_tpu_torch.train import grpo
    from starvector_tpu_torch.train.checkpoint import restore_checkpoint
    from starvector_tpu_torch.train.optim import tree_leaves

    out_dir = work / "grpo"
    argv = [f"config={Path(__file__).resolve().parent / GRPO_YAML}",
            "data.train.target=starvector_tpu.data.datasets.ToySVGDataset",
            "data.train.params.im_size=224", "data.batch_size=2", "grpo.num_generations=2",
            "grpo.max_new_tokens=64", "grpo.steps=2", "training.checkpointing_steps=2",
            f"project.out_dir={out_dir}", *overrides]
    reset_counts(tfa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as stdout:
        model, records = grpo.main(get_config(argv))
    wall = time.perf_counter() - t0
    counts = read_counts(tfa)
    L = model.cfg.llm.n_layer
    logged = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    if [r["step"] for r in logged if "loss" in r] != [1, 2] or len(records) != 2:
        raise AssertionError(f"5d: logged {logged}")
    ckpts = sorted(p.name for p in out_dir.iterdir() if p.name.startswith("checkpoint-"))
    if ckpts != ["checkpoint-2"]:
        raise AssertionError(f"5d: checkpoints {ckpts}")
    t0 = time.perf_counter()
    saved = restore_checkpoint(str(out_dir / "checkpoint-2"), dev)["params"]
    t_restore = time.perf_counter() - t0
    a, b = tree_leaves(saved), tree_leaves(model.params)
    if len(a) != len(b) or not all(torch.equal(x, y.detach()) for x, y in zip(a, b)):
        raise AssertionError("5d: checkpoint-2 does not restore the trainer's parameters")
    used = ("flash_prefill", "decode_attention", "flash_prefill_with_lse", "flash_bwd_dkdv",
            "flash_bwd_dq")
    got = {k: counts[k] for k in used}
    if any(not n or n % L for n in got.values()):
        raise AssertionError(f"5d: launches {got}")
    parts = [tuple(round(r[k], 3) for k in ("rollout_s", "reward_s", "update_s"))
             for r in records]
    step_s = [round(sum(p), 3) for p in parts]
    log("grpo", f"{card}: train.grpo.main on {GRPO_YAML}, StarVector-1B at full width and {L} "
                f"layers, ToySVGDataset at 224 px, B=2, G=2, 64 tokens, 2 steps: "
                f"{wall:.1f} s in all; steps {step_s} s (rollout / reward / update {parts}); "
                f"printed {len(stdout.getvalue().splitlines())} lines; 2 steps in metrics.jsonl; "
                f"checkpoint-2 restored ({len(a)} leaves, {t_restore:.1f} s) == the trainer's "
                f"parameters bit for bit; launches {got}")
    del model, saved
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=got, step_s=step_s)


TRAIN_KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("flash_bwd_dkdv", ("flash_bwd_dkdv",)),  # with its finish kernel
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_prefill_with_lse", ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


PROFILE_FILES = {"1B": "profile_train.txt", "8B": "profile_train_8b.txt",
                 "8B recipe": "profile_train_8b_recipe.txt"}


def profile_train_step(sv, tfa, dev, cfg, batch, card: str, step_wall: float, out_dir: Path,
                       label: str, remat="dots_flash", **run) -> None:
    """Where one full-width train step's device time goes: torch.profiler
    traces the 4th step of a fresh run (3 of warm-up); the wall time is
    the unprofiled median of phase 5 (the 1B), 6b (the 8B) or 6c (the 8B
    recipe; `run` its optimizer and grad_dtype). Writes the kernel table to
    out_dir/PROFILE_FILES[label]."""
    from torch.profiler import ProfilerActivity, profile

    from starvector_tpu_torch.ops.layers import DTypePolicy

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(step):
        if step == 3:
            prof.start()
        elif step == 4:
            prof.stop()

    _run_training(sv, tfa, cfg, dev, batch, 4, DTypePolicy(torch.float32, torch.bfloat16),
                  hook=hook, remat=remat, **run)
    gc.collect()
    torch.cuda.empty_cache()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class: dict[str, float] = {}
    for e in rows:
        cls = next((lab for lab, keys in TRAIN_KERNEL_CLASSES
                    if any(k in e.key.lower() for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    device = sum(by_class.values())
    if not device:
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    B, S = batch["svg_ids"].shape
    T = cfg.encoder_config.geometry[1] + S
    path = out_dir / PROFILE_FILES[label]
    path.write_text(
        f"{card}\nStarVector-{label} train step, B={B} T={T}, {cfg.llm.n_layer} decoder layers, "
        f"bf16 compute, remat {remat!r}, "
        + ("Adafactor, bf16 gradients\n" if label == "8B recipe" else "AdamW\n")
        + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    log("profile", f"{card}: {label} train step B={B} T={T} (tables in {path}): wall "
                   f"{step_wall * 1e3:.1f} ms without the profiler, device {device:.1f} ms under "
                   f"it, busy {device / step_wall / 1e3:.1%}; device time: "
                   + ", ".join(f"{k} {v:.1f} ms ({v / device:.1%})"
                               for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))


def training_times(tfa, dev, card: str, train: dict, errs: dict) -> list[dict]:
    """Train step wall time and tokens/s from phase 5 (median of the 5 steps
    after 3 of warm-up), and the training kernels' device times against
    their plain versions at the 1B training shape in bf16."""
    secs = [r["seconds"] for r in train["recs"][3:]]
    step = statistics.median(secs)
    B, T = train["B"], train["T"]
    log("times", f"{card}: train step B={B} T={T} (1B, bf16 compute, dots_flash): "
                 f"{step * 1e3:.1f} ms median of {len(secs)} steps after 3 of warm-up "
                 f"({[round(x * 1e3, 1) for x in secs]} ms), {B * T / step:.0f} tokens/s, peak "
                 f"memory {train['peak'] / 2**30:.2f} GiB ({(train['peak'] - train['base']) / 2**30:.2f}"
                 f" GiB above the inference weights held before it)")
    g = torch.Generator(device=dev).manual_seed(7)
    H, D = 16, 128
    qkv = torch.randn((B, T, (H + 2) * D), generator=g, device=dev).bfloat16()
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k, v = (qkv[..., (H + i) * D:(H + i + 1) * D].unflatten(-1, (1, D)) for i in (0, 1))
    do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask)
    delta = tfa.attention_delta(out, do)
    shape = f"B={B} S=T={T} H=16 Hkv=1 D=128 bf16"
    # yardsticks: the flash forward op that also returns the logsumexp, and
    # SDPA's backward (dq, dk and dv in one op, against dkdv + dq), on
    # (B, H, T, D) copies with K/V expanded to the 16 heads
    qh, kh, vh, doh = (t.transpose(1, 2).expand(B, H, T, D).contiguous() for t in (q, k, v, do))
    lib_fwd = library_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, True), "aten._scaled_dot_product_flash_attention")
    lib_bwd = sdpa_backward_ms(qh, kh, vh, doh)
    pairs = B * T * (T + 1) // 2 * H  # (query, key) pairs under the causal mask, all heads
    act, kv, stats = B * T * H * D * 2, B * T * D * 2, B * H * T * 4  # bytes of one of each
    rows = []
    for name, fn, replaces, nbytes, flops, lib in (
            ("flash_prefill_with_lse", lambda kn: tfa.flash_prefill_with_lse(q, k, v, mask,
                                                                             kernels=kn), 330,
             2 * act + 2 * kv + stats + B * T * 4, 4 * D * pairs, lib_fwd),
            ("flash_bwd_dkdv", lambda kn: tfa.flash_bwd_dkdv(q, k, v, mask, do, lse, delta,
                                                             kernels=kn), 968,
             2 * act + 4 * kv + 2 * stats + B * T * 4, 8 * D * pairs, lib_bwd),
            ("flash_bwd_dq", lambda kn: tfa.flash_bwd_dq(q, k, v, mask, do, lse, delta,
                                                         kernels=kn), 968,
             3 * act + 2 * kv + 2 * stats + B * T * 4, 6 * D * pairs, lib_bwd)):
        plain_ms, ms = _turns(lambda: fn(False), lambda: fn(True))
        b_ms, b_by = bound(nbytes, flops)
        log("times", f"{card}: {name} {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                     f"TFLOP/s, {b_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
                     f"GFLOP), library {'n/a' if lib is None else f'{lib:.4f} ms'}")
        src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
        rows.append(dict(name=name, route="cuda", source=f"starvector_tpu_torch/csrc/{src}",
                         replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                         launches=train["counts"][name], max_abs_err=errs[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


# the training kernels at a tensor rank's heads (phase 5g's two tensor
# cases) and at a pipeline stage's microbatch (its stage case): the row
# suffix, the case, B, T, H, Hkv, window, and the line of the TPU backward
# kernel that shape runs (fused for T <= 2048, one-pass above)
TP_TRAIN_TIMES = (("_tp1b", "1b-fsdp2-tp2", 4, 769, 8, 1, None, 968),
                  ("_tp8b", "8b-tp4", 1, 4700, 9, 1, 4096, 1092),
                  ("_pp1b", "1b-stage2-fsdp2", 1, 769, 16, 1, None, 968))


def tp_training_times(tfa, dev, card: str, tpt: dict, errs: dict) -> list[dict]:
    """The training kernels at a tensor rank's heads, bf16, S = T: the 1B's
    8 over its one KV head at its step's B=4, T=769 (tensor 2) and the 8B's
    9 over 1 at B=1, T=4700 past the 4096 window (tensor 4), and at a
    pipeline stage's microbatch (the 1B's 16 over 1 at B=1, T=769), each beside its
    plain version, its bound and SDPA with enable_gqa (the window as an
    explicit mask; the backward against dkdv + dq). The kernels are
    graph-replayed (10 calls a graph); the plain versions and SDPA's
    backward run eager between CUDA events (3 after 3 of warm-up), in turns
    plain, kernel, kernel, plain. Returns the kernels' JSON rows, their
    launches every rank's in phase 5g (`tpt`)."""
    g = torch.Generator(device=dev).manual_seed(23)
    graphed, timer = functools.partial(cuda_ms, iters=10), functools.partial(event_ms, iters=3)
    D, rows = 128, []
    for sfx, case, B, T, H, Hkv, W, bwd_row in TP_TRAIN_TIMES:
        q = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, window=W)
        delta = tfa.attention_delta(out, do)
        shape = f"B={B} S=T={T} H={H} Hkv={Hkv} D={D}{'' if W is None else f' window={W}'} bf16"
        pos = torch.arange(T, device=dev)
        pairs = B * H * int(torch.minimum(pos + 1, torch.full_like(pos, W or T)).sum())
        qh, doh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, do, k, v))
        sdpa = dict(causal=True) if W is None else dict(
            causal=False, attn_mask=_sdpa_window(T, W, dev))
        lib_fwd = sdpa_ms(qh, kh, vh, enable_gqa=True, **sdpa)
        lib_bwd = sdpa_backward_ms(qh, kh, vh, doh, iters=3, enable_gqa=True,
                                   mask=None if W is None else {"attn_mask": sdpa["attn_mask"]})
        del qh, kh, vh, doh, sdpa
        torch.cuda.empty_cache()
        act, kv, stats, m = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4, B * T * 4
        for name, fn, replaces, nbytes, flops, lib in (
                ("flash_prefill_with_lse", lambda kn: tfa.flash_prefill_with_lse(
                    q, k, v, mask, window=W, kernels=kn), 330 if W is None else 307,
                 2 * act + 2 * kv + stats + m, 4 * D * pairs, lib_fwd),
                ("flash_bwd_dkdv", lambda kn: tfa.flash_bwd_dkdv(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 2 * act + 4 * kv + 2 * stats + m, 8 * D * pairs, lib_bwd),
                ("flash_bwd_dq", lambda kn: tfa.flash_bwd_dq(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 3 * act + 2 * kv + 2 * stats + m, 6 * D * pairs, lib_bwd)):
            a = timer(lambda: fn(False))
            b, c = graphed(lambda: fn(True)), graphed(lambda: fn(True))
            plain_ms, ms = (a + timer(lambda: fn(False))) / 2, (b + c) / 2
            torch.cuda.empty_cache()
            b_ms, b_by = bound(nbytes, flops)
            log("times", f"{card}: {name} at phase 5g's {case} shape, {shape}: kernel "
                         f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the "
                         f"bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                         f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), SDPA (enable_gqa) "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
            src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
            rows.append(dict(name=f"{name}{sfx}", route="cuda",
                             source=f"starvector_tpu_torch/csrc/{src}",
                             replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                             launches=tpt[case]["launches"][name], max_abs_err=errs[name + sfx],
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def sdpa_backward_ms(q, k, v, do, iters: int = 20, mask: dict | None = None, **kw):
    """SDPA's backward on (B, H, S, D) queries over (B, H, T, D) keys,
    causal with the last query on the last key (lower right, which is top
    left when S = T), or under `mask` (SDPA's mask arguments; `kw` such as
    enable_gqa=True go to SDPA too): one autograd call giving dq, dk and dv.
    The faster of the backward of the backend SDPA dispatches to by itself
    and of its flash or memory-efficient backend, as sdpa_ms."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, T = q.shape[2], k.shape[2]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    mask = _sdpa_causal(S, T) if mask is None else mask
    times = []
    for fused in (False, True):
        try:
            with (sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])
                  if fused else contextlib.nullcontext()):
                out = F.scaled_dot_product_attention(qr, kr, vr, **mask, **kw)
        except RuntimeError as e:
            log("times", f"scaled_dot_product_attention at S={S}, T={T}"
                         f"{', flash/efficient' if fused else ''}: no backend "
                         f"({str(e).splitlines()[0][:160]})")
            continue
        times.append(library_ms(
            lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True),
            "scaled_dot_product_attention backward", timer=lambda fn: event_ms(fn, iters)))
        del out
    times = [t for t in times if t is not None]
    return min(times) if times else None


LONG_CASES = (  # the TPU backward variants' contracts that phase 3 drives: name, rows, B, S, T, H, q_offset
    ("8k context", "8 (one-pass tri)", 1, 8450, 8450, 16, 0),
    ("8k SP chunk, S=1024 at q_offset=7426", "4 (rect fwd), 7 (dq partials), 9 (one-pass)",
     1, 1024, 8450, 16, 7426),
    ("16k SP chunk, S=1024 at q_offset=15618", "12, 13 (split dq, dkv)", 1, 1024, 16642, 16, 15618),
    ("16k context, H=2", "10, 11 (split tri dq, dkv)", 1, 16642, 16642, 2, 0),
)


def long_context_times(tfa, dev, card: str) -> None:
    """The training kernels at the long-context contracts of the TPU's other
    backward variants (kernel table rows 4, 7-13), bf16: each kernel, the
    plain versions and SDPA (forward, and its backward against dkdv + dq),
    each beside its bound. The kernels and SDPA's forward are graph-replayed
    (10 kernel calls a graph); the plain versions and SDPA's backward run
    eager between CUDA events (3 after 3 of warm-up): each is tens of
    milliseconds to seconds of device work, and the plain version's
    (H, S, T) fp32 blocks are too large to capture several of in a graph."""
    g = torch.Generator(device=dev).manual_seed(12)
    D = 128
    timer, graphed = functools.partial(event_ms, iters=3), functools.partial(cuda_ms, iters=10)
    for name, rows, B, S, T, H, q_off in LONG_CASES:
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off)
        delta = tfa.attention_delta(out, do)
        t = {"fwd": graphed(lambda: tfa.flash_prefill_with_lse(q, k, v, mask, q_off)),
             "dkdv": graphed(lambda: tfa.flash_bwd_dkdv(q, k, v, mask, do, lse, delta, q_off)),
             "dq": graphed(lambda: tfa.flash_bwd_dq(q, k, v, mask, do, lse, delta, q_off)),
             "plain fwd": timer(lambda: tfa.flash_prefill_with_lse(q, k, v, mask, q_off,
                                                                   kernels=False)),
             "plain bwd": timer(lambda: tfa.flash_backward(q, k, v, mask, out, lse, do, q_off,
                                                           kernels=False))}
        torch.cuda.empty_cache()
        qh, doh = (x.transpose(1, 2).contiguous() for x in (q, do))
        kh, vh = (x.transpose(1, 2).expand(B, H, T, D).contiguous() for x in (k, v))
        t["SDPA fwd"] = sdpa_ms(qh, kh, vh, causal=True)
        t["SDPA bwd"] = sdpa_backward_ms(qh, kh, vh, doh, iters=3)
        pairs = B * H * (S * q_off + S * (S + 1) // 2)
        act, kv, stats, m = B * S * H * D * 2, B * T * D * 2, B * H * S * 4, B * T * 4
        flops = {"fwd": 4 * D * pairs, "dkdv": 8 * D * pairs, "dq": 6 * D * pairs}
        bounds = {"fwd": bound(2 * act + 2 * kv + stats + m, flops["fwd"]),
                  "dkdv": bound(2 * act + 4 * kv + 2 * stats + m, flops["dkdv"]),
                  "dq": bound(3 * act + 2 * kv + 2 * stats + m, flops["dq"])}
        log("times", f"{card}: long context {name} (kernel table rows {rows}), B={B} H={H} "
                     f"Hkv=1 D=128 bf16: " + ", ".join(
                         f"{k_} {'n/a' if v_ is None else f'{v_:.3f} ms'}" for k_, v_ in t.items())
                     + "; bounds " + ", ".join(f"{k_} {b_[0]:.4f} ms ({b_[1]})"
                                               for k_, b_ in bounds.items())
                     + "; kernels " + ", ".join(
                         f"{k_} {flops[k_] / t[k_] / 1e9:.1f} TFLOP/s ({bounds[k_][0] / t[k_]:.1%} "
                         "of the bound)" for k_ in bounds))
        del q, k, v, do, out, lse, delta, qh, kh, vh, doh
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5g: tensor- and pipeline-parallel training (parallel/tensor.py and
# parallel/pipeline.py under autograd)
# ---------------------------------------------------------------------------

TPT_WORLD = 4       # each case's ranks, each a process on the one card
TPT_STEPS = 2
TPT_TIMEOUT = 900   # seconds the ranks may take before the phase fails
# decoder layers of each case: the 1B's 4 of 24 (2 a stage on the stage
# mesh; cut from 8 to pay for the stage case), the 8B's 2 of 32 (its fp32
# check's, phase 6b)
TPT_LAYERS = {"1b": 4, "8b": 2}
# name, model, mesh, optimizer, svg lengths (B rows), remat, the heads a rank's
# training kernels run at (H, Hkv); the 8B's one row of 4124 svg tokens makes
# T = 576 + 4124 = 4700, past the window (phase 6b's SVG_8B_FP32)
TPT_CASES = (
    ("1b-fsdp2-tp2", "1b", dict(fsdp=2, tensor=2), "adamw", SVG_LENGTHS, "dots_flash", (8, 1)),
    ("1b-stage2-fsdp2", "1b", dict(fsdp=2, stage=2), "adamw", SVG_LENGTHS, "dots_flash",
     (16, 1)),
    ("8b-tp4", "8b", dict(fsdp=1, tensor=4), "adafactor", (4124,), "dots_flash", (9, 1)),
)


def tpt_plan(axes: dict, lengths) -> tuple[int, int, int]:
    """(microbatches, rows a launch, stages) of a case's rank: its batch
    coordinate's rows, split into the pipeline's microbatches on a stage
    mesh (parallel/pipeline.py::micro_count)."""
    from starvector_tpu_torch.parallel.pipeline import micro_count

    stage = axes.get("stage", 1)
    rows = len(lengths) // math.prod(axes.get(a, 1) for a in ("replica", "data", "fsdp"))
    nm = micro_count(rows, stage) if stage > 1 else 1
    return nm, rows // nm, stage
# AdamW at eps 1e-6 (an element whose gradient is fp32 summation noise,
# ~1e-9, moves by lr x 1e-3, not by lr x its sign), Adafactor at the 6c lr
TPT_OPT = {"adamw": dict(lr=1e-4, warmup_steps=0, betas=(0.95, 0.999), eps=1e-6,
                         weight_decay=1e-6, grad_clip=1.0, total_steps=100_000),
           "adafactor": dict(optimizer="adafactor", lr=1e-3, warmup_steps=0, grad_clip=1.0,
                             total_steps=100_000)}


def tpt_config(sv, model: str):
    """The case's config: the 1B or the 8B at full width, its decoder cut
    to TPT_LAYERS."""
    import dataclasses

    if model == "8b":
        return config_8b(sv, TPT_LAYERS["8b"])
    cfg = sv.starvector_1b_config()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layer=TPT_LAYERS["1b"]))


def tpt_steps(sv, cfg, params, batch, opt_kw: dict, remat, layout=None) -> dict:
    """TPT_STEPS fp32 train steps of the port with the kernels, on `params`
    (this rank's shards on a layout) and the rows `batch` gives this rank:
    each step's loss, grad norm and wall seconds."""
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import build_optimizer
    from starvector_tpu_torch.train.step import make_train_step, mark_trainable
    from starvector_tpu_torch.train.train import rank_rows

    mark_trainable(params)
    opt = build_optimizer(params, **opt_kw)
    state = opt.init(params)
    step = make_train_step(cfg, opt, 0, policy=DTypePolicy(torch.float32, torch.float32),
                           remat=remat)
    rows = rank_rows(batch, layout)
    out = {"losses": [], "norms": [], "seconds": []}
    for _ in range(TPT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, rows, None)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        out["seconds"].append(time.perf_counter() - t)
    return out | {"params": params}


@contextlib.contextmanager
def launch_heads(tfa):
    """({kernel: {(H, Hkv) of each launch}}, {kernel: {B of each launch}})
    of the three training kernels while within (the wrappers replaced in
    the module as launch_offsets replaces them)."""
    real = {name: getattr(tfa, name) for name in TRAIN_KERNELS}
    seen = {name: set() for name in TRAIN_KERNELS}
    rows = {name: set() for name in TRAIN_KERNELS}

    def wrapped(name):
        fn = real[name]

        def call(q, k, *args, **kw):
            before = call.launches
            out = fn(q, k, *args, **kw)
            if call.launches > before:
                seen[name].add((int(q.shape[2]), int(k.shape[2])))
                rows[name].add(int(q.shape[0]))
            return out

        call.launches = fn.launches
        return call

    for name in TRAIN_KERNELS:
        setattr(tfa, name, wrapped(name))
    try:
        yield seen, rows
    finally:
        for name, fn in real.items():
            fn.launches = getattr(tfa, name).launches
            setattr(tfa, name, fn)


def _tpt_case(sv, tfa, run, shared: dict, dev) -> dict:
    """One case of phase 5g on this rank: its shards of the shared initial
    weights (copies: no rank writes the main process's tensors), TPT_STEPS
    steps on its rows, and the parameters after them gathered whole leaf by
    leaf and held, on rank 0, to one process's within fp32 TOL."""
    import torch.distributed as dist

    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, zero
    from starvector_tpu_torch.train.optim import tree_leaves, tree_map

    name, model, axes, opt, _, remat, _ = run
    cfg = tpt_config(sv, model)
    torch.cuda.reset_peak_memory_stats()
    layout = zero.Layout(create_mesh(MeshConfig(**axes), device_type="cpu"))
    params = sv.shard_params(shared["init"], cfg, layout)
    params = tree_map(lambda t: t if zero.sharded(t) is not None
                      else zero.register_like(t.detach().clone(), t), params)
    reset_counts(tfa)
    with launch_heads(tfa) as (heads, rows):
        res = tpt_steps(sv, cfg, params, shared["batch"], TPT_OPT[opt], remat, layout)
    res.update(counts={k: read_counts(tfa)[k] for k in TRAIN_KERNELS},
               heads={k: sorted(v) for k, v in heads.items()},
               rows={k: sorted(v) for k, v in rows.items()},
               micro=tpt_plan(axes, run[4])[0], peak=torch.cuda.max_memory_allocated())
    atol, rtol = TOL[torch.float32]
    worst, bad = 0.0, []
    for leaf, ref in zip(tree_leaves(res.pop("params")), tree_leaves(shared["ref"])):
        whole = zero.full_tree(leaf)
        if dist.get_rank() == 0:
            worst = max(worst, (whole - ref).abs().max().item())
            if not torch.allclose(whole, ref, atol=atol, rtol=rtol):
                bad.append(tuple(whole.shape))
        del whole
    res.update(worst=worst, bad=bad)
    return res


def _tpt_rank(rank: int, port: int, inbox, results) -> None:
    """A rank of phase 5g, a process of its own on the one card: joins a
    gloo group of TPT_WORLD ranks (NCCL takes one rank a card), then runs
    each of TPT_CASES (_tpt_case) on the weights and batch the main process
    shares through the queue (CUDA IPC). Puts (rank, results) or (rank,
    the error) on `results`."""
    import traceback

    import torch.distributed as dist

    try:
        shared = inbox.get(timeout=TPT_TIMEOUT)
        dev = next(iter(shared.values()))["batch"]["svg_ids"].device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=TPT_WORLD)
        from starvector_tpu_torch.models import starvector as sv
        from starvector_tpu_torch.ops import flash_attention as tfa
        from starvector_tpu_torch.ops import kernel_lib

        kernel_lib.library()
        torch.backends.cuda.matmul.allow_tf32 = False
        out = {}
        for run in TPT_CASES:
            t = time.perf_counter()
            out[run[0]] = _tpt_case(sv, tfa, run, shared[run[0]], dev)
            out[run[0]]["wall"] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        del shared
        gc.collect()
        results.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the main process reports it and stops the others
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def tensor_training(sv, tfa, dev, card: str, clip_images) -> dict:
    """Phase 5g: train.step on a mesh with tensor or stage above 1,
    TPT_WORLD gloo ranks on the one card (_tpt_rank), against one process
    on the same card, weights and batch, both with the kernels, fp32.
    1b-fsdp2-tp2 and 1b-stage2-fsdp2: StarVector-1B at full width, the
    first TPT_LAYERS["1b"] of its 24 decoder layers, the whole CLIP
    ViT-L/14 and the BatchNorm adapter, AdamW, dots_flash, B=4, T=769 (one
    reference for both); 8b-tp4: StarVector-8B at full width, 2 of its 32
    decoder layers, SigLIP-L/16 and the LayerNorm adapter, Adafactor,
    dots_flash, B=1, T=4700 past the window. Each step's loss and grad norm
    within rtol 1e-4 of one process's, the parameters after TPT_STEPS steps
    gathered whole within fp32 TOL; each rank's launches a step: one
    forward-with-lse and one backward pair a decoder layer of its own a
    microbatch (tpt_plan), at the case's heads and rows. One process's
    reference runs first, and its state goes before the ranks start; the
    ranks' walls are gloo's. Returns the launches, the heads and the walls
    by case."""
    import socket

    import torch.multiprocessing as mp

    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.train.optim import tree_map
    from starvector_tpu_torch.train.train import to_device

    t0 = time.perf_counter()
    shared, refs = {}, {}
    for run in TPT_CASES:
        name, model, axes, opt, lengths, remat, _ = run
        same = next((r[0] for r in TPT_CASES if r[0] in shared
                     and (r[1], r[3], r[4], r[5]) == (model, opt, lengths, remat)), None)
        if same is not None:  # the same model, weights, batch and recipe: one reference
            shared[name], refs[name] = shared[same], refs[same]
            continue
        cfg = tpt_config(sv, model)
        images = clip_images if model == "1b" else processor_for_encoder(
            cfg.image_encoder_type, cfg.image_size, device=dev).batch
        batch = to_device(training_batch(cfg, images, dev, seed=5, lengths=lengths), dev)
        init = sv.init_params(cfg, torch.Generator(device=dev).manual_seed(22), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(tfa)
        ref = tpt_steps(sv, cfg, tree_map(lambda t: t.clone(), init), batch, TPT_OPT[opt], remat)
        ref["counts"] = {k: read_counts(tfa)[k] for k in TRAIN_KERNELS}
        ref["peak"] = torch.cuda.max_memory_allocated() - base
        shared[name] = dict(init=init, batch=batch, ref=tree_map(
            lambda t: t.detach(), ref.pop("params")))
        refs[name] = ref
        gc.collect()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0

    ctx = mp.get_context("spawn")
    results, inbox = ctx.Queue(), ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=_tpt_rank, args=(r, port, inbox, results))
             for r in range(TPT_WORLD)]
    t1 = time.perf_counter()
    for proc in procs:
        proc.start()
        inbox.put(shared)
    ranks: dict[int, dict] = {}
    try:
        deadline = time.monotonic() + TPT_TIMEOUT
        while len(ranks) < TPT_WORLD:
            try:
                rank, res = results.get(timeout=5)
            except Exception:  # noqa: BLE001 — queue.Empty: look at the processes
                if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(f"phase 5g: ranks {sorted(ranks)} reported, exit codes "
                                         f"{[p.exitcode for p in procs]}")
                continue
            if "error" in res:
                raise AssertionError(f"phase 5g: rank {rank} failed:\n{res['error']}")
            ranks[rank] = res
        for proc in procs:
            proc.join(timeout=60)
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 5g: exit codes {[p.exitcode for p in procs]}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        del shared
        gc.collect()
        if dev.type == "cuda":  # the blocks the ranks held through CUDA IPC, released by them
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
    t_ranks = time.perf_counter() - t1

    out = {}
    for name, model, axes, opt, lengths, remat, heads in TPT_CASES:
        ref, L = refs[name], TPT_LAYERS[model]
        nm, per_launch, stages = tpt_plan(axes, lengths)
        per_step = dict.fromkeys(TRAIN_KERNELS, L // stages * nm * TPT_STEPS)
        for r, res in sorted(ranks.items()):
            got = res[name]
            for what in ("losses", "norms"):
                if not np.allclose(got[what], ref[what], rtol=1e-4, atol=0):
                    raise AssertionError(f"5g {name} rank {r}: {what} {got[what]}, one process "
                                         f"{ref[what]}")
            if got["counts"] != per_step or any(v != [heads] for v in got["heads"].values()) \
                    or any(v != [per_launch] for v in got["rows"].values()):
                raise AssertionError(f"5g {name} rank {r}: launches {got['counts']} at heads "
                                     f"{got['heads']} and rows {got['rows']}, expected "
                                     f"{per_step} at {heads} and {per_launch}")
        if ref["counts"] != dict.fromkeys(TRAIN_KERNELS, L * TPT_STEPS):
            raise AssertionError(f"5g {name} one process: launches {ref['counts']}")
        lead = ranks[0][name]
        if lead["bad"]:
            raise AssertionError(f"5g {name}: parameters after {TPT_STEPS} steps beyond fp32 TOL "
                                 f"(leaves of shapes {lead['bad'][:8]}; max |diff| "
                                 f"{lead['worst']:.3e})")
        T = max(lengths) + (257 if model == "1b" else 576)
        log("train", f"5g {name} ({TPT_WORLD} gloo ranks on one card, mesh {axes}; {model.upper()} "
                     f"at full width, {L} decoder layers, fp32, {opt}, {remat}, B={len(lengths)} "
                     f"T={T}): losses {lead['losses']} (one process {ref['losses']}), grad norms "
                     f"{lead['norms']} (one process {ref['norms']}), rtol 1e-4 on every rank; "
                     f"parameters after {TPT_STEPS} steps gathered whole: max |diff| "
                     f"{lead['worst']:.3e} (fp32 TOL atol=rtol 1e-4); microbatches a rank "
                     f"{[ranks[r][name]['micro'] for r in sorted(ranks)]}; launches a rank "
                     f"{lead['counts']} = {L // stages} layers x {nm} microbatches x {TPT_STEPS} "
                     f"steps at (H, Hkv) {heads}, B={per_launch}; peak "
                     f"memory a rank (GiB) {[round(ranks[r][name]['peak'] / 2**30, 2) for r in sorted(ranks)]}"
                     f", one process {ref['peak'] / 2**30:.2f} GiB above what was held; step wall "
                     f"(s, gloo's) rank 0 {[round(x, 2) for x in lead['seconds']]}, one process "
                     f"{[round(x, 2) for x in ref['seconds']]}; the case {lead['wall']:.1f} s a rank")
        out[name] = dict(launches={k: sum(ranks[r][name]["counts"][k] for r in ranks)
                                   for k in TRAIN_KERNELS},
                         per_rank=lead["counts"], heads=heads, micro=nm, wall=lead["wall"])
    log("phase", f"5g took {time.perf_counter() - t0:.0f} s: one-process references "
                 f"{t_ref:.0f} s, the ranks {t_ranks:.0f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: StarVector-8B inference at full width
# ---------------------------------------------------------------------------

PREFIX_8B = 4700  # the window check's prefix, past the 4096-key window
# the depths of earlier slices' paths, at full width: eager decoding is
# host-bound, so their wall time goes with the layers, and at full depth
# the script passed its 1200-s limit on a slow host (phase 6 alone took
# 200-400 s at all 32 layers)
DEPTH_1B_EARLIER = 8  # of 24: 4b's decoding variants, 4c's serving, 4d's eval, 4e's streams
DEPTH_8B = 8  # of 32: phase 6's 8B inference


def first_layers(params: dict, cfg, n: int):
    """(params, cfg) of the model cut to its decoder's first n layers (views
    of the same weights, which keep the whole tree's storage alive)."""
    import dataclasses

    st = dict(params["svg_transformer"])
    st["layers"] = _map_tree(st["layers"], lambda t: t[:n])
    depth = "num_hidden_layers" if hasattr(cfg.llm, "num_hidden_layers") else "n_layer"
    return ({**params, "svg_transformer": st},
            dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **{depth: n})))


def slice_8b(sv, tfa, dev, card: str, profile_dir: Path | None = None) -> dict:
    """StarVector-8B im2svg at full width (StarCoder2-7B: 4608 wide, 36
    query heads over 4 KV heads, window 4096; SigLIP-L/16 at 384; LayerNorm
    adapter) and the first DEPTH_8B of its 32 decoder layers, on random bf16
    weights drawn on the card by StarVectorForCausalLM.from_config from a
    seed, projections scaled as in phase 4. 3 requests of 4 images through
    generate_im2svg_ids with exact launch counts (a flash_prefill a layer a
    prefill, a decode_attention a layer a step, no training or int8
    kernel); bf16 prefill logits against the fp32 plain ones and fp32 greedy
    ids, kernels against plain, on an fp32 copy of the same layers; the
    window at full width (2 layers,
    a 4700-token prefix, 32 greedy tokens, fp32 ids kernels == plain); then
    p50 latency, B=4 tokens/s and memory (with `profile_dir`, where a B=4
    request's device time goes). Returns the launch counts, p50, tokens/s
    and the tree's bytes."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = config_8b(sv, DEPTH_8B)
    L = cfg.llm.num_hidden_layers
    depth = f"{L} of {sv.starvector_8b_config().llm.num_hidden_layers} layers (DEPTH_8B)"
    model = StarVectorForCausalLM.from_config(cfg, seed=8, dtype=torch.bfloat16, device=dev)
    p16 = scale_projections(model.params)
    torch.cuda.synchronize()
    parts = {k: tree_bytes(v) / 2**30 for k, v in p16.items()}
    log("8b", f"StarVector-8B (StarCoder2-7B {cfg.llm.hidden_size} wide, {depth}, "
              f"{cfg.llm.num_attention_heads} heads over {cfg.llm.kv_heads}, window "
              f"{cfg.llm.sliding_window}; {cfg.image_encoder_type}; {cfg.adapter_norm} adapter) "
              f"from_config(seed=8) in bf16 on the card: weights "
              f"{tree_bytes(p16) / 2**30:.2f} GiB ("
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f"), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing them, "
              f"{held / 2**30:.2f} GiB held before")

    request = api_requester(model)
    request(synthetic_images(4, 99), max_new_tokens=8)  # warm-up: cuBLAS handles, allocator
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    steps = [decode_steps(tokens, lengths) for tokens, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or \
                int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"8B: bad tokens {tuple(tokens.shape)} [{tokens.min()}, "
                                 f"{tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"8B: bad lengths {lengths.tolist()}")
    expected = {"flash_prefill": L * 3, "decode_attention": L * sum(steps),
                "decode_attention_int8": 0, "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"8B launches {got}, expected {expected}")
    distinct = [len(set(row.tolist())) for tokens, _, _ in served for row in tokens]
    log("8b", f"3 requests x 4 images, greedy, 128 new tokens: decode steps {steps}, lengths "
              f"{[l.tolist() for _, l, _ in served]}, distinct ids per row {distinct}; launches "
              f"flash_prefill {got['flash_prefill']} = {L} x 3 prefills, decode_attention "
              f"{got['decode_attention']} = {L} x {sum(steps)} decode steps, no training or int8 "
              f"kernel ({graph_tally()})")

    # fp32 on a copy of the same weights
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    p32, cfg32 = _cast_tree(p16, torch.float32), cfg
    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg32, images, prompt, policy=policy)
        cache = starcoder2.init_cache(cfg32.llm, 4, emb.shape[1], dtype=policy.compute_dtype,
                                      device=dev)
        return starcoder2.forward(params["svg_transformer"], cfg32.llm, emb, mask, cache=cache,
                                  policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(p32, f32, False)
    logits = {k: prefill_logits(p16, bf16, k) for k in (True, False)}
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"8B bf16 prefill logits: kernels {err_k:.3e} from fp32, over twice "
                             f"the plain version's {err_p:.3e}")
    log("8b", f"bf16, B=4, {depth}: prefill last-position logits from the fp32 plain "
              f"logits (max |logit| {ref32.abs().max().item():.3e}): kernels {err_k:.4e}, plain "
              f"{err_p:.4e} (bound: kernels <= 2 x plain + 1e-3)")
    del logits, ref32
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg32, policy=f32, device=dev, kernels=kernels)
        _, ids[kernels], _ = m32.generate_im2svg_ids(
            {"image": images[:2]}, **{**GREEDY, "prompt_ids": [PROMPT_IDS] * 2,
                                      "max_new_tokens": 32})
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"8B fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    _, uncaptured, _ = StarVectorForCausalLM(p32, cfg32, policy=f32, device=dev,
                                             cuda_graphs=False).generate_im2svg_ids(
        {"image": images[:2]}, **{**GREEDY, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32})
    if not torch.equal(ids[True], uncaptured):
        raise AssertionError(f"8B fp32 greedy ids, graphed {ids[True].tolist()} != uncaptured "
                             f"{uncaptured.tolist()}")
    log("8b", f"fp32, B=2, 32 tokens, {depth}: greedy ids with the kernels, the decode steps "
              f"replayed as CUDA graphs == the same steps uncaptured (cuda_graphs=False), bit "
              f"for bit, == with the plain attention "
              f"({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row)")
    steps_8b = step_times(card, f"8B bf16 ({depth})", p16["svg_transformer"], cfg.llm,
                          *im2svg_prefix(p16, cfg, model.process_images(synthetic_images(4, 61)),
                                         prompt, policy=bf16), bf16)

    # text2svg: captions through the v2 test tokenizer, the same bf16 weights;
    # its fp32 check on the fp32 copy above
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

    t2s = text2svg_slice(tfa, "8B", StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v2"),
                                                          policy=model.policy, device=dev),
                         p32, cfg32, dev, depth)
    decoding_8b(tfa, model, cfg, p16, p32, cfg32, dev, depth, card)
    t_pipe = time.perf_counter()
    pipe_8b = pipelined_8b(tfa, model, cfg, p16, p32, cfg32, dev, card, depth)
    log("phase", f"6 (StarVector-8B pipelined generation) took "
                 f"{time.perf_counter() - t_pipe:.0f} s")
    t_6d = time.perf_counter()
    serve_8b = serving_8b(tfa, model, cfg, p16, p32, cfg32, dev, card, depth)
    log("phase", f"6d (StarVector-8B continuous-batching serving) took "
                 f"{time.perf_counter() - t_6d:.0f} s")
    tp_8b = tensor_serving(sv, tfa, model, cfg, p16, p32, dev, card, depth)
    del m32, p32
    torch.cuda.empty_cache()

    # the window at full width: 2 layers, a prefix past 4096 keys, fp32
    q2, cfg2 = first_layers(p16, cfg, 2)
    p2 = _cast_tree(q2, torch.float32)
    n_visual = cfg.encoder_config.geometry[1]
    long_ids = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.llm.vocab_size, (2, PREFIX_8B - n_visual))).to(dev)
    emb, mask = im2svg_prefix(p2, cfg2, model.process_images(synthetic_images(2, 17)), long_ids,
                              policy=f32)
    gen = GenerationConfig(max_new_tokens=32, do_sample=False, stop_sequences=(),
                           eos_token_id=None, pad_token_id=0)
    win = {}
    for kernels in (True, False):
        reset_counts(tfa)
        win[kernels] = generate(p2["svg_transformer"], cfg2.llm, emb, mask, gen, policy=f32,
                                kernels=kernels)[0]
        if kernels:
            win_counts = read_counts(tfa)
    if not torch.equal(win[True], win[False]):
        raise AssertionError(f"8B window: fp32 greedy ids differ:\n{win[True].tolist()}\n"
                             f"{win[False].tolist()}")
    if (win_counts["flash_prefill"], win_counts["decode_attention"]) != (2, 2 * 31):
        raise AssertionError(f"8B window launches {win_counts}")
    log("8b", f"the window at full width, fp32, 2 layers, B=2: a {PREFIX_8B}-token prefix "
              f"({n_visual} visual + {PREFIX_8B - n_visual} prompt ids), past "
              f"the {cfg.llm.sliding_window}-key window, then 32 greedy tokens (decode steps see "
              f"slots from {PREFIX_8B - cfg.llm.sliding_window + 1} on): ids with the kernels "
              f"== with the plain attention ({[len(set(r.tolist())) for r in win[True]]} "
              f"distinct ids per row; launches flash_prefill {win_counts['flash_prefill']}, "
              f"decode_attention {win_counts['decode_attention']} = 2 x 31)")
    del p2, q2, emb, mask
    torch.cuda.empty_cache()

    e2e = None
    if TIMINGS:
        t_times = time.perf_counter()
        e2e = serving_times(card, {"8B bf16": request, "8B text2svg": t2s["request"]})
        log("times", f"{card}: 8B text2svg (prompts of 6-30 tokens, no vision tower) against "
                     f"im2svg, bf16: p50 B=1 {e2e['8B text2svg']['p50'] * 1e3:.1f} vs "
                     f"{e2e['8B bf16']['p50'] * 1e3:.1f} ms, B=4 decode "
                     f"{e2e['8B text2svg']['rate']:.1f} vs {e2e['8B bf16']['rate']:.1f} tokens/s")
        memory_times(card, {"8B bf16": request}, {"8B bf16": p16})
        e2e = e2e["8B bf16"]
        timed_only("phase 6's serving and memory turns", t_times)
    if profile_dir is not None:
        profile_request(request, card, profile_dir, "8b")
    out = dict(counts=got, weights=tree_bytes(p16), serve=serve_8b, pipelined=pipe_8b, tp=tp_8b,
               steps=steps_8b)
    del request, served, t2s
    out["int8"] = int8_slice_8b(model, tfa, cfg, p16, dev, card, e2e, depth, profile_dir)
    del model, p16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decoding_8b(tfa, model, cfg, p16, p32, cfg32, dev, depth: str, card: str) -> None:
    """Phase 6's decoding variants on the 8B's bf16 tree (full width,
    `depth`) and its fp32 copy: beam search,
    num_beams=2 at B=1 through the API (flash_prefill once a layer over
    B x K = 2 rows, decode_attention at G = 9 once a layer a step), fp32 ids
    kernels == plain; speculative decoding at B=1 and B=4 through the API
    (flash_prefill only: every verify is the chunk step, B=4's through
    StarCoder2's forward_ragged_verify), then speculative_checks."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.num_hidden_layers
    f32 = DTypePolicy(torch.float32, torch.float32)
    request = api_requester(model)
    one = synthetic_images(1, 61)
    request(one, num_beams=2, max_new_tokens=4, prompt_ids=[PROMPT_IDS])  # warm-up
    reset_counts(tfa)
    with BatchSpy(starcoder2) as spy:
        tokens, lengths, secs = request(one, num_beams=2, prompt_ids=[PROMPT_IDS])
    counts = read_counts(tfa)
    steps = len(spy.rows) - 1
    expect_counts("8B beam", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [2] * (steps + 1) or not int(lengths.max()) - 1 <= steps <= 127:
        raise AssertionError(f"8B beam: forwards at rows {spy.rows}, lengths {lengths.tolist()}")
    x1 = model.process_images(one)
    ids = {k: StarVectorForCausalLM(p32, cfg32, policy=f32, device=dev, kernels=k)
           .generate_im2svg_ids({"image": x1}, num_beams=2, **{
               **GREEDY, "prompt_ids": [PROMPT_IDS], "max_new_tokens": 32})[1:]
           for k in (True, False)}
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"8B beam fp32 ids differ:\n{ids[True]}\n{ids[False]}")
    log("decoding", f"8B beam search, num_beams=2, B=1, 128 new tokens, bf16: length "
                    f"{int(lengths[0])}, {steps + 1} forwards at B x K = 2 rows, "
                    f"{secs * 1e3:.1f} ms; launches flash_prefill {counts['flash_prefill']} = {L} "
                    f"x 1, decode_attention (G = 9) {counts['decode_attention']} = {L} x {steps}; "
                    f"fp32, 32 tokens, {depth}: ids and lengths with the kernels == plain")
    four = synthetic_images(4, 62)
    for B in (1, 4):
        request(four[:B], max_new_tokens=4, prompt_ids=[PROMPT_IDS] * B, use_speculative=True)
        reset_counts(tfa)
        request(four[:B], prompt_ids=[PROMPT_IDS] * B, use_speculative=True)
        expect_counts(f"8B speculative B={B}", read_counts(tfa), flash_prefill=L)
    log("decoding", f"8B speculative decoding through the API, bf16, B=1 and B=4, 128 new "
                    f"tokens: launches flash_prefill {L} a request, no decode_attention")
    speculative_checks(tfa, "8B", cfg, p16, model.policy, cfg32, p32, f32,
                       model.process_images(four), torch.tensor([PROMPT_IDS] * 4, device=dev),
                       card)


PIPE_8B_NEW = 32  # new tokens of the 8B's checked pipelined runs


def pipelined_8b(tfa, model, cfg, p16, p32, cfg32, dev, card: str, depth: str) -> dict:
    """Phase 6's offline pipelined generation on the 8B's bf16 tree (full
    width, `depth`) and its fp32 copy: StarCoder2 has no fused forward, so
    while a batch carries chunks each step is the static decode step
    (kernel 2 at G = 9, its key bounds on the device) and then the next
    prompt's chunk through the static chunk step (the window in its device
    mask), one CUDA graph a step kind and key bucket. Batches of B=2 im2svg
    prefixes, 32 greedy new tokens (C = 19): fp32, 2 batches, ids and
    lengths graphed == uncaptured (cuda_graphs=False) bit for bit with the
    same launches, == per-batch generate's and the plain attention's; bf16,
    3 batches: launches exactly a flash_prefill a layer (batch 0) and a
    decode_attention a layer a decode step (pipelined_steps), the graphs
    captured no more than a 2-batch stream's (the loop line's, loop_times);
    generate_pipelined_spec raises the port's NotImplementedError; with
    --timings, tokens/s of serial per-batch generate and generate_pipelined
    in turns (a, b, b, a) at 3 batches of B=4, 128 new tokens. Returns the
    bf16 launches, the line and the rates (None without --timings)."""
    from starvector_tpu_torch.generation import engine, speculative
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.num_hidden_layers
    f32, bf16 = DTypePolicy(torch.float32, torch.float32), model.policy

    def prefixes(params, c, policy, n, B, seed):
        out = []
        for i in range(n):
            x = model.process_images(synthetic_images(B, seed + i))
            prompt = torch.tensor([PROMPT_IDS] * B, device=dev)
            out.append(engine.im2svg_prefix(params, c, x, prompt, policy=policy))
        return out

    def gen(n):
        return engine.GenerationConfig(max_new_tokens=n, do_sample=False,
                                       stop_sequences=STOP_IDS, eos_token_id=None,
                                       pad_token_id=0)

    def counted(fn):
        reset_counts(tfa)
        out = fn()
        return out, read_counts(tfa)

    d32, d16 = p32["svg_transformer"], p16["svg_transformer"]
    b32 = prefixes(p32, cfg32, f32, 2, 2, 71)
    out, counts = counted(lambda: engine.generate_pipelined(d32, cfg32.llm, b32, gen(PIPE_8B_NEW),
                                                            policy=f32))
    unc, unc_counts = counted(lambda: engine.generate_pipelined(
        d32, cfg32.llm, b32, gen(PIPE_8B_NEW), policy=f32, cuda_graphs=False))
    same_ids("8B pipelined fp32, graphed against uncaptured", out, unc)
    if counts != unc_counts:
        raise AssertionError(f"8B pipelined fp32: launches graphed {counts} != uncaptured "
                             f"{unc_counts}")
    same_ids("8B pipelined fp32 against per-batch generate", out,
             [engine.generate(d32, cfg32.llm, e, m, gen(PIPE_8B_NEW), policy=f32)
              for e, m in b32])
    same_ids("8B pipelined fp32, kernels against plain", out,
             engine.generate_pipelined(d32, cfg32.llm, b32, gen(PIPE_8B_NEW), policy=f32,
                                       kernels=False))
    P = b32[0][0].shape[1]
    C, n_chunks = engine._chunk_plan(P, PIPE_8B_NEW, None)
    del b32
    b16 = prefixes(p16, cfg, bf16, 3, 2, 71)

    def stream(bs, graphed=True):
        return engine.generate_pipelined(d16, cfg.llm, bs, gen(PIPE_8B_NEW), policy=bf16,
                                         cuda_graphs=graphed)

    reset_counts(tfa)
    out = stream(b16)
    n3, tally = graphs_captured(), graph_tally()
    steps = pipelined_steps(out, n_chunks, PIPE_8B_NEW)
    got = expect_counts("8B pipelined bf16", read_counts(tfa), flash_prefill=L,
                        decode_attention=L * steps["decode"])
    line = loop_times(card, f"8B generate_pipelined, bf16, 2 batches of B=2 prefixes of {P} "
                            f"tokens, {PIPE_8B_NEW} tokens, {depth}",
                      lambda g: stream(b16[:2], g),
                      lambda o: sum(pipelined_steps(o, n_chunks, PIPE_8B_NEW)[k]
                                    for k in ("fused", "decode_only")))
    n2 = line["graphed"]["captures"]
    if n3 != n2:
        raise AssertionError(f"8B pipelined bf16: a stream of 3 batches captured {n3} graphs, "
                             f"one of 2 {n2}")
    log("pipelined", f"8B generate_pipelined, B=2 prefixes of {P} tokens, {PIPE_8B_NEW} new "
                     f"tokens, C={C} ({n_chunks} chunks; no fused forward: each step the static "
                     f"decode step, then the static chunk step), as CUDA graphs: fp32, 2 batches, "
                     f"{depth}: ids and lengths == the uncaptured stream's (cuda_graphs=False) "
                     f"bit for bit with the same launches, == per-batch generate's and == the "
                     f"plain attention's; bf16, 3 batches: launches flash_prefill "
                     f"{got['flash_prefill']} = {L} x 1 (batch 0), decode_attention (G = 9) "
                     f"{got['decode_attention']} = {L} x {steps['decode']} decode steps "
                     f"({steps['fused']} with a chunk, {steps['decode_only']} alone); {tally}, "
                     f"{n2} captured for 2 batches")
    e, m = b16[0]
    ids = torch.full(m.shape, -1, dtype=torch.int64, device=dev)
    try:
        speculative.generate_pipelined_spec(d16, cfg.llm, [(e, m, ids)] * 2, gen(4), policy=bf16)
    except NotImplementedError as err:
        log("pipelined", f"8B generate_pipelined_spec raises NotImplementedError: {err}")
    else:
        raise AssertionError("8B generate_pipelined_spec ran without a fused verify forward")
    med = None
    if TIMINGS:
        t_times = time.perf_counter()
        b16 = prefixes(p16, cfg, bf16, 3, 4, 81)
        runs = {"serial generate": lambda: [engine.generate(d16, cfg.llm, e, m, gen(128),
                                                            policy=bf16) for e, m in b16],
                "generate_pipelined": lambda: engine.generate_pipelined(
                    d16, cfg.llm, b16, gen(128), policy=bf16)}
        rates = {k: [] for k in runs}
        for label in list(runs) + list(runs)[::-1]:
            res, wall = timed(runs[label])
            rates[label].append(sum(float(l.sum()) for _, l in res) / wall)
        med = {k: statistics.median(v) for k, v in rates.items()}
        log("times", f"{card}: 8B offline, {depth}, 3 batches of B=4 "
                     f"prefixes of {P} tokens, 128 greedy tokens, bf16, in turns (a, b, b, a), "
                     f"emitted tokens / wall: "
                     + "; ".join(f"{k} {med[k]:.1f} tokens/s ({[round(x, 1) for x in v]})"
                                 for k, v in rates.items())
                     + f"; pipelined / serial "
                       f"{med['generate_pipelined'] / med['serial generate']:.3f}")
        timed_only("phase 6's pipelined turns", t_times)
    return dict(launches=got, rates=med, captures=(n3, n2),
                line={k: {n: v for n, v in r.items() if n != "result"}
                      for k, r in line.items()})


def int8_slice_8b(model, tfa, cfg, p16, dev, card: str, bf16_e2e: dict, depth: str,
                  profile_dir: Path | None = None) -> dict:
    """StarVector-8B with int8 decoder weights and an int8 KV cache at full
    width and phase 6's `depth`: quantize_tree on the bf16 decoder,
    consuming it (each bf16 leaf goes once its codes exist, so the two trees
    never coexist beyond one leaf); requests of 4 images and of 1, greedy,
    128 new tokens, with exact launch counts (6 kernel-14 calls a layer a prefill, on the
    tile, and a decode step, on the GEMV; a flash_prefill a layer a prefill
    over the dequantized window; an int8-cache decode_attention a layer a
    step); fp32 compute over the same codes (the rest cast to fp32),
    kernels vs plain: greedy ids with an fp32 KV cache, and teacher-forced
    logits with the int8 cache (see below); weights and a request's peak
    above them; p50 and B=4 tokens/s beside the bf16 figures of the same
    call (with `profile_dir`, where a B=4 decode step's device time goes).
    Returns the launch counts, p50, tokens/s and the tree's bytes."""
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.ops.quantization import quantize_tree

    L = cfg.llm.num_hidden_layers
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    decoder16 = tree_bytes(p16["svg_transformer"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    q8 = {**p16, "svg_transformer": quantize_tree(p16["svg_transformer"])}
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t, torch.cuda.max_memory_allocated() - held
    layers = q8["svg_transformer"]["layers"]
    leaves = {f"{grp}.{name}": leaf for grp in ("attn", "mlp")
              for name, leaf in layers[grp].items()}
    if len(leaves) != 6 or not all("kernel_q" in leaf and "bias" in leaf
                                   for leaf in leaves.values()):
        raise AssertionError(f"8B int8: quantize_tree took {sorted(leaves)}")
    log("8b-int8", f"quantize_tree on the 8B decoder in {secs:.1f} s, consuming it: the six "
                   f"projections a layer ({', '.join(leaves)}) as int8 codes with ({L}, N) fp32 "
                   f"scales and their biases; decoder {decoder16 / 2**30:.2f} -> "
                   f"{tree_bytes(q8['svg_transformer']) / 2**30:.2f} GiB, all weights "
                   f"{tree_bytes(q8) / 2**30:.2f} GiB; peak {peak / 2**30:.2f} GiB above the "
                   f"{held / 2**30:.2f} GiB held before")

    request = int8_requester(model, cfg, q8, bf16, dev)
    request(synthetic_images(4, 99), max_new_tokens=8)  # warm-up
    reset_counts(tfa)
    served = [request(synthetic_images(4, 0)), request(synthetic_images(1, 1))]
    counts = read_counts(tfa)
    steps = [decode_steps(tokens, lengths) for tokens, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape[1] != 128 or int(tokens.min()) < 0 or \
                int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"8B int8: bad tokens {tuple(tokens.shape)}")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"8B int8: bad lengths {lengths.tolist()}")
    n = sum(steps)
    gemv = gemv_counts(tq, LAYER_SHAPES_8B, [(4, L * steps[0]), (1, L * steps[1])])
    expected = {"quant_matmul": 6 * L * (2 + n), **gemv,
                "quant_matmul_wgmma": 6 * L * 2, "quant_matmul_f32_tile": 0,
                "flash_prefill": L * 2, "decode_attention": L * n, "decode_attention_int8": L * n,
                **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"8B int8 launches {got}, expected {expected}")
    log("8b-int8", f"requests of 4 images and of 1, greedy, 128 new tokens: decode steps {steps}, "
                   f"lengths {[l.tolist() for _, l, _ in served]}; launches quant_matmul "
                   f"{got['quant_matmul']} = {6 * L} x (2 prefills + {n} decode steps) (wgmma tile "
                   f"{got['quant_matmul_wgmma']} at M = 4 x 580 and 580, tensor-core GEMV "
                   f"{got['quant_matmul_gemv_tc']} and GEMV pair {got['quant_matmul_gemv']} at "
                   f"M = 4 and 1), flash_prefill {got['flash_prefill']} = {L} x 2, "
                   f"int8-cache decode_attention {got['decode_attention_int8']} = {L} x {n}, no "
                   f"training kernel")

    # fp32 compute over the same codes and scales. With an fp32
    # KV cache: greedy ids, kernels against plain. With the int8 cache the
    # two paths' fp32 sums, which differ only in order, round some k/v to
    # the next code, and each flip moves the next layer's inputs by a scale
    # step, so flips grow layer by layer (tens in layer 0, a fifth of the
    # codes by layer 31 on the H100) and greedy ids over 32 tokens would
    # agree by chance; there the check is teacher-forced: both paths fed
    # the plain path's greedy ids, their logits within INT8_CACHE_LOGIT_TOL
    # at every step, and the same argmax wherever the plain path's top two
    # are further apart than twice that step's difference.
    q32 = _cast_tree(q8, torch.float32)
    ids = {k: int8_requester(model, cfg, q32, f32, dev, kernels=k,
                             kv_cache_dtype=torch.float32)(
        synthetic_images(2, 7), max_new_tokens=32)[0] for k in (True, False)}
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"8B int8 fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    emb, mask = im2svg_prefix(q32, cfg, model.process_images(synthetic_images(2, 7)),
                              torch.tensor([PROMPT_IDS] * 2, device=dev), policy=f32)
    tf, plain8 = {}, None
    for k in (False, True):
        tf[k], plain8 = forced_logits(starcoder2, q32["svg_transformer"], cfg.llm, emb, mask, 32,
                                      f32, k, torch.int8, plain8)
    diff = (tf[True] - tf[False]).abs().amax(-1)  # (B, 32)
    top2 = tf[False].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > 2 * diff
    agree = tf[True].argmax(-1) == tf[False].argmax(-1)
    if diff.max().item() > INT8_CACHE_LOGIT_TOL or not agree[clear].all():
        raise AssertionError(f"8B int8 cache, fp32, teacher-forced: max |logit diff| "
                             f"{diff.max().item():.3e} (limit {INT8_CACHE_LOGIT_TOL}), argmax "
                             f"differs at {int((~agree & clear).sum())} clear steps")
    log("8b-int8", f"fp32 compute over the same codes, B=2, 32 tokens, {depth}: "
                   f"with an fp32 KV cache greedy ids with the kernels == with the plain versions "
                   f"({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row); with "
                   f"the int8 cache, fed the plain path's greedy ids: max |logit diff| per step "
                   f"{diff.min().item():.4f}-{diff.max().item():.4f} (limit "
                   f"{INT8_CACHE_LOGIT_TOL}; max |logit| {tf[False].abs().max().item():.2f}), "
                   f"argmax equal at all {int(clear.sum())} of 64 steps whose top-2 margin is "
                   f"over twice it, and at {int(agree.sum())} of 64 in all")
    del q32, tf
    torch.cuda.empty_cache()

    if TIMINGS:
        t_times = time.perf_counter()
        memory_times(card, {"8B int8": request}, {"8B int8": q8})
        e2e = serving_times(card, {"8B int8": request}, rounds=1)["8B int8"]
        log("times", f"{card}: 8B int8 (weights and KV cache) against the 8B bf16 figures "
                     f"earlier in this call: p50 B=1 {e2e['p50'] * 1e3:.1f} vs "
                     f"{bf16_e2e['p50'] * 1e3:.1f} ms, B=4 decode {e2e['rate']:.1f} vs "
                     f"{bf16_e2e['rate']:.1f} tokens/s")
        timed_only("phase 6's int8 serving and memory turns", t_times)
    if profile_dir is not None:
        profile_request(request, card, profile_dir, "8b_int8")
    out = dict(counts=got, weights=tree_bytes(q8))
    del request, served, q8
    return out


# ---------------------------------------------------------------------------
# phase 6b: StarVector-8B training at full width, reduced depth
# ---------------------------------------------------------------------------

# 8 of the 32 decoder layers: AdamW's fp32 state at 16 bytes a parameter is
# ~120 GB for the whole 7.5 B, ~37 GB for the ~2.3 B of an 8-layer tree
TRAIN_8B_LAYERS = 8
# B = 1, T = 576 visual + 7616 svg tokens = 8192: the v5e-8 recipe's global
# batch of 4 over fsdp = 4 at its 8192 context, the reference's per-device shape
SVG_8B = (7616,)
# the fp32 check: 2 layers, T = 576 + 4124 = 4700, past the 4096-key window
SVG_8B_FP32 = (4124,)


def config_8b(sv, layers: int):
    """starvector_8b_config with its decoder cut to its first `layers`."""
    import dataclasses

    cfg = sv.starvector_8b_config()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=layers))


def train_slice_8b(sv, tfa, dev) -> dict:
    """8 steps of StarVector-8B training at full width (StarCoder2 4608
    wide, 36/4 heads, head 128, window 4096; SigLIP-L/16 at 384 and the
    LayerNorm adapter, all trainable) and 8 of its 32 decoder layers, on
    one batch of B = 1, T = 8192, through the port's train loop: fp32
    masters, bf16 compute, dots_flash, AdamW. Checks the loss falls, every
    value is finite, and each step launched each training kernel once a
    layer; then one loss and backward with remat=True on the trained
    weights, which runs the forward kernel twice a layer. Then the fp32
    check (fp32_check) at 2 layers, T = 4700."""
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import tree_leaves
    from starvector_tpu_torch.train.train import to_device

    cfg = config_8b(sv, TRAIN_8B_LAYERS)
    L = cfg.llm.num_hidden_layers
    images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch
    batch = training_batch(cfg, images, dev, lengths=SVG_8B)
    bf16 = DTypePolicy(torch.float32, torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what phase 6 leaves held
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    params, recs = _run_training(sv, tfa, cfg, dev, batch, TRAIN_STEPS, bf16)
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, per_step = check_train_run("8B training", recs, counts, L)
    n_params = sum(p.numel() for p in tree_leaves(params))
    B, T = 1, cfg.encoder_config.geometry[1] + max(SVG_8B)
    log("train", f"StarVector-8B at full width, {L} of 32 decoder layers ({n_params / 1e9:.3f} B "
                 f"parameters, SigLIP and the adapter trainable), B={B}, T={T} ({T - max(SVG_8B)} visual "
                 f"+ {max(SVG_8B)} svg tokens), window {cfg.llm.sliding_window}, fp32 masters / bf16 "
                 f"compute, dots_flash, AdamW lr {LR}: {TRAIN_STEPS} steps on one batch, loss "
                 f"{[round(x, 4) for x in losses]}, grad_norm {[round(x, 4) for x in norms]}; "
                 f"launches per step {per_step[0]} (each = {L} layers), in all {counts}; peak "
                 f"memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
                 f"{base / 2**30:.2f} GiB held before the first step")

    reset_counts(tfa)
    loss, _ = sv.loss_fn_with_bn_stats(params, cfg, to_device(batch, dev), 0, policy=bf16,
                                       remat=True)
    grads = torch.autograd.grad(loss, [p for p in tree_leaves(params) if p.requires_grad])
    torch.cuda.synchronize()
    remat_counts = {k: read_counts(tfa)[k] for k in TRAIN_KERNELS}
    expected = {"flash_prefill_with_lse": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    if remat_counts != expected or not torch.isfinite(loss) or \
            not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"8B remat=True: loss {loss.item()}, launches {remat_counts}, "
                             f"expected {expected}")
    log("train", f"8B remat=True, one loss and backward on the trained weights: loss "
                 f"{loss.item():.4f} (the last dots_flash step's {losses[-1]:.4f} was before its "
                 f"update), launches {remat_counts} (the forward re-run in the backward)")
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = config_8b(sv, 2)
    fp32_check(sv, tfa, dev, cfg2, training_batch(cfg2, images, dev, lengths=SVG_8B_FP32),
               f"8B at 2 layers, B=1, T={cfg2.encoder_config.geometry[1] + max(SVG_8B_FP32)}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(recs=recs, counts=counts, T=T, B=B, peak=peak, base=base, cfg=cfg, batch=batch)


RECIPE_8B = "configs/models/starvector-8b/im2svg-stack-v5e8.yaml"
# lr 1e-3 without warmup: the yaml's 1e-5 after 10 warmup steps moves
# nothing in 5 steps (Adafactor's step is lr x a leaf's RMS); at 1e-2 and
# 3e-3 the loss rose again at the 4th step (the norms' scales, RMS 1, move
# by lr a step). The phase holds each step's loss below the one before.
RECIPE_LR, RECIPE_STEPS = 1e-3, 5


def train_recipe_8b(sv, tfa, dev, card: str, batch) -> dict:
    """Phase 6c: the 8B's own recipe (RECIPE_8B, read through the port's
    config loader and train.main's own functions: Adafactor, grad_dtype
    bfloat16, dots_flash, fp32 masters, bf16 compute) at full width and all
    32 decoder layers, RECIPE_STEPS steps of the port's train loop on phase
    6b's batch (B=1, T=8192). If dots_flash runs out of memory, the yaml's
    fallback (full remat), then the deepest depth that fits. Checks the
    loss falls at every step, every value is finite and each step launched each training
    kernel once a layer (the forward twice under full remat); logs step
    time, tokens/s and peak memory beside the state's bytes."""
    import dataclasses

    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.models.builder import config_from_yaml_block
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import Adafactor, build_optimizer, tree_leaves
    from starvector_tpu_torch.train.train import (
        grad_dtype_from, optimizer_kwargs_from_config, remat_mode,
    )

    config = get_config([f"config={RECIPE_8B}"], default_path=resolve_repo_config())
    g = config.get_path
    kw = optimizer_kwargs_from_config(config)
    yaml_lr = (kw["lr"], kw["warmup_steps"])
    kw.update(lr=RECIPE_LR, warmup_steps=0)
    grad_dtype = grad_dtype_from(g("training.grad_dtype"))
    policy = DTypePolicy(torch.float32, torch.bfloat16 if g("training.bf16", True)
                         else torch.float32)
    full = config_from_yaml_block(dict(g("model")))
    if kw["optimizer"] != "adafactor" or grad_dtype != torch.bfloat16 or \
            full.llm.num_hidden_layers != 32:
        raise AssertionError(f"{RECIPE_8B}: {kw}, grad_dtype {grad_dtype}, {full.llm}")
    total_steps = int(g("training.steps", 10_000))

    def optimizer(p):
        return build_optimizer(p, total_steps=total_steps, **kw)

    tries = [(remat_mode(g("training.gradient_checkpointing", True)), 32), (True, 32),
             (True, 24), (True, 16)]
    notes = []
    for remat, layers in tries:
        cfg = dataclasses.replace(full, llm=dataclasses.replace(full.llm,
                                                               num_hidden_layers=layers))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(tfa)
        try:
            params, recs = _run_training(sv, tfa, cfg, dev, batch, RECIPE_STEPS, policy,
                                         remat=remat, grad_dtype=grad_dtype, optimizer=optimizer)
        except torch.cuda.OutOfMemoryError as e:
            notes.append(f"remat={remat!r} at {layers} layers ran out of memory "
                         f"({str(e).splitlines()[0][:120]})")
            continue
        break
    else:
        raise AssertionError(f"8B recipe: nothing fits: {notes}")
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.llm.num_hidden_layers
    losses, norms, per_step = check_train_run("8B recipe", recs, counts, L,
                                              forwards=2 if remat is True else 1,
                                              every_step=True)
    n = sum(p.numel() for p in tree_leaves(params))
    opt_state = sum(
        (p.numel() if Adafactor.factored_dims(p.shape) is None else
         p.numel() // p.shape[Adafactor.factored_dims(p.shape)[1]]
         + p.numel() // p.shape[Adafactor.factored_dims(p.shape)[0]]) * 4
        for p in tree_leaves(params))
    state = {"fp32 masters": 4 * n, "bf16 cast": 2 * n, "bf16 gradients": 2 * n,
             "Adafactor": opt_state}
    T = cfg.encoder_config.geometry[1] + batch["svg_ids"].shape[1]
    step = statistics.median(r["seconds"] for r in recs[1:])
    log("train", f"{card}: StarVector-8B, its own recipe ({RECIPE_8B}: Adafactor, grad_dtype "
                 f"bfloat16, gradient_checkpointing {remat!r}, fp32 masters, bf16 compute; lr "
                 f"{RECIPE_LR} without warmup in place of the yaml's {yaml_lr[0]} after "
                 f"{yaml_lr[1]} warmup steps) at full width and {L} of 32 decoder layers "
                 f"({n / 1e9:.3f} B parameters), B=1, T={T}"
                 + (f"; fell back: {'; '.join(notes)}" if notes else "")
                 + f": {RECIPE_STEPS} steps on one batch, loss {[round(x, 4) for x in losses]}, "
                 f"grad_norm {[round(x, 4) for x in norms]}; launches per step {per_step[0]} "
                 f"(each = {L} layers); step {step * 1e3:.1f} ms wall (median of steps 2-"
                 f"{RECIPE_STEPS}), {T / step:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
                 f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} held before); state "
                 + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in state.items())
                 + f" GiB, {sum(state.values()) / 2**30:.2f} GiB in all")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cfg=cfg, step=step, run=dict(remat=remat, grad_dtype=grad_dtype,
                                             optimizer=optimizer))


# flash_bwd_dkdv's head_split sweep: B, S, T, q_offset, Hkv, G, window. The
# 1B step, the 8k triangle and its SP chunk, the 16k SP chunk and triangle;
# the 8B's heads under its window from T = 769 to 16384
DKDV_SPLIT_SHAPES = (
    (4, 769, 769, 0, 1, 16, None), (1, 8450, 8450, 0, 1, 16, None),
    (1, 1024, 8450, 7426, 1, 16, None), (1, 1024, 16642, 15618, 1, 16, None),
    (1, 16642, 16642, 0, 1, 2, None),
    (2, 1160, 1160, 0, 4, 9, 4096), (1, 4700, 4700, 0, 4, 9, 4096),
    (1, 8192, 8192, 0, 4, 9, 4096), (2, 8192, 8192, 0, 4, 9, 4096),
    (1, 16384, 16384, 0, 4, 9, 4096), (4, 769, 769, 0, 4, 9, 4096),
    (1, 2048, 2048, 0, 4, 9, 4096),
    # a tensor rank's training shapes (phase 5g): the 1B's 8 heads, the 8B's 9 over 1
    (4, 769, 769, 0, 1, 8, None), (1, 4700, 4700, 0, 1, 9, 4096),
)


def head_split_times(tfa, dev, card: str) -> None:
    """flash_bwd_dkdv, bf16, all keys valid, at every divisor of G as its
    head_split, beside the pick of dkdv_head_split (the default) for this
    card: each split graph-replayed (10 calls a graph) twice, the mean.
    tests/test_torch_flash_backward.py::DKDV_SWEEP holds these times."""
    g = torch.Generator(device=dev).manual_seed(23)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, S, T, q_off, Hkv, G, W in DKDV_SPLIT_SHAPES:
        H, D = Hkv * G, 128
        q, do = (torch.randn((B, S, H, D), generator=g, device=dev).bfloat16() for _ in "qo")
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).bfloat16() for _ in "kv")
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, window=W)
        delta = tfa.attention_delta(out, do)
        times = {}
        for hs in (d for d in range(1, G + 1) if G % d == 0):
            run = functools.partial(tfa.flash_bwd_dkdv, q, k, v, mask, do, lse, delta, q_off,
                                    window=W, head_split=hs)
            times[hs] = (cuda_ms(run, iters=10) + cuda_ms(run, iters=10)) / 2
        split = tfa.dkdv_head_split(B, T, Hkv, G, sms, S=S, q_offset=q_off, window=W)
        best = min(times, key=times.get)
        log("times", f"{card}: flash_bwd_dkdv by head_split at B={B} S={S} T={T} q_offset={q_off} "
                     f"Hkv={Hkv} G={G} window={W} bf16 ({sms} SMs): dkdv_head_split picks {split}, "
                     f"{times[split] / times[best] - 1:.1%} slower than the best, {best}: "
                     + ", ".join(f"{hs}: {ms:.4f} ms" for hs, ms in times.items()))
        del q, do, k, v, mask, out, lse, delta
        torch.cuda.empty_cache()


def _sdpa_window(T: int, window: int, dev) -> torch.Tensor:
    """(T, T) bool: query q sees key t for q - window < t <= q (the kernels'
    causal mask with the sliding window), for SDPA's attn_mask."""
    pos = torch.arange(T, device=dev)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


# the training kernels at the 8B's heads: B, T, and the line of the TPU
# backward kernel that shape runs: the phase-6b step (the one-pass kernel,
# 2048 < T <= 8704) and a short batch (the fused one, T <= 2048)
TRAIN_TIMES_8B = ((1, 8192, 1092), (2, 1160, 968))


def training_times_8b(tfa, dev, card: str, t8: dict, errs: dict) -> list[dict]:
    """The 8B train step's wall time and tokens/s from phase 6b (median of
    the 5 steps after 3 of warm-up), and the training kernels at the 8B's
    heads (H = 36 over Hkv = 4, window 4096), bf16, S = T, at the step's
    B = 1, T = 8192 and at B = 2, T = 1160: each beside its plain version,
    its bound and SDPA with enable_gqa and the window as an explicit mask
    (forward; backward against dkdv + dq). The kernels are graph-replayed
    (10 calls a graph); the plain versions, whose (H, S, T) fp32 blocks are
    9.7 GB at 8192, and SDPA's backward run eager between CUDA events (3
    after 3 of warm-up), in turns plain, kernel, kernel, plain. Returns
    the kernels' JSON rows at the step's shape."""
    secs = [r["seconds"] for r in t8["recs"][3:]]
    step = statistics.median(secs)
    log("times", f"{card}: 8B train step B={t8['B']} T={t8['T']} ({TRAIN_8B_LAYERS} of 32 layers, "
                 f"bf16 compute, dots_flash): {step * 1e3:.1f} ms median of {len(secs)} steps after "
                 f"3 of warm-up ({[round(x * 1e3, 1) for x in secs]} ms), "
                 f"{t8['B'] * t8['T'] / step:.0f} tokens/s, peak memory {t8['peak'] / 2**30:.2f} GiB "
                 f"({(t8['peak'] - t8['base']) / 2**30:.2f} GiB above what was held before it)")
    g = torch.Generator(device=dev).manual_seed(22)
    H, Hkv, D, W = H8, HKV8, 128, WINDOW8
    graphed, timer = functools.partial(cuda_ms, iters=10), functools.partial(event_ms, iters=3)
    rows = []
    for B, T, bwd_row in TRAIN_TIMES_8B:
        q = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, window=W)
        delta = tfa.attention_delta(out, do)
        shape = f"B={B} S=T={T} H={H} Hkv={Hkv} D={D} window={W} bf16"
        pos = torch.arange(T, device=dev)
        pairs = B * H * int(torch.minimum(pos + 1, torch.full_like(pos, W)).sum())  # visible
        qh, doh = (t.transpose(1, 2).contiguous() for t in (q, do))
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        win = dict(attn_mask=_sdpa_window(T, W, dev))
        lib_fwd = sdpa_ms(qh, kh, vh, causal=False, enable_gqa=True, **win)
        lib_bwd = sdpa_backward_ms(qh, kh, vh, doh, iters=3, mask=win, enable_gqa=True)
        del qh, kh, vh, doh, win
        torch.cuda.empty_cache()
        act, kv, stats, m = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4, B * T * 4
        for name, fn, replaces, nbytes, flops, lib in (
                ("flash_prefill_with_lse", lambda kn: tfa.flash_prefill_with_lse(
                    q, k, v, mask, window=W, kernels=kn), 307,
                 2 * act + 2 * kv + stats + m, 4 * D * pairs, lib_fwd),
                ("flash_bwd_dkdv", lambda kn: tfa.flash_bwd_dkdv(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 2 * act + 4 * kv + 2 * stats + m, 8 * D * pairs, lib_bwd),
                ("flash_bwd_dq", lambda kn: tfa.flash_bwd_dq(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 3 * act + 2 * kv + 2 * stats + m, 6 * D * pairs, lib_bwd)):
            a = timer(lambda: fn(False))
            b, c = graphed(lambda: fn(True)), graphed(lambda: fn(True))
            plain_ms, ms = (a + timer(lambda: fn(False))) / 2, (b + c) / 2
            torch.cuda.empty_cache()
            b_ms, b_by = bound(nbytes, flops)
            log("times", f"{card}: {name} 8B train {shape}: kernel {ms:.4f} ms "
                         f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound), plain "
                         f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP over {pairs // (B * H)} visible pairs a head), "
                         f"SDPA {'n/a (no single PyTorch call)' if lib is None else f'{lib:.4f} ms'}")
            if (B, T) != (t8["B"], t8["T"]):
                continue
            src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
            rows.append(dict(name=f"{name}_8b", route="cuda",
                             source=f"starvector_tpu_torch/csrc/{src}",
                             replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                             launches=t8["counts"][name], max_abs_err=errs[f"{name}_8b"], ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def times_8b(tfa, dc, tq, dev, card: str, s8: dict, errs: dict) -> list[dict]:
    """The 8B's kernels at its shapes, bf16, graph-replayed: flash_prefill
    at B=4 S=T=580 (576 visual + 4 prompt tokens), H=36 over Hkv=4, window
    4096, and decode_attention at G=9, B=4 T=708 with the self token, each
    beside its plain version, its bound and SDPA with enable_gqa over the 4
    KV heads; decode_attention over an int8 cache at the same shape (no
    library call attends over int8 codes); kernel 14 at the six projections'
    four shapes (quant_matmul_times_8b). Returns their rows of the kernels'
    JSON, with launches from phase 6 (`s8`: bf16, and int8 under "int8")."""
    launches, launches8 = s8["counts"], s8["int8"]["counts"]
    g = torch.Generator(device=dev).manual_seed(18)
    D, rows = 128, []
    B, S = 4, 580
    q = torch.randn((B, S, H8, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8, kernels=False),
                          lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = sdpa_ms(qh, kh, vh, causal=True, enable_gqa=True)
    nbytes = 2 * B * S * H8 * D * 2 + 2 * B * S * HKV8 * D * 2 + B * S * 4
    flops = 4 * D * H8 * B * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill 8B B=4 S=T=580 H=36 Hkv=4 window=4096 D=128 bf16: kernel "
                 f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound), "
                 f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.2f} GFLOP), SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    rows.append(dict(name="flash_prefill_8b", route="cuda",
                     source="starvector_tpu_torch/csrc/flash_prefill.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:212",
                     launches=launches["flash_prefill"], max_abs_err=errs["flash_prefill_8b"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    del q, k, v, qh, kh, vh
    B, T, G = 4, 708, H8 // HKV8
    qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    kc, vc = (torch.randn((B, T, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    old = torch.ones((B, T), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(
        lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5, kernels=False),
        lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5))
    keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).contiguous() for c, n in ((kc, kn),
                                                                                   (vc, vn))]
    lib = sdpa_ms(qg.reshape(B, H8, 1, D), *keys, causal=False, enable_gqa=True)
    cache_bytes = 2 * B * T * HKV8 * D * 2
    small = 2 * B * H8 * D * 2 + 2 * B * HKV8 * D * 2 + B * T * 4
    flops = 4 * D * H8 * B * (T + 1)
    b_ms, b_by = bound(cache_bytes + small, flops)
    log("times", f"{card}: decode_attention G=9 B=4 T=708 Hkv=4 D=128 bf16 cache and queries, "
                 f"the self token merged: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{b_ms:.5f} ms ({b_by}: {cache_bytes / 1e6:.3f} MB of cache), SDPA "
                 f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    rows.append(dict(name="decode_attention_g9", route="cuda",
                     source="starvector_tpu_torch/csrc/decode_attention.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:2104",
                     launches=launches["decode_attention"], max_abs_err=errs["decode_g9"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    (kq, ks), (vq, vs) = dc.quantize_kv(kc.float()), dc.quantize_kv(vc.float())
    plain_ms, ms = _turns(
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs,
                                            kernels=False),
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs))
    cache_bytes = 2 * B * T * HKV8 * D + 2 * B * T * HKV8 * 4  # codes and fp32 scales
    b_ms, b_by = bound(cache_bytes + small, flops)
    log("times", f"{card}: decode_attention G=9 B=4 T=708 Hkv=4 D=128 int8 cache, bf16 queries, "
                 f"the self token merged: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{b_ms:.5f} ms ({b_by}: {cache_bytes / 1e6:.3f} MB of codes and scales; no "
                 f"single PyTorch call attends over an int8 cache)")
    rows.append(dict(name="decode_attention_int8_g9", route="cuda",
                     source="starvector_tpu_torch/csrc/decode_attention.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:2104",
                     launches=launches8["decode_attention_int8"],
                     max_abs_err=errs["decode_g9_int8"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    del qg, kn, vn, kc, vc, kq, vq, ks, vs
    qmm = quant_matmul_times_8b(tq, dev, card)
    for path, count in (("gemv_tc", "quant_matmul_gemv_tc"), ("gemv", "quant_matmul_gemv"),
                        ("tile", "quant_matmul_wgmma")):
        rows.append(dict(name=f"quant_matmul_{path}_8b", route="cuda",
                         source="starvector_tpu_torch/csrc/quant_matmul.cu",
                         replaces="starvector_tpu/ops/quantization.py:139",
                         launches=launches8[count], max_abs_err=errs[f"qmm_{path}_8b"],
                         **qmm[path]))
    return rows


def tp_counts(tp: dict) -> dict:
    """Phase 6e's launches by counter: {config: [count on rank 0, 1, ...]}."""
    names = next(iter(tp.values()))["ranks"][0]["counts"]
    return {c: {name: [run["counts"][c] for run in res["ranks"]] for name, res in tp.items()}
            for c in names}


def tp_times(tfa, dc, dev, card: str, tp: dict, errs: dict) -> list[dict]:
    """The kernels at one tensor rank's shapes, bf16 (the configs' serving
    type), graph-replayed beside the plain version, the bound and SDPA
    with enable_gqa over the one KV head: kernel 1 at H = 9 (tensor 4), 5
    and 4 (tensor 8) over Hkv = 1, B=4 S=T=580, window 4096 (phase 6's H=36
    row's shape); kernel 2 at G = 9 over Hkv = 1 and, over an int8 cache,
    at G = 5 and 4, B=4 T=708, the self token merged, beside the int8 G = 9
    launch at the same shape; then the 1B's ranks (tp_times_1b) and kernel
    14 at a tensor-8 rank's slices (quant_matmul_times_tp). Returns the rows
    of the kernels' JSON, launches from phase 6e's rank that runs each
    shape (`tp`), tp_launches every rank's."""
    counts = tp_counts(tp)
    g = torch.Generator(device=dev).manual_seed(23)
    D, rows = 128, []
    B, S = 4, 580
    for H, config, rank in ((9, "tp4dp2", 0), (5, "tp8-int8kv", 0), (4, "tp8-int8kv", 1)):
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, S, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        plain_ms, ms = _turns(
            lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8, kernels=False),
            lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = sdpa_ms(qh, kh, vh, causal=True, enable_gqa=True)
        nbytes = 2 * B * S * H * D * 2 + 2 * B * S * D * 2 + B * S * 4
        flops = 4 * D * H * B * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, flops)
        log("times", f"{card}: flash_prefill a tensor rank's B=4 S=T=580 H={H} Hkv=1 window=4096 "
                     f"D=128 bf16 ({config}): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{b_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                     f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), SDPA "
                     f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
        rows.append(dict(name=f"flash_prefill_{config.split('-')[0][:3]}_h{H}", route="cuda",
                         source="starvector_tpu_torch/csrc/flash_prefill.cu",
                         replaces="starvector_tpu/ops/flash_attention.py:212",
                         launches=counts["flash_prefill"][config][rank],
                         max_abs_err=errs[f"flash_prefill_h{H}"], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         tp_launches=counts["flash_prefill"]))
        del q, k, v, qh, kh, vh
    B, T = 4, 708
    small_kv = 2 * B * D * 2 + B * T * 4  # k_new, v_new, the mask
    int8_g9 = None
    for G, quant, config, rank in ((9, False, "tp4dp2", 0), (9, True, None, None),
                                   (5, True, "tp8-int8kv", 0), (4, True, "tp8-int8kv", 1)):
        qg = torch.randn((B, 1, G, D), generator=g, device=dev).bfloat16()
        kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        kc, vc = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        old = torch.ones((B, T), dtype=torch.int32, device=dev)
        cache = (kc, vc, None, None)
        if quant:
            (kq, ks), (vq, vs) = dc.quantize_kv(kc.float()), dc.quantize_kv(vc.float())
            cache = (kq, vq, ks, vs)
        kk, vv, sk, sv_ = cache
        plain_ms, ms = _turns(
            lambda: tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_,
                                                kernels=False),
            lambda: tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_))
        if config is None:  # beside the tensor-8 ranks' groups of 5 and 4
            int8_g9 = ms
            log("times", f"{card}: decode_attention int8 cache G=9 Hkv=1 B=4 T=708 bf16 queries: "
                         f"kernel {ms:.4f} ms")
            continue
        cache_bytes = 2 * B * T * D * (1 if quant else 2) + (2 * B * T * 4 if quant else 0)
        flops = 4 * D * G * B * (T + 1)
        b_ms, b_by = bound(cache_bytes + 2 * B * G * D * 2 + small_kv, flops)
        lib = None
        if not quant:
            keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).contiguous()
                    for c, n in ((kc, kn), (vc, vn))]
            lib = sdpa_ms(qg.reshape(B, G, 1, D), *keys, causal=False, enable_gqa=True)
        pad = "" if not quant else (f"; the G = 9 launch at this shape {int8_g9:.4f} ms "
                                    f"({(ms - int8_g9) / ms:+.1%} of this launch)")
        name = f"decode_attention{'_int8' if quant else ''}_{config.split('-')[0][:3]}_g{G}"
        log("times", f"{card}: decode_attention {'int8' if quant else 'bf16'} cache G={G} Hkv=1 "
                     f"B=4 T=708 D=128 bf16 queries, the self token merged ({config}): kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                     f"{cache_bytes / 1e6:.3f} MB of cache), SDPA "
                     f"{'n/a (no single PyTorch call attends over an int8 cache)' if quant else f'{lib:.4f} ms' if lib is not None else 'n/a'}{pad}")
        counter = "decode_attention_int8" if quant else "decode_attention"
        rows.append(dict(name=name, route="cuda",
                         source="starvector_tpu_torch/csrc/decode_attention.cu",
                         replaces="starvector_tpu/ops/flash_attention.py:2104",
                         launches=counts[counter][config][rank],
                         max_abs_err=errs[f"decode{'_int8' if quant else ''}_g{G}_hkv1"], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         tp_launches=counts[counter],
                         **({"g9_ms": int8_g9} if quant else {})))
        del qg, kn, vn, kc, vc
    rows += tp_times_1b(tfa, dc, dev, card, counts, errs)
    rows += quant_matmul_times_tp(dev, card, counts, errs)
    return rows


def _decode_case(dev, g, B: int, T: int, G: int, dtype, quant: bool):
    """(qg, k_new, v_new, k, v, k_scale, v_scale, mask) of a decode step over
    one KV head: a cache of the queries' type, or int8 codes with scales."""
    from starvector_tpu_torch.models import decode_common as dc

    D = 128
    qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
    kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
    kc, vc = (torch.randn((B, T, 1, D), generator=g, device=dev) for _ in "kv")
    if quant:
        (k, ks), (v, vs) = dc.quantize_kv(kc), dc.quantize_kv(vc)
    else:
        (k, v), ks, vs = (kc.to(dtype), vc.to(dtype)), None, None
    return qg, kn, vn, k, v, ks, vs, torch.ones((B, T), dtype=torch.int32, device=dev)


def tp_times_1b(tfa, dc, dev, card: str, counts: dict, errs: dict) -> list[dict]:
    """The 1B's tensor ranks' attention kernels (phase 6e's 1b-tp2dp4 in
    fp32, 1b-tp8-int8 in bf16), graph-replayed beside the plain version,
    the bound and SDPA with enable_gqa over the one KV head: kernel 1 at H
    = 8 (fp32; bf16 beside it) and H = 2 (bf16) over Hkv = 1, B=4 S=T=261
    (phase 7's 1B prefill, no window); kernel 2 at G = 8 (fp32 over an fp32
    cache; bf16 over a bf16 and an int8 cache beside it) and at G = 2 over
    an int8 cache (bf16; a bf16 cache beside it), B=4 T=325, the self token
    merged. Rows of the kernels' JSON, launches from the rank 0 of the run
    that runs each."""
    g = torch.Generator(device=dev).manual_seed(24)
    D, rows = 128, []
    B, S = 4, 261
    for H, config, dtype in ((8, "1b-tp2dp4", torch.float32), (2, "1b-tp8-int8", torch.bfloat16)):
        times = {}
        for dt in dict.fromkeys((dtype, torch.bfloat16)):
            q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
            k, v = (torch.randn((B, S, 1, D), generator=g, device=dev).to(dt) for _ in "kv")
            mask = torch.ones((B, S), dtype=torch.int32, device=dev)
            times[dt] = _turns(lambda: tfa.flash_prefill(q, k, v, mask, kernels=False),
                               lambda: tfa.flash_prefill(q, k, v, mask))
            if dt == dtype:
                qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lib = sdpa_ms(qh, kh, vh, causal=True, enable_gqa=True)
                del qh, kh, vh
            del q, k, v
        size = dtype.itemsize
        nbytes = 2 * B * S * H * D * size + 2 * B * S * D * size + B * S * 4
        flops = 4 * D * H * B * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S if dtype == torch.bfloat16
                           else F32_FLOP_PER_S)
        plain_ms, ms = times[dtype]
        also = "" if dtype == torch.bfloat16 else \
            f"; bf16 at the same shape: kernel {times[torch.bfloat16][1]:.4f} ms, plain " \
            f"{times[torch.bfloat16][0]:.4f} ms"
        log("times", f"{card}: flash_prefill a 1B tensor rank's B=4 S=T=261 H={H} Hkv=1 D=128 "
                     f"{str(dtype)[6:]} ({config}): kernel {ms:.4f} ms ({b_ms / ms:.1%} of the "
                     f"bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                     f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), SDPA "
                     f"{'n/a' if lib is None else f'{lib:.4f} ms'}{also}")
        rows.append(dict(name=f"flash_prefill_1b_h{H}", route="cuda",
                         source="starvector_tpu_torch/csrc/flash_prefill.cu",
                         replaces="starvector_tpu/ops/flash_attention.py:212",
                         launches=counts["flash_prefill"][config][0],
                         max_abs_err=errs[f"flash_prefill_h{H}"], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib, dtype=str(dtype)[6:],
                         **({"bf16_ms": times[torch.bfloat16][1],
                             "bf16_plain_ms": times[torch.bfloat16][0]}
                            if dtype != torch.bfloat16 else {}),
                         tp_launches=counts["flash_prefill"]))
    B, T = 4, 325
    for G, config, dtype, quant, others in (
            (8, "1b-tp2dp4", torch.float32, False, ((torch.bfloat16, False),
                                                     (torch.bfloat16, True))),
            (2, "1b-tp8-int8", torch.bfloat16, True, ((torch.bfloat16, False),))):
        times = {}
        for dt, qu in ((dtype, quant),) + others:
            qg, kn, vn, k, v, ks, vs, old = _decode_case(dev, g, B, T, G, dt, qu)
            times[(dt, qu)] = _turns(
                lambda: tfa.merged_decode_attention(qg, kn, vn, k, v, old, D**-0.5, ks, vs,
                                                    kernels=False),
                lambda: tfa.merged_decode_attention(qg, kn, vn, k, v, old, D**-0.5, ks, vs))
            if (dt, qu) == (dtype, quant):
                lib = None
                if not quant:
                    keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).contiguous()
                            for c, n in ((k, kn), (v, vn))]
                    lib = sdpa_ms(qg.reshape(B, G, 1, D), *keys, causal=False, enable_gqa=True)
                    del keys
            del qg, kn, vn, k, v, ks, vs, old
        size = 1 if quant else dtype.itemsize
        cache_bytes = 2 * B * T * D * size + (2 * B * T * 4 if quant else 0)
        nbytes = cache_bytes + 2 * B * G * D * dtype.itemsize + 2 * B * D * dtype.itemsize \
            + B * T * 4
        flops = 4 * D * G * B * (T + 1)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S if dtype == torch.bfloat16
                           else F32_FLOP_PER_S)
        plain_ms, ms = times[(dtype, quant)]
        also = "; ".join(f"{str(dt)[6:]} queries over {'an int8' if qu else 'a ' + str(dt)[6:]} "
                         f"cache: kernel {times[(dt, qu)][1]:.4f} ms, plain "
                         f"{times[(dt, qu)][0]:.4f} ms" for dt, qu in others)
        label = "int8" if quant else str(dtype)[6:]
        log("times", f"{card}: decode_attention a 1B tensor rank's G={G} Hkv=1 B=4 T=325 D=128, "
                     f"{str(dtype)[6:]} queries over {'an int8' if quant else 'a ' + label} cache, "
                     f"the self token merged ({config}): kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {cache_bytes / 1e6:.3f} MB "
                     f"of cache), SDPA "
                     f"{'n/a (no single PyTorch call attends over an int8 cache)' if quant else f'{lib:.4f} ms' if lib is not None else 'n/a'}"
                     f"; beside it, {also}")
        counter = "decode_attention_int8" if quant else "decode_attention"
        rows.append(dict(name=f"decode_attention{'_int8' if quant else ''}_1b_g{G}", route="cuda",
                         source="starvector_tpu_torch/csrc/decode_attention.cu",
                         replaces="starvector_tpu/ops/flash_attention.py:2049",
                         launches=counts[counter][config][0],
                         max_abs_err=errs[f"decode{'_int8' if quant else ''}_g{G}_hkv1"], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         dtype=str(dtype)[6:], others={
                             f"{str(dt)[6:]}{' int8 cache' if qu else ''}": times[(dt, qu)][1]
                             for dt, qu in others},
                         tp_launches=counts[counter]))
    torch.cuda.empty_cache()
    return rows


def quant_matmul_times_tp(dev, card: str, counts: dict, errs: dict) -> list[dict]:
    """Kernel 14 at a tensor-8 rank's shapes (QMM_TP_SHAPES), bf16 x, as a
    rank's dense runs it (a column slice with its bias and a bf16 result, a
    row slice with no bias and an fp32 result): the GEMV at a step's 16
    slots (the design gemv_path picks: the tensor-core GEMV) and the tile
    at the admission's rows, graph-replayed beside the plain version,
    the bound, bf16 addmm and torch._weight_int8pack_mm (over 2 calls
    between events at the tile's rows). One row per model and path: the
    times summed over one layer's projections on the rank with the larger
    heads (the 8B's rank of 5 query heads: q, k, v, o_proj, c_fc, c_proj;
    the 1B's: c_attn, attn/c_proj, c_fc, mlp/c_proj), launches from
    tp8-int8kv-q's or 1b-tp8-int8's rank 0."""
    from starvector_tpu_torch.ops import quantization as tq

    g = torch.Generator(device=dev).manual_seed(25)
    sums: dict = {}
    for name, K, N, row, model in QMM_TP_SHAPES:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        kq, sc = p["kernel_q"], p["scale"]
        w16 = (kq.float() * sc).bfloat16()
        kq_nk, sc16 = kq.t().contiguous(), sc.bfloat16()
        bias = None if row else torch.randn((N,), generator=g, device=dev).bfloat16()
        out_dtype = torch.float32 if row else torch.bfloat16
        layer = "(4 heads)" not in name  # k_proj, v_proj twice a layer
        for M in QMM_TP_ROWS[model]:
            path = qmm_path(tq, M, K, N)
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            plain_ms, ms = _turns(
                lambda: tq.quant_matmul(x, kq, sc, bias, out_dtype=out_dtype, kernels=False),
                lambda: tq.quant_matmul(x, kq, sc, bias, out_dtype=out_dtype))
            addmm_ms = cuda_ms((lambda: torch.mm(x, w16)) if row else
                               (lambda: torch.addmm(bias, x, w16)))
            timer = functools.partial(event_ms, iters=2, warmup=1) if path == "tile" else None
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm", timer)
            nbytes = M * K * 2 + K * N + N * 4 + (0 if row else N * 2) + \
                M * N * out_dtype.itemsize
            b_ms, b_by = bound(nbytes, 2 * M * K * N)
            log("times", f"{card}: quant_matmul {path} {name} M={M} K={K} N={N} "
                         f"({'fp32 out, no bias' if row else 'bias, bf16 out'}): kernel "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                         f"{b_ms / ms:.1%} of it), int8pack_mm "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 "
                         f"{'mm' if row else 'addmm'} {addmm_ms:.4f} ms")
            if layer:
                n = 2 if "k_proj, v_proj" in name else 1
                acc = sums.setdefault((model, path), dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                                          addmm_ms=0.0, lib_ms=0.0, lib=True,
                                                          bytes=0, flops=0, M=M, shapes=[]))
                acc["ms"] += n * ms
                acc["plain_ms"] += n * plain_ms
                acc["addmm_ms"] += n * addmm_ms
                acc["lib"] &= lib is not None
                acc["lib_ms"] += n * (lib or 0.0)
                acc["bytes"] += n * nbytes
                acc["flops"] += n * 2 * M * K * N
                acc["shapes"].append(dict(name=name, K=K, N=N, ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms))
            del x
        del p, kq, sc, w16, kq_nk
        torch.cuda.empty_cache()
    rows = []
    for (model, path), acc in sums.items():
        config = "tp8-int8kv-q" if model == "8b" else "1b-tp8-int8"
        b_ms, b_by = bound(acc["bytes"], acc["flops"])
        lib = acc["lib_ms"] if acc["lib"] else acc["addmm_ms"]
        log("times", f"{card}: quant_matmul {path} at M={acc['M']}, one layer's projections on a "
                     f"{model.upper()} tensor-8 rank ({config}): kernel {acc['ms']:.4f} ms, plain "
                     f"{acc['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                     f"{b_ms / acc['ms']:.1%} of it), "
                     f"{'int8pack_mm' if acc['lib'] else 'bf16 addmm'} {lib:.4f} ms")
        launches = counts[f"quant_matmul_{'wgmma' if path == 'tile' else path}"][config]
        rows.append(dict(name=f"quant_matmul_{path}_tp8_{model}", route="cuda",
                         source="starvector_tpu_torch/csrc/quant_matmul.cu",
                         replaces="starvector_tpu/ops/quantization.py:139",
                         launches=launches[0], max_abs_err=errs[f"qmm_{path}_tp_{model}"],
                         ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, rows_of_x=acc["M"], shapes=acc["shapes"],
                         tp_launches=launches))
    return rows


def quant_matmul_times_8b(tq, dev, card: str) -> dict:
    """Kernel 14 at the 8B's shapes against its plain version, the bf16
    cuBLAS addmm and torch._weight_int8pack_mm (where this torch has it for
    CUDA; timed over 2 calls between events at prefill sizes, where it takes
    tenths of a second), with a bf16 bias: the GEMV's two designs at M = 1,
    4, 8, 16 (gemv_times) and the tile at M = 580, 2320 (with TFLOP/s,
    share of the bound, and every plan tile_plan weighs). Returns mlp.c_fc's
    figures, the largest, by design ("gemv_tc" and "gemv" at M = 4, "tile"
    at M = 2320): ms, plain_ms, bound_ms, bound_by, library_ms (int8pack_mm,
    else addmm)."""
    rows = gemv_rows(gemv_times(tq, dev, card, QMM_SHAPES_8B, "8B", 21), "mlp.c_fc")
    g = torch.Generator(device=dev).manual_seed(21)
    for name, K, N in QMM_SHAPES_8B:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        kq, sc = p["kernel_q"], p["scale"]
        w16 = (kq.float() * sc).bfloat16()
        kq_nk, sc16 = kq.t().contiguous(), sc.bfloat16()
        b = torch.randn((N,), generator=g, device=dev).bfloat16()
        for M in QMM_ROWS_8B[-2:]:
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            plain_ms, ms = _turns(
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16, kernels=False),
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16))
            addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w16))
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm",
                             functools.partial(event_ms, iters=2, warmup=1))
            flops = 2 * M * K * N
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, flops)
            log("times", f"{card}: quant_matmul 8B tile {name} M={M} K={K} N={N} bf16: kernel "
                         f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                         f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it), int8pack_mm "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 addmm "
                         f"{addmm_ms:.4f} ms (reads 2 bytes a weight)")
            if TIMINGS:
                tile_plan_times(tq, x, kq, sc, b, f"8B {name}", card)
            if name == "mlp.c_fc" and M == 2320:
                rows["tile"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib if lib is not None else addmm_ms)
            del x
        del p, kq, sc, w16, kq_nk
        torch.cuda.empty_cache()
    return rows


def times_only(card: str, dev) -> int:
    """--times-only ROOT: phase 6's decode-step and prefill-tile figures
    (decode_times, quant_matmul_times) and phase 4's serving times (serving_times) for the
    package under ROOT, on the same seeded weights; one JSON line last. Run
    it for two trees in turns (a, b, b, a) on one card to compare them."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    log("times", f"{card}: the package at {Path(tfa.__file__).resolve().parents[2]}")
    decode = decode_times(tfa, dc, dev, card)
    qmm = quant_matmul_times(tq, dev, card)
    cfg = sv.starvector_1b_config()
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    p16 = _cast_tree(full_width_params(sv, cfg, dev, torch.float32), torch.bfloat16)
    model = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev)
    requests = {"bf16": api_requester(model),
                "int8": int8_requester(model, cfg, quantized(p16), bf16, dev)}
    for request in requests.values():
        request(synthetic_images(4, 99))  # warm-up
    serving = serving_times(card, requests)
    print(json.dumps({"times": {"decode_attention": decode, "quant_matmul": qmm,
                                "serving": serving}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="also trace a B=4 request and a train step with torch.profiler "
                             "and write the kernel tables to DIR")
    parser.add_argument("--timings", action="store_true",
                        help="also run the work whose only output is a time (TIMINGS)")
    parser.add_argument("--times-only", metavar="ROOT", type=Path,
                        help="only time the decode step's kernels, the int8 prefill tile and the "
                             "bf16 and int8 serving, for the package in the tree at ROOT (to "
                             "compare trees)")
    args = parser.parse_args()
    global TIMINGS
    TIMINGS = args.timings or args.times_only is not None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on an H100", file=sys.stderr)
        return 2
    if args.times_only is not None:
        sys.path.insert(0, str(args.times_only.resolve()))
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import kernel_lib
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    dev = torch.device("cuda")
    t_run = time.perf_counter()

    took: list[list] = []  # [phase, its start, its seconds]

    def phase(n: int | str, what: str) -> None:
        now = time.perf_counter()
        if took:
            took[-1][2] = now - took[-1][1]
            log("phase", f"{took[-1][0]} took {took[-1][2]:.0f} s")
        took.append([n, now, None])
        log("phase", f"{n}. {what}, {now - t_run:.0f} s into the run")

    # --- 1. card -------------------------------------------------------------
    card = card_line()
    nvcc = subprocess.run([kernel_lib.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc} | "
                f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if args.times_only is not None:
        kernel_lib.library()
        return times_only(card, dev)

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernel_lib.library()
    built = kernel_lib.build_seconds()
    summary = ptxas_summary(kernel_lib.build_log())
    sources = sorted(p.name for p in kernel_lib.CSRC_DIR.glob("*.cu"))
    log("build", f"{kernel_lib.library_path().name} from {len(sources)} CUDA sources "
                 f"({', '.join(sources)}): "
                 f"{'built in %.1f s' % built if built is not None else 'reused'} "
                 f"(load {time.perf_counter() - t0:.1f} s); ptxas per kernel: "
                 + "; ".join(summary))
    sass = sass_counts(kernel_lib.library_path(), kernel_lib.find_nvcc())
    hgmma = {k: v["HGMMA"] for k, v in sass.items()}
    hmma = {k: v["HMMA"] for k, v in sass.items()}
    if not all(hgmma.get(k) for k in TENSOR_CORE_KERNELS) or \
            any(hgmma.get(k) for k in CUDA_CORE_KERNELS):
        raise AssertionError(f"HGMMA instructions per kernel: {hgmma}")
    if not all(hmma.get(k) for k in HMMA_KERNELS) or any(hmma.get(k) for k in NO_HMMA_KERNELS) \
            or not all(k in hmma for k in NO_HMMA_KERNELS):
        raise AssertionError(f"HMMA instructions per decode kernel: {hmma}")
    qmm_tiles = sorted(k for k in hgmma if k.startswith("qmm_wgmma_kernel"))
    if len(qmm_tiles) != 4 or not all(hgmma[k] for k in qmm_tiles):
        raise AssertionError(f"HGMMA instructions in the int8 wgmma tile: {hgmma}")
    faults = [line for line in summary if line.startswith("qmm_wgmma_kernel")
              and ("serialized" in line or not line.endswith(" 0 bytes spilled"))]
    if faults:
        raise AssertionError(f"the int8 wgmma tile spills or its products are serialized: {faults}")
    # the tensor-core GEMV: mma.sync (HMMA) in every instantiation, no spill
    qmm_tc = sorted(k for k in hmma if k.startswith("qmm_gemv_tc_kernel"))
    faults = [line for line in summary if line.startswith("qmm_gemv_tc_kernel")
              and not line.endswith(" 0 bytes spilled")]
    if len(qmm_tc) != 8 or not all(hmma[k] for k in qmm_tc) or faults:
        raise AssertionError(f"the tensor-core GEMV: HMMA {[(k, hmma[k]) for k in qmm_tc]}, "
                             f"spills {faults}")
    log("build", "HGMMA (wgmma) instructions in the machine code (cuobjdump -sass): "
                 + ", ".join(f"{k} {hgmma.get(k, 0)}"
                             for k in TENSOR_CORE_KERNELS + CUDA_CORE_KERNELS + tuple(qmm_tiles))
                 + "; HMMA (mma.sync): " + ", ".join(f"{k} {hmma.get(k, 0)}"
                                                     for k in HMMA_KERNELS + NO_HMMA_KERNELS
                                                     + tuple(qmm_tc)))

    # --- 3. kernels against their plain versions --------------------------------
    phase(3, "kernels against their plain versions")
    err_prefill = check_flash_prefill(tfa, dev)
    err_decode = check_decode_attention(tfa, dev)
    log("kernels", f"both kernels match their plain versions (atol=rtol 1e-4 in fp32; bf16 "
                   f"prefill atol=rtol 2e-2, decode atol 2e-3 and rtol 2^-7); max |diff| prefill "
                   f"{err_prefill:.3e}, decode {err_decode:.3e}")
    err_qmm = check_quant_matmul(tq, dev)
    err_int8 = check_int8_decode(tfa, dc, dev)
    log("kernels", f"the int8 kernels match their plain versions (atol=rtol 1e-4 in fp32; bf16 "
                   f"quant_matmul and int8-cache decode atol 2e-3 and rtol 2^-7; the bf16 GEMV "
                   f"at M=1, 4, 8, 16 and the wgmma tile at M=144, 260 and 1040 bit-identical on "
                   f"relaunch); max |diff| quant_matmul tensor-core GEMV "
                   f"{err_qmm['gemv_tc']:.3e}, GEMV pair {err_qmm['gemv']:.3e}, tile "
                   f"{err_qmm['tile']:.3e}, "
                   f"int8-cache decode {err_int8:.3e}")
    err_8b = {"decode_g9": check_g9_decode(tfa, dev),
              "flash_prefill_8b": check_flash_prefill_8b(tfa, dev),
              "decode_g9_int8": check_g9_int8_decode(tfa, dc, dev)}
    qmm_8b = check_quant_matmul_8b(tq, dev)
    err_8b.update(qmm_gemv_tc_8b=qmm_8b["gemv_tc"], qmm_gemv_8b=qmm_8b["gemv"],
                  qmm_tile_8b=qmm_8b["tile"])
    err_8b.update(check_tp_shapes(tfa, dc, dev))
    err_bounds = check_decode_bounds(tfa, dc, dev)
    log("kernels", f"decode_attention with device bounds (G=16 and 9, fp32 and bf16, a cache "
                   f"of q's type and int8 codes) matches its plain version (fp32 1e-4, bf16 "
                   f"atol 2e-3 and rtol 2^-7) and replays in a CUDA graph as the bounds move; "
                   f"max |diff| {err_bounds:.3e}")
    err_8b.update(check_quant_matmul_tp(tq, dev))
    log("kernels", f"the 8B's kernel shapes match their plain versions (decode G=9 over a bf16 "
                   f"or an int8 cache: fp32 1e-4, bf16 atol 2e-3 and rtol 2^-7; flash_prefill "
                   f"H=36 Hkv=4 window 4096: fp32 1e-4, bf16 2e-2; quant_matmul at the six "
                   f"projections' four shapes, M = 1, 4, 8, 16, 580, 2320: fp32 1e-4, bf16 atol "
                   f"2e-3 and "
                   f"rtol 2^-7; bf16 bit-identical on relaunch); max |diff| decode G=9 "
                   f"{err_8b['decode_g9']:.3e}, int8-cache decode G=9 "
                   f"{err_8b['decode_g9_int8']:.3e}, flash_prefill H=36 "
                   f"{err_8b['flash_prefill_8b']:.3e}, quant_matmul 8B tensor-core GEMV "
                   f"{qmm_8b['gemv_tc']:.3e}, GEMV pair {qmm_8b['gemv']:.3e}, tile "
                   f"{qmm_8b['tile']:.3e}")
    err_train = check_training_kernels(tfa, dev)
    log("kernels", "the training kernels match their plain versions (fp32 atol=rtol 1e-4; bf16 "
                   "2e-2, or no more than twice the plain bf16 version's own error from fp32 "
                   "plus 1e-3); bf16 max |diff| at the 1B step's shape (B=4 T=769) and, _8b, "
                   "at the 8B step's (B=1 T=8192 H=36 Hkv=4 window 4096): "
                   + ", ".join(f"{k} {v:.3e}" for k, v in err_train.items()))
    log("rounding", check_bf16_rounding(dev))

    # --- 4. the slice at full width --------------------------------------------
    phase(4, "StarVector-1B inference")
    cfg = sv.starvector_1b_config()
    L = cfg.llm.n_layer
    p32 = full_width_params(sv, cfg, dev, torch.float32)
    p16 = _cast_tree(p32, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    model = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev)
    greedy = GREEDY
    request = api_requester(model)
    request(synthetic_images(4, 99))  # warm-up: cuBLAS handles, allocator
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    n_prefill, n_decode = counts["flash_prefill"], counts["decode_attention"]
    if any(counts[k] for k in TRAIN_KERNELS + ("quant_matmul", "decode_attention_int8")):
        raise AssertionError(f"bf16 inference launched training or int8 kernels: {counts}")
    steps = [decode_steps(tokens, lengths) for tokens, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"bad tokens {tuple(tokens.shape)} [{tokens.min()}, {tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"bad lengths {lengths.tolist()}")
    if n_prefill != L * 3 or n_decode != L * sum(steps):
        raise AssertionError(f"launches: flash_prefill {n_prefill} (expected {L * 3}), "
                             f"decode_attention {n_decode} (expected {L * sum(steps)})")
    distinct = [len(set(row.tolist())) for tokens, _, _ in served for row in tokens]
    log("slice", f"3 requests x 4 images, greedy, 128 new tokens at full 1B width: decode steps "
                 f"{steps}, lengths {[l.tolist() for _, l, _ in served]}, distinct ids per row "
                 f"{distinct}; launches flash_prefill {n_prefill} = {L} x 3 prefills, "
                 f"decode_attention {n_decode} = {L} x {sum(steps)} decode steps ({graph_tally()}: "
                 f"a replay's launches counted as the graph's capture counted them)")

    # fp32: greedy ids with the kernels against the plain attention
    images = model.process_images(synthetic_images(2, 7))
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg, policy=f32, device=dev, kernels=kernels)
        _, ids[kernels], _ = m32.generate_im2svg_ids(
            {"image": images}, **{**greedy, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32})
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"fp32 greedy ids differ:\n{ids[True].tolist()}\n{ids[False].tolist()}")
    _, uncaptured, _ = StarVectorForCausalLM(p32, cfg, policy=f32, device=dev,
                                             cuda_graphs=False).generate_im2svg_ids(
        {"image": images}, **{**greedy, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32})
    if not torch.equal(ids[True], uncaptured):
        raise AssertionError(f"fp32 greedy ids, graphed {ids[True].tolist()} != uncaptured "
                             f"{uncaptured.tolist()}")
    log("slice", f"fp32, B=2, 32 tokens: greedy ids with the kernels, the decode steps replayed "
                 f"as CUDA graphs == the same steps uncaptured (cuda_graphs=False), bit for bit, "
                 f"== with the plain attention "
                 f"({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row)")
    from starvector_tpu_torch.generation.engine import im2svg_prefix as _prefix

    steps_1b = step_times(card, f"1B bf16 ({L} layers)", p16["svg_transformer"], cfg.llm,
                          *_prefix(p16, cfg, model.process_images(synthetic_images(4, 61)),
                                   torch.tensor([PROMPT_IDS] * 4, device=dev), policy=bf16),
                          bf16)

    # bf16: prefill last-position logits and greedy tokens, kernels against plain
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode

    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg, images, prompt, policy=policy)
        cache = gpt_bigcode.init_cache(cfg.llm, 4, emb.shape[1], dtype=policy.compute_dtype,
                                       device=dev)
        return gpt_bigcode.forward(params["svg_transformer"], cfg.llm, emb, mask, cache=cache,
                                   policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(p32, f32, False)
    logits, toks = {}, {}
    for kernels in (True, False):
        logits[kernels] = prefill_logits(p16, bf16, kernels)
        _, toks[kernels], _ = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev,
                                                    kernels=kernels).generate_im2svg_ids(
            {"image": images}, **greedy)
    diff = (logits[True] - logits[False]).abs().max().item()
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    # bound: the kernels may not add more error than bf16 itself does. Both
    # bf16 paths leave the fp32 logits by bf16 rounding compounded over 24
    # layers; the prefill kernel rounds the unnormalised P where the JAX
    # kernel does, the plain version the normalised P.
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"bf16 prefill logits: kernels {err_k:.3e} from fp32, over twice "
                             f"the plain version's {err_p:.3e}")
    agree = (toks[True] == toks[False]).float().mean().item()
    log("slice", f"bf16, B=4: prefill last-position logits, max |diff| kernels vs plain {diff:.4e}; "
                 f"from the fp32 plain logits (max |logit| {ref32.abs().max().item():.3e}): kernels "
                 f"{err_k:.4e}, plain {err_p:.4e} (bound: kernels <= 2 x plain + 1e-3); greedy "
                 f"tokens agree on {agree:.4f} of 4x128 positions")

    # text2svg: captions through the v1 test tokenizer, the same bf16 weights
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

    t2s = text2svg_slice(tfa, "1B", StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v1"),
                                                          policy=bf16, device=dev),
                         p32, cfg, dev, "full depth")

    # int8 weights and an int8 KV cache
    int8 = int8_slice(model, tfa, cfg, p16, p32, dev)

    # serving times and memory, bf16, int8 and text2svg in turns (--timings);
    # then the int8 tree goes, so that phase 5's peak holds only what
    # training needs
    if TIMINGS:
        t_times = time.perf_counter()
        e2e = serving_times(card, {"bf16": request, "int8": int8["request"],
                                   "text2svg": t2s["request"]})
        log("times", f"{card}: int8 (weights and KV cache) against bf16: p50 B=1 "
                     f"{e2e['int8']['p50'] * 1e3:.1f} vs {e2e['bf16']['p50'] * 1e3:.1f} ms, B=4 "
                     f"decode {e2e['int8']['rate']:.1f} vs {e2e['bf16']['rate']:.1f} tokens/s")
        log("times", f"{card}: 1B text2svg (prompts of 6-30 tokens, no vision tower) against "
                     f"im2svg, bf16: p50 B=1 {e2e['text2svg']['p50'] * 1e3:.1f} vs "
                     f"{e2e['bf16']['p50'] * 1e3:.1f} ms, B=4 decode "
                     f"{e2e['text2svg']['rate']:.1f} vs {e2e['bf16']['rate']:.1f} tokens/s")
        memory_times(card, {"bf16": request, "int8": int8["request"]},
                     {"bf16": p16, "int8": int8["params"]})
        timed_only("phase 4's serving and memory turns", t_times)

    # --- 4b. the decoding variants and GRPO -------------------------------------
    # 4b's decoding variants, 4c, 4d and 4e on the first DEPTH_1B_EARLIER
    # layers of phase 4's trees (GRPO builds its own, at full depth)
    phase("4b", f"StarVector-1B decoding variants ({DEPTH_1B_EARLIER} of {L} layers) and GRPO")
    t_4b = time.perf_counter()
    s16, cfg_cut = first_layers(p16, cfg, DEPTH_1B_EARLIER)
    s32, sq16 = (first_layers(t, cfg, DEPTH_1B_EARLIER)[0] for t in (p32, int8["params"]))
    decoding_1b(tfa, StarVectorForCausalLM(s16, cfg_cut, policy=bf16, device=dev), cfg_cut, s16,
                s32, sq16, dev, card)
    phase("4c", f"StarVector-1B continuous-batching serving, {DEPTH_1B_EARLIER} of {L} layers")
    t_4c = time.perf_counter()
    serve_1b = serving_1b(tfa, cfg_cut, s16, s32, sq16, dev, card, args.profile)
    t_4c = time.perf_counter() - t_4c
    log("phase", f"4c took {t_4c:.0f} s")
    phase("4d", f"StarVector-1B eval harness, {DEPTH_1B_EARLIER} of {L} layers")
    t_4d = time.perf_counter()
    eval1b = eval_1b(tfa, cfg_cut, s16, s32, dev, card)
    t_4d = time.perf_counter() - t_4d
    log("phase", f"4d took {t_4d:.0f} s")
    phase("4e", f"StarVector-1B offline pipelined generation, {DEPTH_1B_EARLIER} of {L} layers")
    t_4e = time.perf_counter()
    pipe_1b = pipelined_1b(tfa, cfg_cut, s16, s32, sq16, dev, card, args.profile)
    t_4e = time.perf_counter() - t_4e
    del s16, s32, sq16
    log("phase", f"4e took {t_4e:.0f} s")
    phase("4f", "the other vision towers behind the StarVector-1B decoder")
    t_4f = time.perf_counter()
    towers = towers_1b(sv, tfa, dc, cfg, p16, p32, dev, card)
    t_4f = time.perf_counter() - t_4f
    log("phase", f"4f took {t_4f:.0f} s")
    if args.profile is not None:
        profile_request(request, card, args.profile)
        profile_request(int8["request"], card, args.profile, "int8")
    int8_counts = int8["counts"]
    del int8, t2s
    # the 1B inference trees go, so that phases 5 and 6 hold only their own
    clip_images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch
    del model, m32, p16, p32, request, logits, ref32
    gc.collect()
    torch.cuda.empty_cache()
    grpo_phase(sv, tfa, cfg, dev, card)
    log("phase", f"4b took {time.perf_counter() - t_4b - t_4c - t_4d - t_4e - t_4f:.0f} s (4c, "
                 f"4d, 4e and 4f apart)")
    gc.collect()
    torch.cuda.empty_cache()

    # --- 5. training at full width ----------------------------------------------
    phase(5, "StarVector-1B training")
    train = train_slice(sv, tfa, dev, clip_images)

    # --- 5b. the trained 1B out as an HF checkpoint and back in ------------------
    phase("5b", "the export round trip")
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        export_round_trip(sv, tfa, dev, train, clip_images(synthetic_images(2, 7)),
                          str(work / "ckpt"))
        cfg1 = sv.starvector_1b_config()
        fp32_check(sv, tfa, dev, cfg1, training_batch(cfg1, clip_images, dev), "1B")
        gc.collect()
        torch.cuda.empty_cache()

        # --- 5c. the quickstarts and the web UI on 5b's checkpoint ---------------
        phase("5c", "the quickstarts and the web UI on the exported 1B")
        t_5c = time.perf_counter()
        entry = entry_points_1b(tfa, dev, card, str(work / "ckpt"), work)
        log("phase", f"5c took {time.perf_counter() - t_5c:.0f} s")

        # --- 5d. the GRPO driver ---------------------------------------------------
        phase("5d", "the GRPO driver at full 1B width and depth")
        t_5d = time.perf_counter()
        grpo_run = grpo_driver_1b(tfa, dev, card, work)
        log("phase", f"5d took {time.perf_counter() - t_5d:.0f} s")

        # --- 5e. train.main on an NCCL process group of one rank --------------------
        phase("5e", "train.main in an NCCL process group of world size 1 (fsdp: -1) against "
                    "one plain process, full 1B")
        t_5e = time.perf_counter()
        mesh_run = mesh_train_1b(tfa, dev, card, work)
        log("phase", f"5e took {time.perf_counter() - t_5e:.0f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # --- 5f. sequence parallelism's per-rank attention at the 8B's width ----------
    phase("5f", "sequence-parallel attention, rank by rank, at StarVector-8B's width")
    t_5f = time.perf_counter()
    sp_run = sequence_attention_8b(tfa, dev, card)
    log("phase", f"5f took {time.perf_counter() - t_5f:.0f} s")

    # --- 5g. tensor-parallel training: gloo ranks on the card against one process --
    phase("5g", "tensor- and pipeline-parallel training, 1b-fsdp2-tp2, 1b-stage2-fsdp2 and "
                "8b-tp4, gloo ranks on one card against one process")
    tpt = tensor_training(sv, tfa, dev, card, clip_images)
    gc.collect()
    torch.cuda.empty_cache()

    # --- 6. StarVector-8B inference at full width ---------------------------------
    phase(6, f"StarVector-8B inference, {DEPTH_8B} of 32 layers")
    s8 = slice_8b(sv, tfa, dev, card, args.profile)

    # --- 6b. StarVector-8B training at full width, 8 layers -------------------------
    phase("6b", "StarVector-8B training")
    t8 = train_slice_8b(sv, tfa, dev)

    # --- 6c. the 8B's own recipe at full depth -----------------------------------
    phase("6c", "StarVector-8B training, its own recipe at full depth")
    recipe = train_recipe_8b(sv, tfa, dev, card, t8["batch"])

    # --- 7. kernel times on the card -----------------------------------------
    phase(7, "times")
    kernels_json = []
    g = torch.Generator(device=dev).manual_seed(3)
    B, P, T, H, D = 4, 261, 261 + 128, 16, 128
    q = torch.randn((B, P, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.zeros((B, T), dtype=torch.int32, device=dev)
    mask[:, :P] = 1
    times = _turns(lambda: tfa.flash_prefill(q, k, v, mask, kernels=False),
                   lambda: tfa.flash_prefill(q, k, v, mask))
    # the visible keys are 0..P-1, causal from q_offset 0: SDPA on those
    lib = sdpa_ms(q.transpose(1, 2).contiguous(),
                  *(t[:, :P].transpose(1, 2).expand(B, H, P, D).contiguous() for t in (k, v)),
                  causal=True)
    # q and out, then K/V and the mask over the P keys the causal bound lets
    # the kernel read (the slots from P to T are never visible)
    nbytes = 2 * B * P * H * D * 2 + 2 * B * P * D * 2 + B * P * 4
    flops = 4 * D * H * B * P * (P + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill B=4 S=261 T=389 H=16 Hkv=1 D=128 bf16: kernel "
                 f"{times[1]:.4f} ms ({flops / times[1] / 1e9:.1f} TFLOP/s, "
                 f"{b_ms / times[1]:.1%} of the bound), plain {times[0]:.4f} ms, bound "
                 f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                 f"SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    s1026 = tower_prefix_times(tfa, dev, card) if TIMINGS else None
    kernels_json.append(dict(name="flash_prefill", route="cuda",
                             source="starvector_tpu_torch/csrc/flash_prefill.cu",
                             replaces="starvector_tpu/ops/flash_attention.py:212",
                             launches=n_prefill, max_abs_err=err_prefill,
                             ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib,
                             serve_launches=serve_1b["launches"]["flash_prefill"],
                             eval_launches=eval1b["launches"]["flash_prefill"],
                             pipelined_launches=pipe_1b["launches"]["bf16"]["flash_prefill"],
                             pipelined_spec_launches=pipe_1b["launches"]["spec"]["flash_prefill"],
                             s1026=s1026))
    decode = decode_times(tfa, dc, dev, card)
    for label, name, launches, err in (
            ("bf16", "decode_attention", n_decode, err_decode),
            ("int8", "decode_attention_int8", int8_counts["decode_attention_int8"], err_int8)):
        kernels_json.append(dict(name=name, route="cuda",
                                 source="starvector_tpu_torch/csrc/decode_attention.cu",
                                 replaces="starvector_tpu/ops/flash_attention.py:2049",
                                 launches=launches, max_abs_err=err, **decode[label],
                                 bounds_max_abs_err=err_bounds,
                                 serve_launches=serve_1b["launches"][name],
                                 pipelined_launches=pipe_1b["launches"][
                                     "bf16" if label == "bf16" else "int8 KV"][name],
                                 **({"eval_launches": eval1b["launches"][name]}
                                    if name in eval1b["launches"] else {})))
    qmm = quant_matmul_times(tq, dev, card)
    for path, count in (("gemv_tc", "quant_matmul_gemv_tc"), ("gemv", "quant_matmul_gemv"),
                        ("tile", "quant_matmul_wgmma")):
        kernels_json.append(dict(name=f"quant_matmul_{path}", route="cuda",
                                 source="starvector_tpu_torch/csrc/quant_matmul.cu",
                                 replaces="starvector_tpu/ops/quantization.py:139",
                                 launches=int8_counts[count] + (
                                     int8_counts["quant_matmul_gemv_fp32"] if path == "gemv"
                                     else 0), max_abs_err=err_qmm[path],
                                 **qmm[path],
                                 serve_launches=serve_1b["launches"][f"quant_matmul_{path}"],
                                 pipelined_launches=pipe_1b["launches"][
                                     "int8 weights + int8 KV"][count],
                                 **({"m144": qmm["tile_m144"]} if path == "tile" else {})))

    # the launches of phases 4f, 5c and 5d beside each kernel they ran
    for row in kernels_json:
        if row["name"] in ("flash_prefill", "decode_attention"):
            row["tower_launches"] = {t: r["launches"][row["name"]] for t, r in towers.items()}
            row["entry_launches"] = {k: v[row["name"]] for k, v in entry.items()}
    kernels_json += training_times(tfa, dev, card, train, err_train)
    for row in kernels_json:
        if row["name"] in grpo_run["launches"]:
            row["grpo_driver_launches"] = grpo_run["launches"][row["name"]]
        if row["name"] in TRAIN_KERNELS:  # phase 5e's run, all its steps; 5f's ranks
            row["mesh_launches"] = mesh_run["launches"][row["name"]]
            row["sp_launches"] = sp_run["launches"][row["name"]]
            row["tp_train_launches"] = {case: r["launches"][row["name"]]
                                        for case, r in tpt.items()}
    kernels_json += times_8b(tfa, dc, tq, dev, card, s8, err_8b)
    launches_tp = tp_counts(s8["tp"])
    for row in kernels_json:  # phase 6e's launches, every rank's, beside each kernel's row
        counter = next((c for c in ("decode_attention_int8", "decode_attention",
                                    "flash_prefill_with_lse", "flash_bwd_dkdv", "flash_bwd_dq",
                                    "flash_prefill", "quant_matmul") if row["name"].startswith(c)),
                       None)
        if counter is not None:
            row["tp_launches"] = launches_tp[counter]
    kernels_json += tp_times(tfa, dc, dev, card, s8["tp"], err_8b)
    kernels_json += training_times_8b(tfa, dev, card, t8, err_train)
    kernels_json += tp_training_times(tfa, dev, card, tpt, err_train)
    if TIMINGS:
        t_times = time.perf_counter()
        long_context_times(tfa, dev, card)
        head_split_times(tfa, dev, card)
        timed_only("phase 7's long-context and head_split sweeps", t_times)

    if args.profile is not None:
        for label, run, cfg_t in (("1B", train, cfg1), ("8B", t8, t8["cfg"])):
            batch = t8["batch"] if label == "8B" else training_batch(cfg1, clip_images, dev)
            step_wall = statistics.median(r["seconds"] for r in run["recs"][3:])
            profile_train_step(sv, tfa, dev, cfg_t, batch, card, step_wall, args.profile, label)
        profile_train_step(sv, tfa, dev, recipe["cfg"], t8["batch"], card, recipe["step"],
                           args.profile, "8B recipe", **recipe["run"])

    phase("done", "every phase")
    log("phase", "seconds a phase: " + ", ".join(f"{n} {sec:.0f}" for n, _, sec in took[:-1]))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "starvector_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in the JAX package: {leaked}")
    print(card)
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):  # the convolutional towers' levels and blocks
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _cast_tree(tree, dtype):
    """The tree in `dtype`, but for BatchNorm statistics, int8 codes and
    the fp32 scales of a quantized leaf."""
    if isinstance(tree, dict):
        keep = ("running_mean", "running_var") + (("scale",) if "kernel_q" in tree else ())
        return {k: (v if k in keep else _cast_tree(v, dtype)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree if tree.dtype == torch.int8 else tree.to(dtype)


def _turns(plain, kernel) -> tuple[float, float]:
    """(plain ms, kernel ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain."""
    a = cuda_ms(plain)
    b = cuda_ms(kernel)
    c = cuda_ms(kernel)
    d = cuda_ms(plain)
    return (a + d) / 2, (b + c) / 2


if __name__ == "__main__":
    sys.exit(main())
