"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository's
``src/`` beside this file; it imports ``torch``, ``numpy`` and
``repro_torch`` only. Phases, each of which raises on failure:

  1. device: require a card; print ``nvidia-smi``'s name and power limit;
  2. build: compile every kernel under ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain: each whisper kernel against its plain PyTorch
     version on the card, at the shapes whisper-medium serving gives it
     (row 1 in float32 and bfloat16) and at edge shapes (ragged tiles, K in
     {1, 3, 5, 7}, stride 3, lengths 0 and S,
     G in {1, 2, 4, 8}, float32 and bfloat16); rows 2 and 2b at the split
     design's edges (float32, bfloat16 and int8 caches, G in {1, 7, 8}, D
     in {64, 128, 256}, lengths 0, 1, a split boundary +- 1 and S, two
     calls bitwise equal);
  4. smoke serve, card vs CPU: whisper smoke config (float32), one set of
     weights; equal greedy tokens and prefill logits within tolerance;
  5. full-width serve: whisper-medium (24+24 layers, d 1024, bf16, random
     weights from a seeded generator), B=4, P=256, 32 tokens, with the
     kernels' launch counts checked over that one request;
  6. times: each kernel at the serving shapes beside its plain version,
     one PyTorch library call computing the same function, and the card's
     bound for the work; row 1 in float32 and in bfloat16, the type
     whisper serves in (``F.conv1d`` in the same type). ``ms`` is card time per call from CUDA events,
     median of 20 batches of 10 calls after warm-up, with the card's queue
     filled first so that the host's queueing time does not count;
     ``call_ms`` is the same without the filled queue (host time
     included);
  7. train kernels vs plain: the dw/db kernel against its plain version at
     the full-width frontend shapes (B=4, 512 mel frames; conv1 80->1024
     stride 1, conv2 1024->1024 stride 2) and at edge shapes (K in
     {1, 3, 5, 7, 20}, stride in {1, 2, 3}, ragged Lout, Cin 37, with and
     without bias, float32 and bfloat16); the forward kernel's saved
     pre-activation z; the whole conv autograd Function on the card against
     the same Function on the plain versions, grads of the four frontend
     leaves of the full-width frontend under one fixed cotangent;
  8. smoke train, card vs CPU: whisper smoke config (float32), one set of
     weights, 4 steps through the conv kernels: losses within 1e-4
     relative on card and CPU (or within three times what summing the
     convs in another order moves them on the CPU, where that is more),
     falling as the reference's smoke test asks;
  9. full-width train: whisper-medium (24+24 layers, d 1024, bf16 params,
     float32 Adam moments, remat per block), mel frontend through the
     kernels, B=4, seq 512, 10 steps: finite losses, frontend weights that
     moved, the kernels' launch counts per step checked; step ms (median
     after 2 warm-up steps), tokens/s, peak device memory, and the card's
     busy share of a step (profiler, device kernels only);
 10. train times: the dw kernel at the two full-width shapes beside its
     plain version, ``torch.nn.grad.conv1d_weight`` (cuDNN, TF32 off) and
     the bound, timed as in phase 6;
 11. int8 conv kernel vs plain: the w8a8 and w8a16 sliding conv kernel
     against its exact plain version (int8 sums in float64 on the card) at
     the full-width frontend shapes (conv1 80->1024 stride 1, conv2
     1024->1024 stride 2, B=4, L=514) and at edge shapes (K in
     {1, 3, 5, 7, 17, 20}, stride 1 and 2, Cin 37 and 80, every
     activation), requant off and on: float32 outputs within 1e-5, int8
     codes equal but for ties (see ``codes_close``);
 12. int8 attention kernel vs plain: the decode-attention kernel over an
     int8 cache at the serving shape and the edges of phase 3, a length-0
     slot giving a zero row, rows past a length zero-padded;
 13. int8 smoke serve, card vs CPU: whisper smoke config (float32),
     ``--quant int8 --kv-quant int8``, one set of quantized weights: equal
     greedy tokens, prefill logits within tolerance, conv1's int8 codes as
     in phase 11, one dequant site in the frontend;
 14. full-width int8 serve: whisper-medium as in phase 5 with
     ``--quant int8 --kv-quant int8``: the calibration prefill (the fp conv
     kernel, twice), then one request (the int8 conv kernel twice, the int8
     attention kernel 48 times a decode step), with launch counts checked
     and TTFT, decode step, tokens/s, card busy share, peak memory and the
     cache bytes printed;
 15. int8 times: the int8 conv kernel at the two full-width shapes beside
     its plain version and ``torch._int_mm`` on the input unfolded ahead
     plus the epilogue in torch; the int8 attention kernel beside its plain
     version and a dequantized cache through
     ``F.scaled_dot_product_attention``; each with its bound, timed as in
     phase 6;
 16. depthwise kernels vs plain: the depthwise conv kernel at mamba's
     prefill shape in jamba-1.5-large ((4, 259, 16384) bf16, K 4, bias,
     silu) and at edge shapes (K in {2, 3, 4, 5}, stride 1 and 2, C 37,
     600 and 1032, L shorter than a tile, bias or none, none or silu, an
     unaligned base, float32 and bfloat16): float32 within 1e-6 of max |y|,
     bfloat16 within one bf16 step; the int8 depthwise kernel, w8a8 and
     w8a16, float and requantized outputs, at the same shapes; both at the
     prefill shape planned for a card of 2 SMs (16 persistent blocks each
     walking 256 items); the attention kernel, fp and int8, at jamba's
     (B 4, S 288, KV 8, G 8, D 128) with a length-0 slot;
 17. jamba smoke serve, card vs CPU: jamba's smoke config (float32), one
     set of weights, fp and ``--quant int8 --kv-quant int8``, each held to
     what one float32 step of weight jitter does on the CPU (see
     ``phase_smoke_serve_jamba``), every int8 conv of the card's prefill
     held to its plain version on the card's own inputs;
 18. full-width jamba serve: jamba-1.5-large cut to one period (7 Mamba
     blocks, 1 attention) and no experts, every width the published one
     (8,999,034,880 parameters, bf16, random from a seed), B=4, P=256, 32
     tokens, fp and then ``--quant int8 --kv-quant int8`` on the same
     weights: launches checked, TTFT, decode step, tokens/s, busy share,
     peak memory, cache bytes and max |x| after each layer (the random
     model collapses after its first layer: see PERF.md);
 19. jamba times: the depthwise kernels' plans on this card, then the
     kernels at mamba's prefill shape beside their plain versions, a
     library call (``F.conv1d(groups=C)`` + silu;
     for int8, which no PyTorch call computes, the codes widened to bf16
     ahead, then ``F.conv1d(groups=C)`` and the epilogue in torch) and the
     bound; the attention kernels at G=8, D=128 beside their plain versions
     and SDPA (``enable_gqa``);
 20. depthwise training kernels vs plain: the depthwise dw kernel at a
     full-width jamba training step's shape (x (2, 515, 16384), dz (2, 512,
     16384), K 4, with db, float32 and bfloat16) and at edge shapes (K in
     {1, 2, 3, 4, 5, 9}, stride 1 and 2, C 37, 600 and 16384, ragged Lout
     and Lout shorter than an item, bias or none, an unaligned base,
     float32 and bfloat16); the forward kernel's saved pre-activation z;
     the whole ``Conv1dDepthwise`` on the card against the same Function
     on the plain versions, grads of x, w and bias under one cotangent;
 21. jamba smoke train, card vs CPU: jamba's smoke config (float32) with
     int8 moments, one set of weights rescaled to std 1/sqrt(input width),
     4 steps through the depthwise kernels, the losses held to a CPU
     control as in phase 8, launches per step checked;
 22. full-width jamba train: phase 18's cut (8,999,034,880 params, bf16),
     int8 moments, remat per position, B=2, 512 tokens, 6 steps, on the
     reference's init rescaled to std 1/sqrt(input width): finite losses,
     a nonzero conv_w gradient in each of the 7 Mamba blocks, conv_w
     moved, launches per step checked (21 forward depthwise, 7 dw); step
     ms, tokens/s, peak memory, busy share and top kernels;
 23. jamba training times: the depthwise plans and the dw kernel's plan
     (``gemm_plan.depthwise_dw_plan``, bf16 and f32) at the training shape
     on this card; the dw kernel there beside its plain version,
     ``torch.nn.grad.conv1d_weight(groups=C)`` and the bound; the forward
     depthwise kernel there with z written and without, each beside its
     bound, and cuDNN's ``F.conv1d(groups=C)`` + bias + silu.
 24. conv2d kernel vs plain: the 2-D sliding conv kernel against its plain
     version at llava's patch embedding (x (20, 336, 336, 3), w (14, 14,
     3, 1152), stride 14, bias or none), at the fig1 shapes ((1, 128, 128,
     32) x (k, k, 32, 32), k in {3, 5, 17, 31}) and at edge shapes
     (strides (2, 2), (2, 1), (1, 3), (3, 2), k in {1, 3, 5, 7, 20}, Cin 37,
     Cout 70, every activation), bfloat16 within one bf16 step and float32
     within TOL; the attention kernel at llava's decode shape (B 4, S 3168,
     KV 8, G 7, D 128) with a length-0 slot;
 25. llava smoke serve, card vs CPU: llava's smoke config (float32), one
     set of weights, image tiles through ``patch_embed`` (the 2-D kernel on
     the card), then a request with those patches: equal greedy tokens,
     patches and prefill logits within TOL, launches checked;
 26. full-width llava serve: llava-next-34b cut to 40 of its 60 layers,
     every width the published one (23,291,426,816 params, bf16, the
     reference's init rescaled to std 1/sqrt(input width)), B=4 slots of 5
     image tiles (2,880 patches) through ``patch_embed`` (one conv2d
     launch), P=256, 32 tokens (1,240 attention launches): TTFT with the
     patch embedding's share, decode step, tokens/s, busy share, peak
     memory, the kernels against their plain versions on the same request;
     then one request through the CLI's own path (zero patches), its TTFT;
 27. llava times: the conv2d kernel at the patch embedding (bf16, the main
     path's call, and f32) and at the fig1 shapes (f32, bias + gelu)
     beside its plain version, ``F.conv2d`` on channels_last (cuDNN, TF32
     off) and the bound; the attention kernel at llava's decode shape
     beside its plain version and SDPA (``enable_gqa``).
 28. int8 conv2d kernel vs plain: at the patch embedding (w8a8 with the
     model path's bf16 output, f32 and requantized outputs; w8a16 bf16 and
     f32), at fig1 (k 3, 5, 17, 31) and fig2 (k 3, 17) and at edge shapes
     (k in {1, 3, 5, 7, 20}, strides (2, 2), (2, 1), (1, 3), (3, 2), Cin
     37 and 130, every activation): f32 within 1e-5 of max |y|, bf16
     within one bf16 step of the plain f32 value, requantized codes equal
     (w8a8, no activation) or one apart at ties; the int8 attention kernel
     at llava's decode shape (G=7, D=128, S=3168) with a length-0 slot;
 29. conv2d training kernels vs plain: the 2-D dw kernel at the patch
     embedding (bf16 and f32), fig1 (k 3, 9, 31), fig2 (k 3, 17) and edge
     shapes; the 2-D kernel's saved pre-activation z; the whole
     ``Conv2dSliding`` at the grad/fig shapes with dx (strides 1 and 2,
     activations none, relu, gelu), kernels against the plain versions,
     launches checked (2 conv2d, 1 dw);
     phase 26 then also serves the int8 request on its weights: the patch
     embedding and projector calibrated on the request's tiles, w8a8
     patch embedding (one ``conv2d_quant`` launch), an int8 cache (1,240
     int8 attention launches at G=7, D=128, S=3168): TTFT, decode step,
     tokens/s, busy share, cache bytes against fp's, peak memory; and the
     chained variant once (one dequant site, ``llava/projector``);
 30. the patch-embedding training step at full width: x (20, 336, 336, 3)
     bf16 through ``patch_embed`` on ``Conv2dSliding`` into the projector
     (1152 -> 7168 -> 7168), squared distance to a fixed target, a descent
     step of 0.1% of each leaf's norm: 1 forward conv,
     1 dw kernel, no dx conv a step; grads held to the plain versions';
     step ms, peak memory, busy share;
 31. llava int8 smoke serve, card vs CPU (quantized patch embedding, int8
     cache, one set of weights), and the CLI's own ``--arch
     llava-next-34b --smoke --quant int8 --kv-quant int8`` on both;
 32. int8 conv2d and 2-D dw times: each kernel at the patch embedding and
     at fig1 / fig2 beside its plain version, one library call
     (``torch._int_mm`` on the unfolded input + epilogue; w8a16
     ``F.conv2d`` on the widened codes; ``torch.nn.grad.conv2d_weight``)
     and the bound; the int8 attention kernel at llava's decode shape.
 33. GEMM baselines vs plain: the tiled GEMM (row 5) at ragged shapes
     ((200, 70) @ (70, 90), (333, 517) @ (517, 65), ...), the fused 1-D
     and 2-D im2col kernels (rows 6, 7) and the hbm baselines (the column
     by torch ops, then row 5) at the reference tests' filters (K 3, 7,
     17; (3, 3, 1), (5, 5, 2), (7, 5, (2, 3))), strides 1-3, Cin 3 and 37,
     and at phase 35's shapes, float32 within 1e-5 of max |y|, bfloat16
     within one bf16 step + 1e-5 of max; ``ops.conv1d`` / ``ops.conv2d`` on
     every backend and padding with bias + gelu, each call's launches
     counted (one of row 6, 7 or 5 on the baselines); ``ops.matmul``; calls
     needing a gradient raise; a ``QuantizedWeight`` built from
     calibration's CPU scales runs through ``ops.conv2d`` on the card;
     then the slice's main path: ``ops.conv2d`` at fig1 and fig2 and
     ``ops.conv1d`` at the companion 1-D table on ``im2col_gemm`` and
     ``im2col_hbm`` and one ``ops.matmul`` (6, 3 and 10 launches);
 34. whisper smoke served through ``--conv-backend im2col_gemm`` on the
     card against ``sliding_pallas`` from the same weights: equal tokens,
     prefill logits within TOL, equal CLI samples; jamba raises;
 35. the paper's comparison: at fig1, fig2, the companion 1-D table
     ((1, 16384, 32) x (K, 32, 32), K 3, 17, 65), whisper's frontend and
     llava's patch embedding (bf16, f32), the sliding kernel (row 1 or 4),
     row 6 or 7, the hbm baseline (its column and row 5 timed apart),
     cuDNN, row 5 against ``torch.matmul`` at the column's shape, the
     plain version and the bounds; one line per shape with the ratio
     sliding : im2col_fused : im2col_hbm : cuDNN.
 36. pool kernels vs plain: row 8 (sum, avg, max scan, max shift), row 8
     on the padded cotangent (the sum gradient) and row 9 (the max
     gradient, one launch) at the companion paper's pooling shape (1,
     16384, 32) f32 and bf16, w in {4, 16, 64, 256}, and at edges (w = 1,
     w = L, (1, 300, 8) at w 100 and 256, (8, 16384, 1), C 37 with ragged
     blocks, row 9's lanes of 4 blocks, (2, 3000, 37) at w 2000, where
     row 8's blocks stream their halos; row 9 alone with its slots in
     global scratch; (8, 2000, 1024) at w 200 in bf16) on normals, zeros
     and post-relu normals: f32 within 1e-5 of max, bf16 within one step,
     sum, avg and the sum gradient bit for bit equal to their plain
     versions, max exact and scan equal to shift, the max gradient's mass
     conserved; a float16 call refused;
 37. scan kernel vs plain: row 16 at jamba-1.5-large's prefill chunk (4,
     256, 16384, 16) f32 (row 16's path: one launch, counted from zero)
     and bf16, and at L in {1, 37}, D 200, N in {4, 8, 16, 17, 20, 65,
     128};
 38. the pooling path: ``ops.pool1d`` forward and backward through
     ``Pool1d`` at (1, 16384, 32) f32, sum, avg and max at each window,
     launches counted per call and over the path, against the same calls
     on CPU tensors; ``ops.conv1d(backend="sliding")`` on one row-1 launch;
 39. pooling and scan times: rows 8 and 9 at the paper's shape (every
     window) and at (8, 16384, 1024) f32 w 16 beside their plain versions,
     ``F.avg_pool1d`` / ``F.max_pool1d`` / autograd of ``F.max_pool1d``
     and the bound; row 16 at the jamba chunk (f32, bf16) beside its plain
     version, the port's associative scan and the bound.
 40. row 2 over a float32 cache at whisper's, jamba's and llava's decode
     shapes beside its plain version, SDPA (float32) and the bound; then
     each redesigned row (2, 2b, 9, 5, 12, 4, 14, 7, 8, 1, 6, 13, 10, 3,
     15, 11) at each timed shape beside its time before the redesign
     (``EARLIER_MS``): row 5 at the five hbm columns phase 35 times it on,
     row 12 at phase 32's five shapes, row 4 at phase 27's six, row 14 at
     phase 32's seven, row 7 at phase 35's eight 2-D shapes, row 8's forms
     and the sum gradient at phase 39's shapes timed before, row 1 at
     phase 6's four (f32 and bf16), row 6 at phase 35's five 1-D shapes,
     row 13 at phase 15's two, row 10 at phase 10's two, row 3 at phase
     19's prefill shape and phase 23's training shape (z and not), row 15
     at phase 19's, row 11 at phase 23's.
 41. the port's train CLI for llava (``--arch llava-next-34b --smoke
     --steps 2 --batch 2 --grad-accum 1 --seq 32``) on the card: finite
     losses.
 42. the traced serve CLI at full width: ``--arch whisper-medium --batch 4
     --prompt-len 256 --gen 32 --kv-quant int8 --conv-backend
     sliding_pallas --requests 2 --run-dir build/chip_smoke_obs --trace``
     through ``serve.main``, its launches counted from zero: CI's checks
     of ``metrics.json`` and ``trace.json``, the report's needles
     (``python -m repro_torch.obs report``), every journaled begin closed
     by its end, equal samples of the two requests, rows 1 and 2b
     launched as counted by their wrappers and by ``dispatch.calls`` under
     rung ``cuda``; then the same command without ``--trace`` before and
     after it, and the decode step's p50 armed and disarmed (record only,
     nothing gates on it);
 43. the traced train CLI: ``--arch whisper-medium --smoke --steps 3
     --batch 2 --seq 64 --audio-frontend mels --conv-backend
     sliding_pallas --trace``, its launches counted from zero: rows 1 and
     10 launched, three ``train.step`` spans, ``train.step_s`` count 3, a
     finite ``train.loss``, the report's train lines.
 44. rows 2 and 2b against their plain versions at qwen3-moe's serving
     shape (KV 4, G 8, D 128; bf16 and int8 caches) and row 2 at that of
     llama3-8b, granite-8b and phi3.5-moe (KV 8, G 4, D 128; bf16), at
     the serving lengths; then smoke serve of the remaining decoders, card
     vs CPU: gemma-2b, llama3-8b, granite-8b, qwen3-moe-30b-a3b and
     phi3.5-moe-42b-a6.6b at their smoke configs (float32), one set of weights each: equal greedy
     tokens, prefill logits within tolerance, row 2 launched once a layer
     a decode step on the card;
 45. qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts
     top-8, bf16, drawn on the card in float32 draws of at most
     ``sharding.MAX_DRAW`` elements, rescaled to std 1/sqrt(input
     width)): its exact parameter count, then one request (B=4, P=256, 32
     tokens, greedy) fp and the same request with an int8 cache on the same weights, rows 2
     and 2b at 48 x 31 launches; init peak, the request's peak memory
     (under the card's), TTFT, decode step, tokens/s, busy shares, cache
     bytes, and how many of the T*K expert copies the capacity dropped in
     a prefill and in a decode step;
 46. gemma-2b, llama3-8b, granite-8b whole and phi3.5-moe-42b-a6.6b cut to
     24 of its 32 layers, at their published widths, one after another
     (each freed before the next): the exact parameter count and one fp
     request each as in phase 45, row 2 at layers x 31 launches; and,
     among the timings after phase 40, row 2 at gemma's serving shape (B=4,
     S=288, one KV head, G=8, D=256, bf16 cache) beside its plain
     version, SDPA (``enable_gqa``) and the bound.
 47. tuning: ``REPRO_TORCH_AUTOTUNE_CACHE`` pointed at a fresh temporary
     file (restored after, so every other phase runs the rule), then the
     seven searches of ``kernels/autotune.py`` at the reference
     benchmark's ``autotune/*`` shapes (conv2d at fig1 k 3, 9, 31 and
     fig2 k 3, 17 f32; conv1d (1, 16384, 32) K 3, 33 fp and w8a8; max
     pooling there at w 4, 256; the int8 decode read at (B 2, S 2048, KV
     2, G 2, D 32)) and at the model paths' (row 1 bf16 at whisper's conv1
     and conv2, row 10 at conv2 bf16 and f32; rows 3 and 15 at jamba's
     prefill, row 11 with row 3 at its training shape; rows 2 and 2b at
     qwen3-moe's and llava's serving shapes; rows 4, 14 and 12 at llava's
     patch embedding): each key's ``default_us``, ``us``, winner and
     candidates timed on a line, the entry called through ``ops`` with the
     cache armed, its launch running the recorded plan (the wrappers'
     ``last_plan``, row 8's form counters), its output (a gradient: the
     weight-gradient kernel's own, on its spied inputs) held to the plain
     version at its row's tolerance, the tuned and untuned dispatch timed;
     then the quant guard: a float-input ``ops.conv1d(precision="w8a8")``
     at each conv1d shape launches row 1 with one ``quant_slower`` event
     where fp won (the w8a8 entry's ``dispatch_us``, its winner timed
     through that call, above fp's ``us``; held to row 1's plain
     version), row 13 and none where w8a8 won; the float-input w8a8 call
     (pinned by its plan where fp won) held to row 13's plain version on
     the operands quantized as ``ops`` quantizes them. The searches rank
     their plans on the H100 roofline and prune on the launch contracts
     (``repro_torch.analysis``); the cache file is kept for phase 52. The
     JSON record gains ``tuned`` (key -> default_us, us, dispatch_us,
     winner, timed, the dispatch times).
 48. rwkv6-1.6b at its published widths and depth (24 layers, d 2048,
     d_ff 7168, vocab 65,536, bf16, 1,599,719,424 parameters drawn from a
     seed and rescaled to std 1/sqrt(input width)): one request of B 4,
     P 256 (two whole 128-position WKV chunks), 32 tokens, greedy, with
     TTFT, decode step, tokens/s, cache bytes, peak memory and busy share
     (no kernel: the model is plain PyTorch, every counter stays 0); two
     more requests give the same tokens; each bf16 layer and the head held
     to the same code on a float32 copy of the weights, on the bf16 run's
     own input (the whole prefill's drift recorded); then 3 train steps at
     B 2 x 512 through the train core: finite losses, step ms, peak memory;
 49. the edge CNN (``examples/edge_cnn_torch.py``): step 0's loss and
     every gradient on ``sliding_pallas`` (rows 4 and 12) against the
     plain versions and against ``sliding``; 200 SGD steps of B 64 each on
     ``sliding``, ``im2col_gemm`` and ``sliding_pallas``, test accuracy
     above 0.9, the median step from CUDA events and one profiled step;
     on ``sliding_pallas`` the int8 chain (calibration, ``quantize_net``,
     w8a8 evaluation): dequant sites ['edge/c3'], accuracy within 2% of
     float32, row 14 held to its plain version at the chain's shapes; the
     counters over that run: 5 row-4 and 3 row-12 launches a step, 6 row-4
     for the evaluation and calibration, 3 row-14;
 50. the other example ports through their ``main``: the quickstart on
     the card (row 1 against ``core.conv1d``, the Fig. 1 point at k 17 on
     rows 4 and 7 by ``card_ms``), serve_decode on qwen3-1.7b and
     rwkv6-1.6b (smoke configs, two requests with equal tokens), train_lm
     at 10m for 30 steps (its loss must fall); the counters must show rows
     1, 4, 7 and 2;
 51. chaos: CI's two chaos steps on the serve CLI at whisper-medium's full
     width (B 2, P 16, 8 tokens, ``--conv-backend sliding_pallas``): a
     clean run (no ``health:`` line), ``REPRO_FAULTS=pallas_compile:conv1d``
     (``demote:cuda->plain``, row 1 never launched, every conv1d on
     ``plain``), and ``pallas_runtime:conv1d*1,nan_activations:
     serve/slot.1*1`` with a 4-call cooldown and two journaled requests
     (the runtime demotion, probe and repromotion, slot 1 quarantined, CI's
     metrics and journal checks, row 1 launched exactly 4 times, each
     unquarantined slot's tokens bit for bit those of the run on the same
     rung); ``train.main`` at full width, 3 steps, clean and with a runtime
     trip at step 0 (retried, three optimizer steps, step 0's loss within
     ``CHAOS_LOSS_REL``, then a repromotion); a row-1 wrapper raising a
     ``RuntimeError`` that ``ops.conv1d`` must pass on with no health
     event. The faults, breakers and obs registry are reset around it.
 52. the analysis gate (``repro_torch.analysis``), after 47 and on its
     cache: (a) the card's peaks (bf16 and f32 ``torch.matmul`` at 8192³,
     a 1 GiB copy) beside the data sheet's; (b) the device's shared-memory
     opt-in equal to ``gemm_plan.SMEM_BLOCK`` (232,448 B), no contract
     violation over the full-width key space, every launcher's query entry
     giving each instance's bytes and threads exactly, the over-budget
     row-11 plan flagged by its contract and refused by its plan function;
     (c) five keys (conv1d K 33 f32, whisper's conv2 bf16, fig1 conv2d k
     31 f32, row 11 at jamba's training shape bf16, row 2 at llava's)
     searched exhaustively and ranked: the timed counts, both winners
     re-timed in turns (the ranked one within 5% of the exhaustive one),
     the within-key Spearman rho, the ranked arm timing fewer plans at 3
     of 5 keys at least; (d) each plain rung's largest allocated block
     over its natural size held to the bloat lint's static verdict, rung
     by rung (im2col over alpha, the others under it), its peak memory
     beyond its output reported beside it; (e) ``python -m
     repro_torch.analysis --all`` on (a)'s peaks and 47's cache: exit 0,
     schema 2, a gated family at least, each gated rho >= 0.7, every
     shipped chain safe. The JSON record gains ``analysis``;
 53. the mesh runtime (``launch.mesh.run_ranks``: one spawned process a
     rank, all sharing cuda:0 over gloo, which stages the ranks' CUDA
     tensors through host memory; the parent frees its cache first and
     logs what it still reserves): (a) qwen3-moe-30b-a3b at full width, 4
     of its 48 layers, float32, on (data 2, model 2), each rank 64 of the
     128 experts drawn as its block of the one-rank draw, serving the
     phase-45 prompts two rows a data rank (one prefill, 8 greedy decode
     steps) against the one-rank model on the same rows: logits within
     1e-5 of max at every step (a pick that differs must be a near tie),
     row 2 launched layers x steps on every rank, each rank's peak memory,
     TTFT and decode step beside the one-rank ones; (b) whisper-medium at
     full width and depth, float32, its fan-in weights at std 1/sqrt(input
     width) (``rescale_whisper``), one synced AdamW step of phase 9's
     batch split two rows a rank on (data 2), the global loss and the
     synced gradient within 1e-4 of the one-rank step on the whole batch,
     rows 1 and 10 launched 3 and 2 on each rank, parameter checksums
     equal across ranks after the step; then the error-feedback
     all-reduce of the same local gradients within 0.05 of the exact mean
     with a non-zero carried error, each sync's seconds and bytes; (c) the
     GPipe schedule on those two ranks, two stages of a 1024-wide tanh
     layer, 4 microbatches, within 1e-5 of the sequential composition. A
     rank that fails fails the phase with its traceback. The JSON record
     gains ``mesh``.

Phases run in the order 1-25, 28, 29, 26, 31, 41-43, 51, 30, 44-46, 48-50,
33, 34 with the main path of the baselines, 36-38, 47, 52, 53, then the timings
(6, 10, 15, 19, 23, 27, 32, 35, 39, 40, row 2 at gemma's shape): every
kernel is held to its plain version before a path runs it. Each phase
prints its seconds as it ends, on a ``[chip_smoke] phase <n> <name> <s>``
line (the JSON record's ``phase_s``). Phases 42, 43 and 51 reset the
process-global obs registry,
trace ring, health record and attention log before they run, and disarm
tracing and reset them again after, so no later phase runs armed.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Times are those of the card this runs on,
named on the ``nvidia-smi`` line.
"""
from __future__ import annotations

import contextlib
import gc
import io
import itertools
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port's card timer (``card_ms``: CUDA events, the queue filled first;
# ``call_ms``: the host's time per call in it), which the tuning layer
# times its candidates with too
from repro_torch.kernels.timing import call_ms, card_ms  # noqa: E402
# the H100's data-sheet rates and the full-width shapes of the model paths,
# from the analysis layer, whose contract key space and cost model read the
# same ones
from repro_torch.analysis.contracts import (  # noqa: E402
    ATTN_GEMMA,
    ATTN_GQA4,
    ATTN_JAMBA,
    ATTN_LLAVA,
    ATTN_MAIN,
    ATTN_QWEN_MOE,
    CONV_MAIN,
    DEPTHWISE_MAIN,
    DEPTHWISE_TRAIN,
    PATCH_MAIN,
    SCAN_MAIN,
    TUNE_ATTN_INT8,
    TUNE_CONV1D,
    TUNE_FIGS,
    TUNE_POOL_WINDOWS,
)
from repro_torch.analysis.costmodel import (  # noqa: E402
    H100_HBM_BYTES_S,
    H100_PEAK_OPS,
)

# float32: the kernels sum in another order than the plain versions
# (tests/test_kernels.py TOL); bfloat16 outputs are compared in float32
TOL = dict(rtol=3e-4, atol=3e-4)
BTOL = dict(rtol=5e-2, atol=5e-2)
# the int8 conv's float32 outputs: w8a8 sums are exact, so only the
# activation's last bits differ (tests/test_quant.py TIGHT); w8a16 sums in
# float32 in another order, held to 1e-5 of the largest output
TIGHT = dict(rtol=1e-5, atol=1e-5)
# a bfloat16 output may round the other way: two bf16 steps
QBTOL = dict(rtol=1e-2, atol=1e-2)
# a library call that also rounds to bfloat16 before its activation
# (cuDNN's depthwise conv, then silu): two bf16 steps
LIBTOL = dict(rtol=2 ** -6, atol=2 ** -6)

DEV = "cuda"
SERVE = dict(B=4, P=256, gen=32)  # full-width request
SMOKE = dict(B=2, P=16, gen=8)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str, *,
          scaled: bool = False) -> float:
    """Raise unless got ~= want elementwise (in float32); return max |err|.
    ``scaled``: atol is taken times max(1, max |want|), for sums whose
    terms reach far above 1 (gradients; tests/test_grads.py
    ``_close_scaled``)."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    atol = tol["atol"] * (max(1.0, w.abs().max().item()) if scaled else 1.0)
    bad = err > atol + tol["rtol"] * w.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max "
                             f"|err| {err.max().item():.3e}")
    return err.max().item()


def _profiled(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler (host and CUDA
    activity); return the per-key averages."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _kernel_us(e) -> float:
    """Device time of a profiler entry that is a kernel on the card (host
    ops also report their kernels' time; counting them would count twice)."""
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


# the timing-only phases 32 and 39 (PR 34), 27's conv2d timings and 40 (PR
# 35, beside the larger mesh phase) at half their repeats (card_ms's 20
# batches, and phase 39's 10), so that chip_smoke.py with the mesh phase
# stays inside its time limit on a slow host (PERF.md §6)
HALF_BATCHES = dict(p27=10, p32=10, p39=5, p40=10)


def timings(kernel, plain, library, batches: int = 20) -> dict:
    """The kernel's, the plain version's and the library call's times per
    call: card time from CUDA events (``ms``) and the event time per call
    with the host's time in it (``call_ms``), each a median of
    ``batches``."""
    out = {}
    for pre, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[pre + "ms"] = card_ms(fn, batches=batches)
        out[pre + "call_ms"] = call_ms(fn, batches=batches)
    return out


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for the operand type, the larger
    (the H100 SXM data sheet's, ``analysis.costmodel``)."""
    t_bytes = nbytes / H100_HBM_BYTES_S
    t_ops = ops / H100_PEAK_OPS[str(dtype).removeprefix("torch.")]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def conv_inputs(seed, B, L, Cin, Cout, K, dtype, with_bias=True):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, L, Cin), generator=g, device=DEV).to(dtype)
    w = (torch.randn((K, Cin, Cout), generator=g, device=DEV)
         / (K * Cin) ** 0.5).to(dtype)
    b = torch.randn((Cout,), generator=g, device=DEV) if with_bias else None
    return x, w, b


def attn_inputs(seed, B, S, KV, G, D, dtype, lengths):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, KV, G, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=DEV)


# the serving shapes (CONV_MAIN, ATTN_MAIN): whisper-medium frontend at
# P=256 and the decode reads at S=288, from analysis.contracts


def phase_kernels(sc, ad) -> dict:
    errs = {"sliding_conv1d": 0.0, "sliding_conv1d_bf16": 0.0,
            "attention_decode": 0.0}
    for (name, s), (dtype, tol, key) in itertools.product(
            CONV_MAIN.items(), ((torch.float32, TOL, "sliding_conv1d"),
                                (torch.bfloat16, BTOL, "sliding_conv1d_bf16"))):
        x, w, b = conv_inputs(1, s["B"], s["L"], s["Cin"], s["Cout"], s["K"],
                              dtype)
        args = dict(stride=s["stride"], activation="gelu")
        err = close(sc.conv1d_sliding(x, w, b, **args),
                    sc.conv1d_sliding_plain(x, w, b, **args), tol,
                    f"{name} {dtype}")
        errs[key] = max(errs[key], err)
        log(f"conv {name} {s} {dtype} gelu: max|err| {err:.3e}")
    edge = [(1, 3, "none", True), (3, 3, "gelu", False), (5, 3, "silu", True),
            (7, 3, "relu", True), (3, 1, "gelu", True), (4, 2, "silu", False)]
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BTOL)):
        for K, stride, act, with_bias in edge:
            x, w, b = conv_inputs(K + stride, 3, 203, 37, 70, K, dtype, with_bias)
            what = f"conv edge K={K} s={stride} {act} bias={with_bias} {dtype}"
            err = close(sc.conv1d_sliding(x, w, b, stride=stride, activation=act),
                        sc.conv1d_sliding_plain(x, w, b, stride=stride,
                                                activation=act), tol, what)
            log(f"{what}: max|err| {err:.3e}")

    lens = [0, 1, 127, 288]
    q, k, v, ln = attn_inputs(2, **ATTN_MAIN, dtype=torch.bfloat16, lengths=lens)
    got = ad.decode_attention(q, k, v, ln)
    err = close(got, ad.attention_decode_plain(q, k, v, ln), BTOL,
                "attention bf16 main shape")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("attention: a length-0 slot must give a zero row")
    errs["attention_decode"] = err
    log(f"attention {ATTN_MAIN} bf16 lengths {lens}: max|err| {err:.3e}")
    for G in (2, 4, 8):
        for S, D in ((288, 64), (200, 128), (24, 32)):
            lens = [0, 1, S // 2, S]
            q, k, v, ln = attn_inputs(G * S, 4, S, 2, G, D, torch.float32, lens)
            what = f"attention f32 G={G} S={S} D={D} lengths {lens}"
            err = close(ad.decode_attention(q, k, v, ln),
                        ad.attention_decode_plain(q, k, v, ln), TOL, what)
            log(f"{what}: max|err| {err:.3e}")
    for S, lens, G in ((65, [31, 32, 33, 65], 1), (1, [0, 1, 1, 0], 3)):
        q, k, v, ln = attn_inputs(S, 4, S, 3, G, 64, torch.float32, lens)
        what = f"attention f32 G={G} S={S} D=64 lengths {lens}"
        err = close(ad.decode_attention(q, k, v, ln),
                    ad.attention_decode_plain(q, k, v, ln), TOL, what)
        log(f"{what}: max|err| {err:.3e}")
    attention_edges(ad)
    torch.cuda.synchronize()
    return errs


def attention_edges(ad) -> None:
    """Rows 2 and 2b at the edges of the split design: float32, bfloat16
    and int8 caches, G in {1, 7, 8}, D in {64, 128, 256}, lengths 0, 1, a
    split boundary - 1 and + 1, and S, on a cache of several splits; each
    against its plain version (TOL, BTOL; the int8 cache TOL) and two calls
    bitwise equal."""
    S, KV = 700, 2
    sms = ad.build.sm_count(torch.device(DEV))
    _, rows = ad.decode_splits(5 * KV, S, sms)
    lens = [0, 1, rows - 1, rows + 1, S]
    n = 0
    for G, D in ((1, 64), (7, 128), (8, 128), (8, 256), (1, 256)):
        for kind in ("float32", "bfloat16", "int8"):
            if kind == "int8":
                args = attn_int8_inputs(G + D, 5, S, KV, G, D, torch.bfloat16,
                                        lens)
                tol = TOL
            else:
                dt = getattr(torch, kind)
                args = attn_inputs(G + D, 5, S, KV, G, D, dt, lens)
                tol = TOL if kind == "float32" else BTOL
            what = f"attention {kind} cache G={G} D={D} S={S} lengths {lens}"
            got = ad.decode_attention(*args)
            close(got, ad.attention_decode_plain(*args), tol, what)
            if got[0].abs().max().item() != 0.0:
                raise AssertionError(f"{what}: a length-0 slot must give a "
                                     "zero row")
            if not torch.equal(got, ad.decode_attention(*args)):
                raise AssertionError(f"{what}: two calls differ")
            n += 1
    log(f"attention edges: {n} cases ({rows} rows a split) within tolerance, "
        "each bitwise repeatable")


def phase_smoke_serve(serve, models, configs, map_tree):
    """One set of float32 smoke weights on the CPU and on the card: equal
    greedy tokens, prefill logits within TOL."""
    cfg = configs.smoke_config(configs.get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas")
    model = models.build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = map_tree(lambda t: t.to(DEV), cpu_params)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for dev, params in (("cpu", cpu_params), (DEV, gpu_params)):
        with torch.no_grad():
            logits, _ = serve.prefill_cache(model, params, prompts.to(dev),
                                            cache_len=cache_len)
        toks, _ = serve.generate(model, params, prompts.to(dev),
                                 gen_len=SMOKE["gen"], cache_len=cache_len)
        out[dev] = (logits.cpu(), toks.cpu())
    err = close(out[DEV][0], out["cpu"][0], TOL, "smoke prefill logits")
    if not torch.equal(out[DEV][1], out["cpu"][1]):
        raise AssertionError(f"smoke greedy tokens differ: card "
                             f"{out[DEV][1].tolist()} vs CPU "
                             f"{out['cpu'][1].tolist()}")
    log(f"smoke serve {SMOKE}: greedy tokens equal on card and CPU "
        f"{out[DEV][1].tolist()}; prefill logits max|err| {err:.3e}")


def phase_full_serve(serve, models, configs, map_tree) -> dict:
    cfg = configs.get_config("whisper-medium").replace(
        conv_backend="sliding_pallas", attn_decode="fused")
    model = models.build_model(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    from repro_torch.distributed.sharding import iter_leaves

    n_params = sum(t.numel() for _, t in iter_leaves(params))
    log(f"full width {cfg.name}: {n_params} params ({cfg.param_dtype}), "
        f"{cfg.encoder_layers}+{cfg.num_layers} layers, d {cfg.d_model}, "
        f"init {time.perf_counter() - t0:.2f}s")
    B, P, gen = SERVE["B"], SERVE["P"], SERVE["gen"]
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, P)),
                              dtype=torch.int32, device=DEV)
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    serve.generate(model, params, prompts, gen_len=2, cache_len=cache_len)  # warm-up
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    toks, _ = serve.generate(model, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats)
    wall = time.perf_counter() - t0
    launches = read_launches()

    want = only(sliding_conv1d=2,
                attention_decode=2 * cfg.num_layers * (gen - 1))
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len)
        step, _ = model.decode_step(params, cache, toks[:, :1], P)
    for what, t in (("prefill", logits), ("decode step", step)):
        if t.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError(f"full-width {what} logits not finite / bad shape")
    # the model in float32 (the same random weights, widened): prefill
    # logits through the kernels against the plain versions, and, as the
    # control, against the kernels on mels nudged by one part in a million.
    # Random weights make this model chaotic, so the two differences are of
    # one size (printed, not held to a tolerance; see PERF.md)
    model32 = models.build_model(cfg.replace(param_dtype="float32",
                                             compute_dtype="float32"))
    params32 = map_tree(lambda t: t.float() if t.is_floating_point() else t,
                        params)
    batch = serve.serve_batch(model32, B, P, prompts)
    nudged = dict(batch, frames=batch["frames"] * (1 + 1e-6))
    runs = {}
    for name, ctx, bt in (("kernels", contextlib.nullcontext(), batch),
                          ("plain versions", plain_kernels(), batch),
                          ("kernels on mels x (1 + 1e-6)",
                           contextlib.nullcontext(), nudged)):
        with torch.no_grad(), ctx:
            runs[name] = model32.prefill(params32, bt)[0]
    ref = runs.pop("kernels")
    for name, other in runs.items():
        rel = ((ref - other).abs().max() / ref.abs().max()).item()
        agree = (ref.argmax(-1) == other.argmax(-1)).float().mean().item()
        log(f"full-width float32 prefill logits, kernels vs {name}: max "
            f"|diff| {rel:.3e} of max |logit|, argmax agreement {agree:.2f}")
    del params32, runs
    res_prof = {
        "prefill": profile_busy(lambda: serve.prefill_cache(
            model, params, prompts, cache_len=cache_len)),
        "decode_step": profile_busy(lambda: model.decode_step(
            params, cache, toks[:, :1], P)),
    }
    for what, r in res_prof.items():
        log(f"profile {what}: wall {r['wall_ms']:.3f} ms, card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    step_ms = statistics.median(stats["step_s"]) * 1e3
    res = dict(tok_per_s=B * gen / wall, ttft_ms=stats["ttft_s"] * 1e3,
               decode_step_ms=step_ms, wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, cache_len=cache_len,
               busy_share={k: r["busy_share"] for k, r in res_prof.items()})
    log(f"full-width serve B={B} P={P} gen={gen}: {res['tok_per_s']:.1f} tok/s, "
        f"TTFT {res['ttft_ms']:.2f} ms, decode step {step_ms:.3f} ms (median "
        f"of {len(stats['step_s'])}), {wall:.3f}s, peak mem "
        f"{res['peak_mem_gb']:.2f} GB, launches {launches}, sample "
        f"{toks[0, :16].tolist()}")
    return res


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version for the block."""
    from repro_torch.kernels import attention_decode as ad
    from repro_torch.kernels import im2col_gemm as ig
    from repro_torch.kernels import sliding_conv1d as sc
    from repro_torch.kernels import sliding_conv2d as s2
    from repro_torch.kernels import sliding_conv_bwd as sb
    from repro_torch.kernels import sliding_conv_quant as sq

    saved = (sc._launch, ad._launch, sb._launch, sq._launch,
             sc._launch_depthwise, sq._launch_depthwise, sb._launch_depthwise,
             s2._launch, sq._launch_2d, sb._launch_2d, ig._launch_matmul,
             ig._launch_conv1d, ig._launch_conv2d)
    # (the launch plan, ``plan=``, means nothing to a plain version)
    ig._launch_matmul = ig.matmul_plain
    ig._launch_conv1d = lambda x, w, stride, _lout: (
        ig.conv1d_im2col_fused_plain(x, w, stride=stride))
    ig._launch_conv2d = lambda x, w, stride, _oh, _ow: (
        ig.conv2d_im2col_fused_plain(x, w, stride=stride))
    s2._launch = lambda x, w, b, stride, act, _oh, _ow, save_preact=False, \
        plan=None: (
        s2.conv2d_sliding_plain(x, w, b, stride=stride, activation=act,
                                save_preact=save_preact))
    sq._launch_2d = lambda x, w, ws, b, xs, os, mode, stride, act, odt, *_, \
        plan=None: (
        sq.conv2d_quant_plain(x, w, ws, b, x_scale=xs, out_scale=os,
                              mode=mode, stride=stride, activation=act,
                              out_dtype=odt))
    sb._launch_2d = lambda x, dz, kh, kw, stride, has_bias, plan=None: (
        sb.conv2d_bwd_dw_plain(x, dz, (kh, kw), stride=stride,
                               has_bias=has_bias))
    sc._launch = lambda x, w, b, stride, act, _n, save_preact=False, \
        plan=None: (
        sc.conv1d_sliding_plain(x, w, b, stride=stride, activation=act,
                                save_preact=save_preact))
    ad._launch = lambda q, k, v, ln, ks=None, vs=None, plan=None: (
        ad.attention_decode_plain(q, k, v, ln, ks, vs))
    sb._launch = lambda x, dz, K, stride, has_bias, plan=None: (
        sb.conv1d_bwd_dw_plain(x, dz, K, stride=stride, has_bias=has_bias))
    sq._launch = lambda x, w, ws, b, xs, os, mode, stride, act, odt, _n, \
        plan=None: (
        sq.conv1d_quant_plain(x, w, ws, b, x_scale=xs, out_scale=os,
                              mode=mode, stride=stride, activation=act,
                              out_dtype=odt))
    sc._launch_depthwise = lambda x, w, b, stride, act, _n, \
        save_preact=False, plan=None: (
        sc.conv1d_depthwise_plain(x, w, b, stride=stride, activation=act,
                                  save_preact=save_preact))
    sb._launch_depthwise = lambda x, dz, K, stride, has_bias, plan=None: (
        sb.conv1d_depthwise_bwd_dw_plain(x, dz, K, stride=stride,
                                         has_bias=has_bias))
    sq._launch_depthwise = (
        lambda x, w, ws, b, xs, os, mode, stride, act, odt, _n, plan=None:
        sq.conv1d_depthwise_quant_plain(x, w, ws, b, x_scale=xs, out_scale=os,
                                        mode=mode, stride=stride,
                                        activation=act, out_dtype=odt))
    try:
        yield
    finally:
        (sc._launch, ad._launch, sb._launch, sq._launch,
         sc._launch_depthwise, sq._launch_depthwise,
         sb._launch_depthwise, s2._launch, sq._launch_2d,
         sb._launch_2d, ig._launch_matmul, ig._launch_conv1d,
         ig._launch_conv2d) = saved


def _counters() -> dict:
    """Each kernel's launch counter: the wrapper that holds it and the
    attribute's name."""
    from repro_torch.kernels import attention_decode as ad
    from repro_torch.kernels import im2col_gemm as ig
    from repro_torch.kernels import sliding_conv1d as sc
    from repro_torch.kernels import sliding_conv2d as s2
    from repro_torch.kernels import sliding_conv_bwd as sb
    from repro_torch.kernels import sliding_conv_quant as sq
    from repro_torch.kernels import sliding_pool as sp
    from repro_torch.kernels import ssm_scan as ss

    return {"sliding_conv1d": (sc.conv1d_sliding, "launches"),
            "attention_decode": (ad.decode_attention, "launches"),
            "conv1d_bwd_dw": (sb.conv1d_bwd_dw, "launches"),
            "sliding_conv_quant": (sq.conv1d_quant, "launches"),
            "attention_decode_int8": (ad.decode_attention, "launches_int8"),
            "conv1d_depthwise": (sc.conv1d_depthwise, "launches"),
            "conv1d_depthwise_quant": (sq.conv1d_depthwise_quant, "launches"),
            "conv1d_depthwise_bwd_dw": (sb.conv1d_depthwise_bwd_dw, "launches"),
            "conv2d": (s2.conv2d_sliding, "launches"),
            "conv2d_quant": (sq.conv2d_quant, "launches"),
            "conv2d_bwd_dw": (sb.conv2d_bwd_dw, "launches"),
            "matmul": (ig.matmul, "launches"),
            "im2col_conv1d": (ig.conv1d_im2col_fused, "launches"),
            "im2col_conv2d": (ig.conv2d_im2col_fused, "launches"),
            **{name: (sp.sliding_pool, "launches_" + name.removeprefix(
                "sliding_pool_")) for name, _, _ in POOL_FORMS},
            "sum_pool_bwd": (sp.sum_pool_bwd, "launches"),
            "max_pool_bwd": (sp.max_pool_bwd, "launches"),
            "ssm_scan": (ss.ssm_scan, "launches")}


def zero_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def only(**counts) -> dict:
    """A launch-count dict with every kernel at 0 but those named."""
    return {k: counts.get(k, 0) for k in _counters()}


def profile_busy(fn, reps: int = 3) -> dict:
    """Wall time per call (host clock around calls that end in a
    synchronise, profiler off) and the card's busy time per call (the sum
    of kernel device times, from a second, profiled run), with the kernels
    that take most of it."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        ev = [(_kernel_us(e), e.count, e.key)
              for e in _profiled(fn, reps) if _kernel_us(e) > 0]
    busy_ms = sum(t for t, _, _ in ev) / reps / 1e3
    top = sorted(ev, reverse=True)[:6]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
                kernels=sum(c for _, c, _ in ev) // reps,
                top=[(k[:60], round(t / reps / 1e3, 4), c // reps)
                     for t, c, k in top])


def cycling(fn, sets):
    """A call of ``fn`` that takes the next argument set each time: the
    sets together exceed the 50 MB L2, so every call reads its inputs from
    device memory, as the main path does."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def conv_main_times(sc, name, s, dtype) -> dict:
    """Row 1 at one of ``CONV_MAIN``'s shapes, bias + gelu, in ``dtype``:
    its times beside its plain version and ``F.conv1d`` + gelu in the same
    type (cuDNN, TF32 off), the bound, bytes and operations."""
    args = dict(stride=s["stride"], activation="gelu")
    n_sets = 8 if s["Cin"] < 512 else 4  # > 50 MB of inputs in all (f32)
    sets = []
    for i in range(n_sets):
        x, w, b = conv_inputs(3 + i, s["B"], s["L"], s["Cin"], s["Cout"],
                              s["K"], dtype)
        # the library's layout and types, (Cout, Cin, K), made ahead
        sets.append((x, w, b, w.permute(2, 1, 0).contiguous(), b.to(dtype)))

    def library(x, w, b, w_lib, b_lib, stride=s["stride"]):
        y = F.conv1d(x.transpose(1, 2), w_lib, b_lib, stride=stride)
        return F.gelu(y, approximate="tanh").transpose(1, 2)

    x, w, b = sets[0][:3]
    close(library(*sets[0]), sc.conv1d_sliding_plain(x, w, b, **args),
          TOL if dtype == torch.float32 else BTOL, f"library conv {name}")
    lout = (s["L"] - s["K"]) // s["stride"] + 1
    nbytes = (x.element_size() * (x.numel() + w.numel()
                                  + s["B"] * lout * s["Cout"])
              + 4 * b.numel())
    ops = 2 * s["B"] * lout * s["Cout"] * s["Cin"] * s["K"]
    bms, by = bound_ms(nbytes, ops, dtype)
    row = dict(
        timings(cycling(lambda x, w, b, *_: sc.conv1d_sliding(x, w, b, **args),
                        sets),
                cycling(lambda x, w, b, *_: sc.conv1d_sliding_plain(
                    x, w, b, **args), sets),
                cycling(library, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time conv {name} {s} {dtype}: {json.dumps(row)}")
    return row


def phase_times(sc, ad, launches, errs) -> list[dict]:
    conv_rows = {name: conv_main_times(sc, name, s, torch.float32)
                 for name, s in CONV_MAIN.items()}
    bf16_rows = {name: conv_main_times(sc, name, s, torch.bfloat16)
                 for name, s in CONV_MAIN.items()}

    lens = [256] * ATTN_MAIN["B"]  # the cross-attention read's lengths
    B, S, KV, G, D = (ATTN_MAIN[n] for n in ("B", "S", "KV", "G", "D"))
    sets = []
    for i in range(16):  # 16 caches of 4.7 MB: > 50 MB, as the 24 layers are
        q, k, v, ln = attn_inputs(4 + i, **ATTN_MAIN, dtype=torch.bfloat16,
                                  lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None])[:, None, None, :]
        sets.append((q, k, v, ln, mask))

    def library(q, k, v, ln, mask):
        return F.scaled_dot_product_attention(
            q.reshape(B, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    q, k, v, ln, mask = sets[0]
    close(library(q, k, v, ln, mask).float().reshape(B, KV, G, D),
          ad.attention_decode_plain(q, k, v, ln), BTOL, "library attention")
    nbytes = (2 * q.numel() + 2 * 2 * sum(lens) * KV * D + 4 * B
              + 4 * B * KV * G * D)
    ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, ops, torch.bfloat16)
    attn = dict(
        timings(cycling(lambda q, k, v, ln, _: ad.decode_attention(q, k, v, ln), sets),
                cycling(lambda q, k, v, ln, _: ad.attention_decode_plain(
                    q, k, v, ln), sets),
                cycling(library, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time attention {ATTN_MAIN} bf16 lengths {lens}: {json.dumps(attn)}")

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")

    def conv_sum(rows):
        out = {key: sum(r[key] for r in rows.values()) for key in keys}
        out["bound_by"] = ("operations" if any(
            r["bound_by"] == "operations" for r in rows.values()) else "bytes")
        return out

    bf16_sum = conv_sum(bf16_rows)
    return [
        dict(name="sliding_conv1d", route="cuda",
             source="src/repro_torch/kernels/csrc/sliding_conv1d.cu",
             replaces="src/repro/kernels/sliding_conv1d.py:235",
             launches=launches["sliding_conv1d"],
             max_abs_err=errs["sliding_conv1d"],
             per="prefill: conv1 80->1024 s1 + conv2 1024->1024 s2, B=4 L=514 "
                 "f32, bias + gelu; bf16_*: the same in bf16 (whisper serves "
                 "in bf16), library F.conv1d in bf16",
             **conv_sum(conv_rows),
             **{"bf16_" + k: v for k, v in bf16_sum.items()},
             bf16_max_abs_err=errs["sliding_conv1d_bf16"],
             shapes={**conv_rows,
                     **{f"{n}_bf16": r for n, r in bf16_rows.items()}}),
        dict(name="attention_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/attention_decode.cu",
             replaces="src/repro/kernels/attention_decode.py:144",
             launches=launches["attention_decode"],
             max_abs_err=errs["attention_decode"],
             per="launch: B=4 S=288 KV=16 G=1 D=64 bf16, lengths 256",
             **{key: attn[key] for key in keys + ("bound_by",)}),
    ]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the training frontend at full width: B=4 and 512 mel frames, SAME padding
# adds 2 rows; conv1 80->1024 stride 1 (512 rows out), conv2 1024->1024
# stride 2 (256 rows out)
DW_MAIN = {
    "conv1": dict(B=4, L=514, Cin=80, Cout=1024, K=3, stride=1),
    "conv2": dict(B=4, L=514, Cin=1024, Cout=1024, K=3, stride=2),
}
TRAIN = dict(B=4, seq=512, steps=10, warmup=2)  # full-width train run
SMOKE_TRAIN = dict(B=2, seq=64, steps=4)


def dw_inputs(seed, B, L, Cin, Cout, K, stride, dtype, offset=0):
    """x (B, L, Cin) and dz (B, Lout, Cout); ``offset`` elements into x's
    buffer, so that its base is not 16-byte aligned."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lout = (L - K) // stride + 1
    buf = torch.randn((B * L * Cin + offset,), generator=g, device=DEV)
    x = buf.to(dtype)[offset:].view(B, L, Cin)
    dz = torch.randn((B, lout, Cout), generator=g, device=DEV).to(dtype)
    return x, dz


def phase_train_kernels(sc, sb, ops) -> float:
    """dw kernel, saved pre-activation and the conv autograd Function
    against their plain versions; returns the dw kernel's max |err| at the
    full-width shapes."""
    err_main = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, s in DW_MAIN.items():
            x, dz = dw_inputs(5, s["B"], s["L"], s["Cin"], s["Cout"], s["K"],
                              s["stride"], dtype)
            got = sb.conv1d_bwd_dw(x, dz, s["K"], stride=s["stride"], has_bias=True)
            want = sb.conv1d_bwd_dw_plain(x, dz, s["K"], stride=s["stride"],
                                          has_bias=True)
            what = f"dw {name} {s} {dtype}"
            err = max(close(got[0], want[0], TOL, what, scaled=True),
                      close(got[1], want[1], TOL, what + " db", scaled=True))
            err_main = max(err_main, err)
            log(f"{what}: max|err| {err:.3e} (of max |dw| "
                f"{want[0].abs().max().item():.1f})")
    for dtype in (torch.float32, torch.bfloat16):
        for K, stride in itertools.product((1, 3, 5, 7, 20), (1, 2, 3)):
            for with_bias in (True, False):
                x, dz = dw_inputs(K * stride, 3, 203, 37, 70, K, stride, dtype)
                what = f"dw edge K={K} s={stride} bias={with_bias} {dtype}"
                got = sb.conv1d_bwd_dw(x, dz, K, stride=stride, has_bias=with_bias)
                want = sb.conv1d_bwd_dw_plain(x, dz, K, stride=stride,
                                              has_bias=with_bias)
                err = close(got[0], want[0], TOL, what, scaled=True)
                if with_bias:
                    err = max(err, close(got[1], want[1], TOL, what + " db",
                                         scaled=True))
                elif got[1] is not None:
                    raise AssertionError(f"{what}: db without a bias")
        log(f"dw edge shapes {dtype}: 30 shapes x bias on/off within TOL")
    # the saved pre-activation at the frontend's shapes and at edge shapes
    for name, s in CONV_MAIN.items():
        x, w, b = conv_inputs(6, s["B"], s["L"], s["Cin"], s["Cout"], s["K"],
                              torch.float32)
        args = dict(stride=s["stride"], activation="gelu", save_preact=True)
        y, z = sc.conv1d_sliding(x, w, b, **args)
        py, pz = sc.conv1d_sliding_plain(x, w, b, **args)
        err = max(close(y, py, TOL, f"save_preact y {name}"),
                  close(z, pz, TOL, f"save_preact z {name}"))
        log(f"save_preact {name} f32 gelu: y and z max|err| {err:.3e}")
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BTOL)):
        for K, stride, act in ((1, 3, "relu"), (5, 2, "silu"), (20, 1, "gelu")):
            x, w, b = conv_inputs(K, 3, 203, 37, 70, K, dtype)
            args = dict(stride=stride, activation=act, save_preact=True)
            what = f"save_preact edge K={K} s={stride} {act} {dtype}"
            y, z = sc.conv1d_sliding(x, w, b, **args)
            py, pz = sc.conv1d_sliding_plain(x, w, b, **args)
            close(y, py, tol, what + " y")
            close(z, pz, tol, what + " z")
    log("save_preact edge shapes within tolerance")

    # the whole autograd Function at the full-width frontend, one cotangent
    g = torch.Generator(device=DEV).manual_seed(7)
    mels = torch.randn((4, 512, 80), generator=g, device=DEV)
    leaves = [(torch.randn(shape, generator=g, device=DEV) * scale)
              for shape, scale in (((3, 80, 1024), 3 ** -0.5), ((1024,), 0.1),
                                   ((3, 1024, 1024), 3 ** -0.5), ((1024,), 0.1))]
    ct = torch.randn((4, 256, 1024), generator=g, device=DEV)

    def frontend_grads():
        w1, b1, w2, b2 = (t.detach().requires_grad_(True) for t in leaves)
        h = ops.conv1d(mels, w1, bias=b1, activation="gelu", padding="SAME")
        y = ops.conv1d(h, w2, bias=b2, activation="gelu", padding="SAME",
                       stride=2)
        return torch.autograd.grad((y * ct).sum(), (w1, b1, w2, b2))

    zero_launches()
    got = frontend_grads()
    launches = read_launches()
    with plain_kernels():
        want = frontend_grads()
    if launches != only(sliding_conv1d=3, conv1d_bwd_dw=2):
        raise AssertionError(f"frontend autograd launches {launches}")
    for name, a, b in zip(("conv1_w", "conv1_b", "conv2_w", "conv2_b"), got, want):
        err = close(a, b, TOL, f"frontend grad {name}", scaled=True)
        log(f"frontend autograd Function, kernels vs plain: d{name} max|err| "
            f"{err:.3e} (of max {b.abs().max().item():.1f})")
    torch.cuda.synchronize()
    return err_main


def train_batches(cfg, B, seq, steps, seed, device, train):
    """The train loop's inputs for steps 0 .. steps-1: the token stream
    and, for the audio family, the per-step mel frames, for the vlm family
    the per-step patches (``repro_torch.launch.train``)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.whisper import N_MELS

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=B, seed=seed)
    out = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        if cfg.family == "audio":
            rng = train.step_stream(seed, step, train._TAG_FRAMES)
            batch["frames"] = torch.from_numpy(rng.normal(
                size=(B, seq, N_MELS)).astype(np.float32)).to(device)
        extras = train.build_batch_extras(
            cfg, B, train.step_stream(seed, step, train._TAG_PATCHES))
        batch.update({k: torch.from_numpy(v).to(device)
                      for k, v in extras.items()})
        out.append(batch)
    return out


def phase_smoke_train(models, configs, optim, steps_mod, train, map_tree):
    """One set of float32 smoke weights trained 4 steps through the conv
    kernels on the card and through their plain versions on the CPU: the
    losses agree and fall. The control is the same CPU run with the convs
    summed in another order (``xla`` backend): this random-weight model
    amplifies rounding, and AdamW's normalised steps carry it into later
    losses, so from step 2 on the card is held to three times the
    control's difference where that exceeds 1e-4."""
    base = configs.smoke_config(configs.get_config("whisper-medium"))
    B, seq, n = SMOKE_TRAIN["B"], SMOKE_TRAIN["seq"], SMOKE_TRAIN["steps"]
    opt_cfg = optim.OptConfig(total_steps=n, warmup_steps=5)
    cpu_params = models.build_model(base).init(torch.Generator().manual_seed(0))
    losses = {}
    for run, dev, backend in (("card", DEV, "sliding_pallas"),
                              ("cpu", "cpu", "sliding_pallas"),
                              ("control", "cpu", "xla")):
        cfg = base.replace(conv_backend=backend)
        model = models.build_model(cfg)
        # a copy: the step updates the params in place, and the control
        # starts from the same weights
        params = map_tree(lambda t: t.to(dev, copy=True), cpu_params)
        state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
        step_fn = steps_mod.make_train_step(model, opt_cfg)
        losses[run] = []
        for batch in train_batches(cfg, B, seq, n, 0, dev, train):
            state, metrics = step_fn(state, batch)
            losses[run].append(float(metrics["loss"]))
    card, cpu, ctrl = (np.array(losses[k]) for k in ("card", "cpu", "control"))
    rel = np.abs(card - cpu) / np.abs(cpu)
    rel_ctrl = np.abs(ctrl - cpu) / np.abs(cpu)
    allowed = np.maximum(1e-4, 3 * rel_ctrl)
    if not (np.isfinite(card).all() and (rel <= allowed).all()):
        raise AssertionError(f"smoke train losses card {card} vs CPU {cpu} "
                             f"(control {ctrl})")
    if not card[1:].min() < card[0]:
        raise AssertionError(f"smoke train loss did not fall: {card}")
    log(f"smoke train {SMOKE_TRAIN}: losses card {card.tolist()} vs CPU "
        f"{cpu.tolist()}: rel diff {rel.tolist()}; control (CPU, xla convs) "
        f"rel diff {rel_ctrl.tolist()}")


def phase_full_train(models, configs, optim, steps_mod, train,
                     iter_leaves) -> dict:
    cfg = configs.get_config("whisper-medium").replace(
        conv_backend="sliding_pallas")
    model = models.build_model(cfg)
    B, seq, n, warm = (TRAIN[k] for k in ("B", "seq", "steps", "warmup"))
    opt_cfg = optim.OptConfig(total_steps=n, warmup_steps=max(n // 20, 5),
                              state_dtype=cfg.opt_state_dtype)
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    front0 = {k: v.clone() for k, v in params["frontend"].items()}
    step_fn = steps_mod.make_train_step(model, opt_cfg)
    batches = train_batches(cfg, B, seq, n, 0, DEV, train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    want = only(sliding_conv1d=3 * n, conv1d_bwd_dw=2 * n)
    if launches != want:
        raise AssertionError(f"train launch counts {launches}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss: {losses}")
    moved = {k: (state["params"]["frontend"][k].float() - v.float()).abs().max().item()
             for k, v in front0.items()}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"frontend weights did not move: {moved}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(times[warm:]) * 1e3

    def one_step():
        with torch.enable_grad():
            step_fn(state, batches[0])

    prof = profile_busy(one_step, reps=2)
    res = dict(losses=losses, step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
               tok_per_s=B * seq / (step_ms / 1e3), peak_mem_gb=peak,
               launches=launches,
               launches_per_step={k: v // n for k, v in launches.items()},
               busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
               profiled_wall_ms=prof["wall_ms"], kernels_per_step=prof["kernels"],
               frontend_moved=moved,
               n_params=sum(t.numel() for _, t in iter_leaves(params)))
    log(f"full-width train {cfg.name} ({cfg.param_dtype} params, "
        f"{cfg.opt_state_dtype} moments, remat {cfg.remat}) B={B} seq={seq}: "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"full-width train: step {step_ms:.1f} ms (median of {n - warm} after "
        f"{warm} warm-up), {res['tok_per_s']:.0f} tokens/s, peak mem "
        f"{peak:.2f} GB, launches per step {res['launches_per_step']}, "
        f"frontend moved {moved}")
    log(f"profile train step: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['kernels']} kernels; top: {prof['top']}")
    return res


def phase_train_times(sb, launches, err) -> dict:
    rows = {}
    for name, s in DW_MAIN.items():
        K, stride = s["K"], s["stride"]
        n_sets = 8 if s["Cin"] < 512 else 4  # > 50 MB of inputs in all
        sets = []
        for i in range(n_sets):
            x, dz = dw_inputs(9 + i, s["B"], s["L"], s["Cin"], s["Cout"], K,
                              stride, torch.float32)
            # the library's layouts, (B, C, L), made ahead
            sets.append((x, dz, x.transpose(1, 2).contiguous(),
                         dz.transpose(1, 2).contiguous()))

        def library(x, dz, x_lib, dz_lib):
            return torch.nn.grad.conv1d_weight(
                x_lib, (s["Cout"], s["Cin"], K), dz_lib, stride=stride)

        x, dz, x_lib, dz_lib = sets[0]
        want = sb.conv1d_bwd_dw_plain(x, dz, K, stride=stride, has_bias=True)
        close(library(*sets[0]).permute(2, 1, 0), want[0], TOL,
              f"library dw {name}", scaled=True)
        lout = dz.shape[1]
        nbytes = 4 * (x.numel() + dz.numel() + K * s["Cin"] * s["Cout"] + s["Cout"])
        ops = 2 * s["B"] * lout * K * s["Cin"] * s["Cout"]
        bms, by = bound_ms(nbytes, ops, torch.float32)
        rows[name] = dict(
            timings(cycling(lambda x, dz, *_: sb.conv1d_bwd_dw(
                        x, dz, K, stride=stride, has_bias=True), sets),
                    cycling(lambda x, dz, *_: sb.conv1d_bwd_dw_plain(
                        x, dz, K, stride=stride, has_bias=True), sets),
                    cycling(library, sets)),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        log(f"time dw {name} {s}: {json.dumps(rows[name])}")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")
    both = rows.values()
    total = {key: sum(r[key] for r in both) for key in keys}
    total["bound_by"] = ("operations" if any(r["bound_by"] == "operations"
                                             for r in both) else "bytes")
    return dict(name="conv1d_bwd_dw", route="cuda",
                source="src/repro_torch/kernels/csrc/sliding_conv_bwd.cu",
                header="src/repro_torch/kernels/csrc/gemm_mma.cuh",
                replaces="src/repro/kernels/sliding_conv_bwd.py:229",
                launches=launches["conv1d_bwd_dw"], max_abs_err=err,
                per="train step: conv1 80->1024 s1 + conv2 1024->1024 s2, "
                    "B=4 L=514 f32, with db",
                by_shape=rows, **total)


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

# the int8 frontend at full width (512 mel frames, SAME padding): conv1
# requantizes onto conv2's grid, conv2 reads the int8 codes and writes f32
QCONV_MAIN = {
    "conv1": dict(B=4, L=514, Cin=80, Cout=1024, K=3, stride=1, requant=True),
    "conv2": dict(B=4, L=514, Cin=1024, Cout=1024, K=3, stride=2, requant=False),
}
ACTS = ("none", "relu", "gelu", "silu")


def quant_inputs(seed, B, L, Cin, Cout, K, mode, x_dtype=torch.float32,
                 with_bias=True):
    """int8 weight codes with per-Cout scales, and an int8 input with its
    scale (w8a8) or a float input (w8a16), scaled so outputs are O(1)."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=DEV,
                             dtype=torch.int32).to(torch.int8)

    n = K * Cin
    w = codes((K, Cin, Cout))
    ws = (torch.rand((Cout,), generator=g, device=DEV) + 0.5) / (73 * n ** 0.5)
    b = torch.randn((Cout,), generator=g, device=DEV) if with_bias else None
    if mode == "w8a8":
        x = codes((B, L, Cin))
        xs = torch.tensor(1 / 73, device=DEV)
    else:
        x = torch.randn((B, L, Cin), generator=g, device=DEV).to(x_dtype)
        xs = None
    return x, w, ws, b, xs


def codes_close(got, want, pre, what, *, tie, max_frac) -> int:
    """Raise unless the int8 codes ``got`` equal ``want`` but for codes one
    apart where ``pre`` (the plain version's float ``y / out_scale``) lies
    within ``tie`` of a half-integer, and no more than ``max_frac`` of them:
    two float32 evaluations of one activation may differ in the last bits
    and round such a value the other way. Returns the codes that differ."""
    if got.dtype != torch.int8 or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"int8 {tuple(want.shape)}")
    diff = (got.int() - want.int()).abs()
    off = diff > 0
    n_off = int(off.sum())
    near = ((pre - pre.floor()).abs() - 0.5).abs() < tie
    if (diff.max().item() > 1 or bool((off & ~near).any())
            or n_off > max_frac * diff.numel()):
        raise AssertionError(
            f"{what}: {n_off} codes differ (max {diff.max().item()}), "
            f"{int((off & ~near).sum())} away from a tie")
    return n_off


def check_quant_conv(sq, x, w, ws, b, xs, *, mode, stride, act, requant,
                     what) -> float:
    """The int8 conv kernel against its plain version, float output and,
    with ``requant``, int8 codes on a grid that clips the largest outputs;
    returns the float output's max |err|."""
    odt = x.dtype if mode == "w8a16" else torch.float32
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    want = sq.conv1d_quant_plain(x, w, ws, b, out_dtype=odt, **args)
    got = sq.conv1d_quant(x, w, ws, b, out_dtype=odt, **args)
    tol = QBTOL if odt == torch.bfloat16 else TIGHT
    err = close(got, want, tol, what, scaled=mode == "w8a16")
    if requant:
        y = sq.conv1d_quant_plain(x, w, ws, b, out_dtype=torch.float32, **args)
        os = (y.abs().max() * 0.8 / 127).reshape(())
        want_q = sq.conv1d_quant_plain(x, w, ws, b, out_scale=os, **args)
        got_q = sq.conv1d_quant(x, w, ws, b, out_scale=os, **args)
        if want_q.abs().max().item() != 127:
            raise AssertionError(f"{what}: the requant clip is not exercised")
        # w8a8 sums exactly: only the activation's last bits differ; w8a16
        # sums in float32 in another order
        exact = mode == "w8a8"
        codes_close(got_q, want_q, y / os, what + " requant",
                    tie=1e-4 if exact else 1e-3,
                    max_frac=1e-4 if exact else 1e-3)
    return err


def phase_quant_kernels(sq) -> float:
    """Returns the w8a8 kernel's max |err| at the full-width shapes."""
    err_main = 0.0
    for name, s in QCONV_MAIN.items():
        for mode, x_dtype in (("w8a8", None), ("w8a16", torch.float32),
                              ("w8a16", torch.bfloat16)):
            x, w, ws, b, xs = quant_inputs(11, s["B"], s["L"], s["Cin"],
                                           s["Cout"], s["K"], mode,
                                           x_dtype or torch.float32)
            what = f"quant conv {name} {mode} {x.dtype} gelu"
            err = check_quant_conv(sq, x, w, ws, b, xs, mode=mode,
                                   stride=s["stride"], act="gelu",
                                   requant=True, what=what)
            if mode == "w8a8":
                err_main = max(err_main, err)
            log(f"{what}: f32 max|err| {err:.3e}, requant codes checked")
    n = 0
    for K, stride, cin, mode in itertools.product(
            (1, 3, 5, 7, 17, 20), (1, 2), (37, 80), ("w8a8", "w8a16")):
        for i, act in enumerate(ACTS):
            x, w, ws, b, xs = quant_inputs(K * 100 + stride * 10 + i, 3, 203,
                                           cin, 70, K, mode,
                                           with_bias=i % 2 == 0)
            check_quant_conv(sq, x, w, ws, b, xs, mode=mode, stride=stride,
                             act=act, requant=True,
                             what=f"quant conv edge K={K} s={stride} "
                                  f"Cin={cin} {mode} {act}")
            n += 1
    log(f"quant conv edge shapes: {n} cases, float and requant outputs checked")
    torch.cuda.synchronize()
    return err_main


def attn_int8_inputs(seed, B, S, KV, G, D, q_dtype, lengths):
    """q, an int8 cache (codes and per-row scales, through the cache's
    quantizer) with rows past each length zeroed as the padded cross cache
    is, and lengths."""
    from repro_torch.models.common import quantize_kv_leaf

    q, k, v, ln = attn_inputs(seed, B, S, KV, G, D, torch.float32, lengths)
    kq, ks = quantize_kv_leaf(k)
    vq, vs = quantize_kv_leaf(v)
    pad = torch.arange(S, device=DEV)[None, :] >= ln[:, None]
    for t in (kq, ks, vq, vs):
        t[pad] = 0
    return q.to(q_dtype), kq, vq, ln, ks, vs


def phase_attention_int8(ad) -> float:
    lens = [0, 1, 127, 288]
    args = attn_int8_inputs(12, **ATTN_MAIN, q_dtype=torch.bfloat16,
                            lengths=lens)
    got = ad.decode_attention(*args)
    err = close(got, ad.attention_decode_plain(*args), TOL,
                "attention int8 main shape")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("attention int8: a length-0 slot must give a "
                             "zero row")
    log(f"attention int8 {ATTN_MAIN} bf16 q lengths {lens}: max|err| {err:.3e}")
    for G in (2, 4, 8):
        for S, D in ((288, 64), (200, 128), (24, 32)):
            lens = [0, 1, S // 2, S]
            args = attn_int8_inputs(G * S + 1, 4, S, 2, G, D, torch.float32,
                                    lens)
            what = f"attention int8 G={G} S={S} D={D} lengths {lens}"
            e = close(ad.decode_attention(*args),
                      ad.attention_decode_plain(*args), TOL, what)
            log(f"{what}: max|err| {e:.3e}")
    for S, lens, G in ((65, [31, 32, 33, 65], 1), (1, [0, 1, 1, 0], 3)):
        args = attn_int8_inputs(S + 1, 4, S, 3, G, 64, torch.float32, lens)
        what = f"attention int8 G={G} S={S} D=64 lengths {lens}"
        e = close(ad.decode_attention(*args), ad.attention_decode_plain(*args),
                  TOL, what)
        log(f"{what}: max|err| {e:.3e}")
    torch.cuda.synchronize()
    return err


def phase_smoke_serve_int8(serve, models, configs, map_tree, quant, sq,
                           layers):
    """One set of float32 smoke weights, quantized for serving on the CPU
    (``--quant int8``) and served from an int8 cache (``--kv-quant int8``)
    on the CPU and on the card: equal greedy tokens, prefill logits within
    TOL; the card's own calibration within 1e-5 of the CPU's; conv1's int8
    codes as in phase 11; one dequant site in the frontend."""
    cfg = configs.smoke_config(configs.get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas", kv_quant="int8")
    model = models.build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cfg_q, cpu_q = serve.quantize_for_serving(model, cpu_params, prompts)
    _, card_own = serve.quantize_for_serving(
        model, map_tree(lambda t: t.to(DEV), cpu_params), prompts.to(DEV))
    for key in ("conv1_w", "conv2_w"):
        a, b = card_own["frontend"][key], cpu_q["frontend"][key]
        for f in ("scale", "x_scale", "out_scale"):
            if (getattr(a, f) is None) != (getattr(b, f) is None):
                raise AssertionError(f"card calibration {key}.{f}")
            if getattr(a, f) is not None:
                close(getattr(a, f).cpu(), getattr(b, f),
                      dict(rtol=1e-5, atol=0), f"card calibration {key}.{f}")
    model_q = models.build_model(cfg_q)
    card_q = map_tree(lambda t: t.to(DEV), cpu_q)
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for dev, params in (("cpu", cpu_q), (DEV, card_q)):
        with torch.no_grad(), quant.counting_dequants() as sites:
            logits, _ = serve.prefill_cache(model_q, params, prompts.to(dev),
                                            cache_len=cache_len)
        if sites != ["whisper/conv2"]:
            raise AssertionError(f"{dev}: dequant sites {sites}")
        toks, _ = serve.generate(model_q, params, prompts.to(dev),
                                 gen_len=SMOKE["gen"], cache_len=cache_len)
        f = params["frontend"]
        mels = serve.serve_batch(model_q, SMOKE["B"], SMOKE["P"],
                                 prompts.to(dev))["frames"]
        with torch.no_grad():
            c1 = layers.conv1d_bias_act(
                mels, f["conv1_w"], f["conv1_b"], activation="gelu",
                padding="SAME", backend="sliding_pallas", precision="w8a8",
                site="whisper/conv1")
        out[dev] = (logits.cpu(), toks.cpu(), c1.cpu())
    err = close(out[DEV][0], out["cpu"][0], TOL, "int8 smoke prefill logits")
    if not torch.equal(out[DEV][1], out["cpu"][1]):
        raise AssertionError(f"int8 smoke greedy tokens differ: card "
                             f"{out[DEV][1].tolist()} vs CPU "
                             f"{out['cpu'][1].tolist()}")
    f = cpu_q["frontend"]
    mels = serve.serve_batch(model_q, SMOKE["B"], SMOKE["P"], prompts)["frames"]
    w1 = f["conv1_w"]
    y = sq.conv1d_quant_plain(
        F.pad(quant.quantize_act(mels, w1.x_scale), (0, 0, 1, 1)), w1.q,
        w1.scale, f["conv1_b"], x_scale=w1.x_scale, activation="gelu")
    n_off = codes_close(out[DEV][2], out["cpu"][2], y / w1.out_scale,
                        "int8 smoke conv1 codes", tie=1e-4, max_frac=1e-4)
    log(f"int8 smoke serve {SMOKE}: greedy tokens equal on card and CPU "
        f"{out[DEV][1].tolist()}; prefill logits max|err| {err:.3e}; conv1 "
        f"codes {n_off} of {y.numel()} one apart at ties; one dequant site")


def phase_full_serve_int8(serve, models, configs, quant) -> dict:
    cfg = configs.get_config("whisper-medium").replace(
        conv_backend="sliding_pallas", attn_decode="fused", kv_quant="int8")
    model = models.build_model(cfg)
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
    B, P, gen = SERVE["B"], SERVE["P"], SERVE["gen"]
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, P)),
                              dtype=torch.int32, device=DEV)
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    cfg_q, qparams = serve.quantize_for_serving(model, params, prompts)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib = read_launches()
    if calib != only(sliding_conv1d=2) or cfg_q.conv_precision != "w8a8":
        raise AssertionError(f"calibration launches {calib}")
    model_q = models.build_model(cfg_q)
    del params
    serve.generate(model_q, qparams, prompts, gen_len=2, cache_len=cache_len)
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    with quant.counting_dequants() as sites:
        toks, _ = serve.generate(model_q, qparams, prompts, gen_len=gen,
                                 cache_len=cache_len, stats=stats)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = only(sliding_conv_quant=2,
                attention_decode_int8=2 * cfg.num_layers * (gen - 1))
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches}, expected {want}")
    if sites != ["whisper/conv2"]:
        raise AssertionError(f"int8 request dequant sites {sites}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model_q, qparams, prompts,
                                            cache_len=cache_len)
        step, _ = model_q.decode_step(qparams, cache, toks[:, :1], P)
    for what, t in (("prefill", logits), ("decode step", step)):
        if t.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError(f"int8 full-width {what} logits not finite / bad shape")
    if cache["k"].dtype != torch.int8 or cache["xk"].dtype != torch.int8:
        raise AssertionError("int8 full-width cache is not int8")
    nbytes = serve.cache_nbytes(model_q.cache_defs(B, cache_len), cfg.param_dtype)
    fp_model = models.build_model(cfg.replace(kv_quant="fp"))
    nbytes_fp = serve.cache_nbytes(fp_model.cache_defs(B, cache_len),
                                   cfg.param_dtype)
    log(f"int8 full width kv-cache bytes: {nbytes} (fp {nbytes_fp}, ratio "
        f"{nbytes_fp / nbytes:.2f}x)")
    res_prof = {
        "prefill": profile_busy(lambda: serve.prefill_cache(
            model_q, qparams, prompts, cache_len=cache_len)),
        "decode_step": profile_busy(lambda: model_q.decode_step(
            qparams, cache, toks[:, :1], P)),
    }
    for what, r in res_prof.items():
        log(f"profile int8 {what}: wall {r['wall_ms']:.3f} ms, card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    step_ms = statistics.median(stats["step_s"]) * 1e3
    res = dict(tok_per_s=B * gen / wall, ttft_ms=stats["ttft_s"] * 1e3,
               decode_step_ms=step_ms, wall_s=wall, calibration_s=calib_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, calibration_launches=calib,
               cache_len=cache_len, kv_cache_bytes=nbytes,
               kv_cache_bytes_fp=nbytes_fp,
               busy_share={k: r["busy_share"] for k, r in res_prof.items()},
               busy_ms={k: r["busy_ms"] for k, r in res_prof.items()})
    log(f"full-width int8 serve B={B} P={P} gen={gen}: {res['tok_per_s']:.1f} "
        f"tok/s, TTFT {res['ttft_ms']:.2f} ms, decode step {step_ms:.3f} ms "
        f"(median of {len(stats['step_s'])}), {wall:.3f}s, peak mem "
        f"{res['peak_mem_gb']:.2f} GB, calibration {calib_s:.2f}s with "
        f"launches {calib}, request launches {launches}, sample "
        f"{toks[0, :16].tolist()}")
    return res


def phase_quant_times(sq, ad, launches, errs) -> list[dict]:
    conv_rows = {}
    for name, s in QCONV_MAIN.items():
        K, stride, Cin, Cout = s["K"], s["stride"], s["Cin"], s["Cout"]
        per_set = s["B"] * s["L"] * Cin + K * Cin * Cout
        n_sets = min(256, int(64e6 // per_set) + 1)  # > 50 MB of inputs
        lout = (s["L"] - K) // stride + 1
        span = (lout - 1) * stride + 1
        sets = []
        for i in range(n_sets):
            x, w, ws, b, xs = quant_inputs(20 + i, s["B"], s["L"], Cin, Cout,
                                           K, "w8a8")
            os = torch.tensor(0.05, device=DEV) if s["requant"] else None
            # the library's operands, made ahead: the input unfolded to
            # (B*Lout, K*Cin) and the weights to (K*Cin, Cout)
            cols = torch.cat([x[:, k : k + span : stride] for k in range(K)],
                             dim=-1).reshape(-1, K * Cin)
            sets.append((x, w, ws, b, xs, os, cols, w.reshape(K * Cin, Cout)))

        def kernel(x, w, ws, b, xs, os, *_):
            return sq.conv1d_quant(x, w, ws, b, x_scale=xs, out_scale=os,
                                   stride=stride, activation="gelu")

        def plain(x, w, ws, b, xs, os, *_):
            return sq.conv1d_quant_plain(x, w, ws, b, x_scale=xs, out_scale=os,
                                         stride=stride, activation="gelu")

        def library(x, w, ws, b, xs, os, cols, w2, B=s["B"]):
            acc = torch._int_mm(cols, w2).reshape(B, -1, Cout)
            y = F.gelu(acc.float() * (ws * xs) + b, approximate="tanh")
            if os is None:
                return y
            return torch.clamp(torch.round(y / os), -127, 127).to(torch.int8)

        want = plain(*sets[0])
        lib = library(*sets[0])
        if s["requant"]:
            if (lib.int() - want.int()).abs().max().item() > 1:
                raise AssertionError(f"library quant conv {name}")
        else:
            close(lib, want, TIGHT, f"library quant conv {name}")
        out_bytes = 1 if s["requant"] else 4
        nbytes = (s["B"] * s["L"] * Cin + K * Cin * Cout + 4 * 2 * Cout
                  + out_bytes * s["B"] * lout * Cout)
        ops = 2 * s["B"] * lout * Cout * Cin * K
        bms, by = bound_ms(nbytes, ops, torch.int8)
        conv_rows[name] = dict(
            timings(cycling(kernel, sets), cycling(plain, sets),
                    cycling(library, sets)),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        log(f"time quant conv {name} {s}: {json.dumps(conv_rows[name])}")
        del sets

    lens = [256] * ATTN_MAIN["B"]  # the cross-attention read's lengths
    B, S, KV, G, D = (ATTN_MAIN[n] for n in ("B", "S", "KV", "G", "D"))
    sets = []
    for i in range(24):  # 24 caches of 2.5 MB: > 50 MB, as the 24 layers are
        q, kq, vq, ln, ks, vs = attn_int8_inputs(30 + i, **ATTN_MAIN,
                                                 q_dtype=torch.bfloat16,
                                                 lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None])[:, None, None, :]
        sets.append((q, kq, vq, ln, ks, vs, mask))

    def library(q, kq, vq, ln, ks, vs, mask):
        k = (kq.float() * ks).to(q.dtype)
        v = (vq.float() * vs).to(q.dtype)
        return F.scaled_dot_product_attention(
            q.reshape(B, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    close(library(*sets[0]).float().reshape(B, KV, G, D),
          ad.attention_decode_plain(*sets[0][:6]), BTOL, "library attention int8")
    nbytes = (2 * B * KV * G * D + 2 * sum(lens) * KV * D
              + 2 * 4 * sum(lens) * KV + 4 * B + 4 * B * KV * G * D)
    ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, ops, torch.float32)
    attn = dict(
        timings(cycling(lambda *a: ad.decode_attention(*a[:6]), sets),
                cycling(lambda *a: ad.attention_decode_plain(*a[:6]), sets),
                cycling(library, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time attention int8 {ATTN_MAIN} lengths {lens}: {json.dumps(attn)}")

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")
    both = conv_rows.values()
    conv_sum = {key: sum(r[key] for r in both) for key in keys}
    conv_sum["bound_by"] = ("operations" if any(r["bound_by"] == "operations"
                                                for r in both) else "bytes")
    return [
        dict(name="sliding_conv_quant", route="cuda",
             source="src/repro_torch/kernels/csrc/sliding_conv_quant.cu",
             header="src/repro_torch/kernels/csrc/gemm_mma.cuh",
             replaces="src/repro/kernels/sliding_conv_quant.py:220",
             launches=launches["sliding_conv_quant"],
             max_abs_err=errs["sliding_conv_quant"],
             per="prefill: conv1 w8a8 80->1024 s1 requant + conv2 w8a8 "
                 "1024->1024 s2 f32 out, B=4 L=514, gelu; library: "
                 "torch._int_mm on the input unfolded ahead + epilogue",
             by_shape=conv_rows, **conv_sum),
        dict(name="attention_decode_int8", route="cuda",
             source="src/repro_torch/kernels/csrc/attention_decode.cu",
             replaces="src/repro/kernels/attention_decode.py:144",
             launches=launches["attention_decode_int8"],
             max_abs_err=errs["attention_decode_int8"],
             per="launch: B=4 S=288 KV=16 G=1 D=64, bf16 q, int8 cache, "
                 "lengths 256; library: dequant to bf16 + SDPA",
             **{key: attn[key] for key in keys + ("bound_by",)}),
    ]


# ---------------------------------------------------------------------------
# jamba serving
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
# the full-width cut: one period (7 Mamba blocks, 1 attention), no experts;
# every width the published one: 8,999,034,880 parameters
JAMBA_CUT = dict(num_layers=8, num_experts=0)
JAMBA_PARAMS = 8_999_034_880
# mamba's prefill conv at the full-width request (DEPTHWISE_MAIN: B=4, P=256
# prompt rows and K-1=3 rows of CAUSAL padding, d_inner 16384, K 4, bf16)
# and jamba's decode read (ATTN_JAMBA: 64 query heads over 8 KV heads, head
# dim 128, 288 cache rows) come from analysis.contracts


def bf16_close(got, want, what) -> float:
    """Raise unless the bfloat16 ``got`` is within one bfloat16 step of
    ``want`` elementwise (the kernel's float32 sum equals the plain
    version's but for the activation's last bits, which can round the
    bfloat16 the other way); return max |err|."""
    g, w = got.float(), want.float()
    if got.dtype != torch.bfloat16 or g.shape != w.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(g.shape)} vs "
                             f"bfloat16 {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    err = (g - w).abs()
    bad = err > step
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements more than a "
                             f"bf16 step off, max |err| {err.max().item():.3e}")
    return err.max().item()


def f32_close(got, want, what) -> float:
    """float32: within 1e-6 of max |want| (the sums are the plain version's,
    in its order and rounding; the activation's last bits differ)."""
    return close(got, want, dict(rtol=0.0, atol=1e-6 * max(
        1.0, want.abs().max().item())), what)


def dw_check(got, want, what) -> float:
    return (bf16_close(got, want, what) if want.dtype == torch.bfloat16
            else f32_close(got, want, what))


def depthwise_inputs(seed, B, L, C, K, dtype, with_bias=True, offset=0):
    """x (B, L, C), w (K, C), bias; ``offset`` elements into its buffer, so
    that x's base is not 16-byte aligned."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    buf = torch.randn((B * L * C + offset,), generator=g, device=DEV)
    x = buf.to(dtype)[offset:].view(B, L, C)
    w = (torch.randn((K, C), generator=g, device=DEV) / K ** 0.5).to(dtype)
    b = torch.randn((C,), generator=g, device=DEV) if with_bias else None
    return x, w, b


def dw_quant_inputs(seed, B, L, C, K, mode, x_dtype=torch.float32,
                    with_bias=True):
    """int8 depthwise weight codes with per-channel scales (1, C), and int8
    input codes with their scale (w8a8) or a float input (w8a16)."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=DEV,
                             dtype=torch.int32).to(torch.int8)

    w = codes((K, C))
    ws = (torch.rand((1, C), generator=g, device=DEV) + 0.5) / (73 * K ** 0.5)
    b = torch.randn((C,), generator=g, device=DEV) if with_bias else None
    if mode == "w8a8":
        return codes((B, L, C)), w, ws, b, torch.tensor(1 / 73, device=DEV)
    x = torch.randn((B, L, C), generator=g, device=DEV).to(x_dtype)
    return x, w, ws, b, None


def check_dw_quant(sq, x, w, ws, b, xs, *, mode, stride, act, out_dtype,
                   requant, what) -> float:
    """The int8 depthwise kernel against its plain version: float output,
    and with ``requant`` int8 codes on a grid that clips the largest
    outputs (equal but for ties, ``codes_close``)."""
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    want = sq.conv1d_depthwise_quant_plain(x, w, ws, b, out_dtype=out_dtype,
                                           **args)
    got = sq.conv1d_depthwise_quant(x, w, ws, b, out_dtype=out_dtype, **args)
    err = dw_check(got, want, what)
    if requant:
        y = want if out_dtype == torch.float32 else \
            sq.conv1d_depthwise_quant_plain(x, w, ws, b, **args)
        os = (y.abs().max() * 0.8 / 127).reshape(())
        want_q = sq.conv1d_depthwise_quant_plain(x, w, ws, b, out_scale=os,
                                                 **args)
        got_q = sq.conv1d_depthwise_quant(x, w, ws, b, out_scale=os, **args)
        if want_q.abs().max().item() != 127:
            raise AssertionError(f"{what}: the requant clip is not exercised")
        codes_close(got_q, want_q, y / os, what + " requant", tie=1e-4,
                    max_frac=1e-4)
    return err


def phase_depthwise_kernels(sc, sq, ad) -> dict:
    """The depthwise kernels, float and int8, against their plain versions
    at mamba's prefill shape and at edge shapes; the attention kernels at
    jamba's decode shape. Returns max |err| at the main shapes."""
    s = DEPTHWISE_MAIN
    errs = {}
    x, w, b = depthwise_inputs(40, s["B"], s["L"], s["C"], s["K"],
                               torch.bfloat16)
    errs["conv1d_depthwise"] = dw_check(
        sc.conv1d_depthwise(x, w, b, activation="silu"),
        sc.conv1d_depthwise_plain(x, w, b, activation="silu"),
        f"depthwise main {s} bf16 silu")
    log(f"depthwise {s} bf16 silu: max|err| {errs['conv1d_depthwise']:.3e}")
    combos = [(True, "silu"), (False, "none"), (True, "none"), (False, "silu")]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (K, stride, (C, L)) in enumerate(itertools.product(
                (2, 3, 4, 5), (1, 2), ((37, 203), (600, 9), (1032, 64)))):
            with_bias, act = combos[i % 4]
            x, w, b = depthwise_inputs(i, 3, L, C, K, dtype, with_bias,
                                       offset=i % 3)
            what = (f"depthwise edge K={K} s={stride} C={C} L={L} {act} "
                    f"bias={with_bias} offset={i % 3} {dtype}")
            dw_check(sc.conv1d_depthwise(x, w, b, stride=stride, activation=act),
                     sc.conv1d_depthwise_plain(x, w, b, stride=stride,
                                               activation=act), what)
            n += 1
    log(f"depthwise edge shapes: {n} cases within tolerance")

    err_q = 0.0
    for mode, x_dtype in (("w8a8", None), ("w8a16", torch.bfloat16),
                          ("w8a16", torch.float32)):
        x, w, ws, b, xs = dw_quant_inputs(41, s["B"], s["L"], s["C"], s["K"],
                                          mode, x_dtype or torch.float32)
        odt = torch.bfloat16  # the model's compute type, bf16 at full width
        what = f"int8 depthwise main {s} {mode} {x.dtype} silu"
        err = check_dw_quant(sq, x, w, ws, b, xs, mode=mode, stride=1,
                             act="silu", out_dtype=odt, requant=True, what=what)
        if mode == "w8a8":
            err_q = err
        log(f"{what}: bf16 max|err| {err:.3e}, requant codes checked")
    n = 0
    for i, (K, stride, (C, L), mode) in enumerate(itertools.product(
            (2, 3, 4, 5), (1, 2), ((37, 203), (600, 9)), ("w8a8", "w8a16"))):
        with_bias, act = combos[i % 4]
        for odt in (torch.float32, torch.bfloat16):
            x, w, ws, b, xs = dw_quant_inputs(100 + i, 3, L, C, K, mode,
                                              odt, with_bias)
            check_dw_quant(sq, x, w, ws, b, xs, mode=mode, stride=stride,
                           act=act, out_dtype=odt, requant=act == "silu",
                           what=f"int8 depthwise edge K={K} s={stride} C={C} "
                                f"L={L} {mode} {act} {odt}")
            n += 1
    log(f"int8 depthwise edge shapes: {n} cases, float and requant outputs "
        "checked")
    errs["conv1d_depthwise_quant"] = err_q

    # rows 3 and 15 planned for a card of 2 SMs: 16 persistent blocks each
    # walk 256 items of the prefill shape, across slabs, chunks and rows
    from repro_torch.kernels import build
    sm_count = build.sm_count
    build.sm_count = lambda device: 2
    try:
        x, w, b = depthwise_inputs(44, s["B"], s["L"], s["C"], s["K"],
                                   torch.bfloat16)
        y, z = sc.conv1d_depthwise(x, w, b, activation="silu",
                                   save_preact=True)
        py, pz = sc.conv1d_depthwise_plain(x, w, b, activation="silu",
                                           save_preact=True)
        err = max(dw_check(y, py, "depthwise main, 2 SMs' plan"),
                  dw_check(z, pz, "depthwise main z, 2 SMs' plan"))
        x, w, ws, b, xs = dw_quant_inputs(45, s["B"], s["L"], s["C"], s["K"],
                                          "w8a8")
        err_q = check_dw_quant(sq, x, w, ws, b, xs, mode="w8a8", stride=1,
                               act="silu", out_dtype=torch.bfloat16,
                               requant=True,
                               what="int8 depthwise main, 2 SMs' plan")
    finally:
        build.sm_count = sm_count
    log(f"depthwise {s} planned for 2 SMs: bf16 y and z max|err| {err:.3e}; "
        f"w8a8 bf16 max|err| {err_q:.3e}, requant codes checked")

    lens = [0, 1, 127, 288]
    q, k, v, ln = attn_inputs(42, **ATTN_JAMBA, dtype=torch.bfloat16,
                              lengths=lens)
    got = ad.decode_attention(q, k, v, ln)
    errs["attention_decode_jamba"] = close(
        got, ad.attention_decode_plain(q, k, v, ln), BTOL,
        "attention bf16 jamba shape")
    args = attn_int8_inputs(43, **ATTN_JAMBA, q_dtype=torch.bfloat16,
                            lengths=lens)
    got8 = ad.decode_attention(*args)
    errs["attention_decode_int8_jamba"] = close(
        got8, ad.attention_decode_plain(*args), TOL,
        "attention int8 jamba shape")
    if got[0].abs().max().item() != 0.0 or got8[0].abs().max().item() != 0.0:
        raise AssertionError("attention: a length-0 slot must give a zero row")
    log(f"attention {ATTN_JAMBA} lengths {lens}: bf16 max|err| "
        f"{errs['attention_decode_jamba']:.3e}, int8 max|err| "
        f"{errs['attention_decode_int8_jamba']:.3e}")
    torch.cuda.synchronize()
    return errs


def _jitter_control(serve, model, params, prompts, cache_len, draws=3,
                    eps=1e-7):
    """What float rounding alone does to this random-weight model on the
    CPU: the period weights scaled elementwise by (1 + eps * N(0, 1)), a
    change of one float32 step, ``draws`` times. Returns the largest move
    of the prefill logits (a share of max |logit|) and the most greedy
    tokens changed."""
    from repro_torch.distributed.sharding import map_tree

    g = torch.Generator().manual_seed(1)

    def jitter(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t * (1 + eps * torch.randn(t.shape, generator=g))
        return t

    with torch.no_grad():
        base, _ = serve.prefill_cache(model, params, prompts, cache_len=cache_len)
    toks, _ = serve.generate(model, params, prompts, gen_len=SMOKE["gen"],
                             cache_len=cache_len)
    spread, changed = 0.0, 0
    for _ in range(draws):
        moved = dict(params, periods=map_tree(jitter, params["periods"]))
        with torch.no_grad():
            logits, _ = serve.prefill_cache(model, moved, prompts,
                                            cache_len=cache_len)
        t, _ = serve.generate(model, moved, prompts, gen_len=SMOKE["gen"],
                              cache_len=cache_len)
        spread = max(spread, ((logits - base).abs().max()
                              / base.abs().max()).item())
        changed = max(changed, int((t != toks).sum()))
    return spread, changed


def phase_smoke_serve_jamba(serve, models, configs, map_tree, sq):
    """jamba's smoke config (float32, one period, 4 experts), one set of
    weights on the CPU and on the card, fp and ``--quant int8 --kv-quant
    int8`` (quantized on the CPU, the tree carried to the card). The
    reference's init makes this model ill-conditioned, and its int8 path
    quantizes every Mamba conv's input with a dynamic scale, where a code
    at a tie flips with the last bit of its input. So each mode is held
    to what one float32 step of jitter on the weights does on the CPU
    (``_jitter_control``): prefill logits within three times its move (or
    TOL, the larger), greedy tokens equal wherever the jitter leaves them
    all equal. Every int8 conv of the card's prefill is also held to its
    plain version on the card's own inputs (float32 out: 1e-6 of max)."""
    base = configs.smoke_config(configs.get_config(JAMBA)).replace(
        conv_backend="sliding_pallas")
    model = models.build_model(base)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, base.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cache_len = SMOKE["P"] + SMOKE["gen"]
    model8 = models.build_model(base.replace(kv_quant="int8"))
    cfg_q, cpu_q = serve.quantize_for_serving(model8, cpu_params, prompts)
    for mode, m, cpu_p in (("fp", model, cpu_params),
                           ("int8", models.build_model(cfg_q), cpu_q)):
        spread, changed = _jitter_control(serve, m, cpu_p, prompts, cache_len)
        out = {}
        calls = []
        for card, (dev, params) in enumerate((
                ("cpu", cpu_p), (DEV, map_tree(lambda t: t.to(DEV), cpu_p)))):
            zero_launches()
            launch = sq._launch_depthwise
            if card:  # keep the int8 convs' inputs and outputs
                sq._launch_depthwise = lambda *a, **k: calls.append(
                    (a, launch(*a, **k))) or calls[-1][1]
            try:
                with torch.no_grad():
                    logits, _ = serve.prefill_cache(m, params, prompts.to(dev),
                                                    cache_len=cache_len)
            finally:
                sq._launch_depthwise = launch
            toks, _ = serve.generate(m, params, prompts.to(dev),
                                     gen_len=SMOKE["gen"], cache_len=cache_len)
            out["card" if card else "cpu"] = (logits.cpu(), toks.cpu(),
                                              read_launches())
        want = only(conv1d_depthwise=14, attention_decode=SMOKE["gen"] - 1) \
            if mode == "fp" else only(conv1d_depthwise_quant=14,
                                      attention_decode_int8=SMOKE["gen"] - 1)
        if out["card"][2] != want:
            raise AssertionError(f"jamba smoke {mode} launches {out["card"][2]}, "
                                 f"expected {want}")
        for (x, w, ws, b, xs, os, qmode, stride, act, odt, _n), y in calls:
            f32_close(y, sq.conv1d_depthwise_quant_plain(
                x, w, ws, b, x_scale=xs, out_scale=os, mode=qmode,
                stride=stride, activation=act, out_dtype=odt),
                "jamba smoke int8 conv on the card's inputs")
        if len(calls) != (7 if mode == "int8" else 0):
            raise AssertionError(f"jamba smoke {mode}: {len(calls)} int8 convs")
        rel = ((out["card"][0] - out["cpu"][0]).abs().max()
               / out["cpu"][0].abs().max()).item()
        allowed = max(TOL["rtol"], 3 * spread)
        if not torch.isfinite(out["card"][0]).all() or rel > allowed:
            raise AssertionError(f"jamba smoke {mode} prefill logits {rel:.3e} "
                                 f"of max apart, allowed {allowed:.3e}")
        differ = int((out["card"][1] != out["cpu"][1]).sum())
        if differ and not changed:
            raise AssertionError(f"jamba smoke {mode} greedy tokens differ: "
                                 f"card {out["card"][1].tolist()} vs CPU "
                                 f"{out['cpu'][1].tolist()}")
        log(f"jamba smoke serve {mode} {SMOKE}: greedy tokens card "
            f"{out["card"][1].tolist()}, CPU {out['cpu'][1].tolist()}: {differ} "
            f"differ (one float32 step of weight jitter on the CPU changes up "
            f"to {changed}); prefill logits {rel:.3e} of max |logit| apart "
            f"(jitter moves them {spread:.3e}, allowed {allowed:.3e}); "
            f"{len(calls)} int8 convs equal to their plain versions on the "
            f"card's inputs; card launches {out["card"][2]}")


def _serve_request(serve, model, params, prompts, gen, want, what) -> dict:
    """One full-width request after a warm-up one: launches (checked
    against ``want``), TTFT, decode step, tokens/s, peak memory, the card's
    busy share of a prefill and of a decode step, max |x| after each layer
    and the cache bytes."""
    cfg = model.cfg
    B, P = prompts.shape
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    serve.generate(model, params, prompts, gen_len=2, cache_len=cache_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    toks, _ = serve.generate(model, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != want:
        raise AssertionError(f"{what} launch counts {launches}, expected {want}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{what}: bad tokens {tuple(toks.shape)}")
    layer_max: list = []
    with torch.no_grad():
        model.prefill(params, {"tokens": prompts}, record=layer_max)
        logits, cache = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len)
        step, _ = model.decode_step(params, cache, toks[:, :1], P)
    for name, t in (("prefill", logits), ("decode step", step)):
        if t.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError(f"{what} {name} logits not finite / bad shape")
    nbytes = serve.cache_nbytes(model.cache_defs(B, cache_len), cfg.param_dtype)
    prof = {
        "prefill": profile_busy(lambda: serve.prefill_cache(
            model, params, prompts, cache_len=cache_len)),
        "decode_step": profile_busy(lambda: model.decode_step(
            params, cache, toks[:, :1], P)),
    }
    for name, r in prof.items():
        log(f"profile {what} {name}: wall {r['wall_ms']:.3f} ms, card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    step_ms = statistics.median(stats["step_s"]) * 1e3
    res = dict(tok_per_s=B * gen / wall, ttft_ms=stats["ttft_s"] * 1e3,
               decode_step_ms=step_ms, wall_s=wall, peak_mem_gb=peak,
               launches=launches, cache_len=cache_len, kv_cache_bytes=nbytes,
               layer_absmax=layer_max,
               max_abs_logit=logits.abs().max().item(),
               busy_share={k: r["busy_share"] for k, r in prof.items()},
               busy_ms={k: r["busy_ms"] for k, r in prof.items()})
    log(f"{what} B={B} P={P} gen={gen}: {res['tok_per_s']:.1f} tok/s, TTFT "
        f"{res['ttft_ms']:.2f} ms, decode step {step_ms:.3f} ms (median of "
        f"{len(stats['step_s'])}), {wall:.3f}s, peak mem {peak:.2f} GB, "
        f"kv-cache bytes {nbytes}, launches {launches}; max |x| after each "
        f"layer {[f'{m:.3e}' for m in layer_max]}, max |logit| "
        f"{res['max_abs_logit']:.3e}; sample {toks[0, :8].tolist()}")
    return res


def phase_full_serve_jamba(serve, models, configs) -> dict:
    """jamba-1.5-large at full width, cut to one period and no experts
    (bf16, random weights from a seeded generator), one request fp, then
    the same weights with the seven conv weights quantized
    (``--quant int8 --kv-quant int8``)."""
    cfg = configs.get_config(JAMBA).replace(
        **JAMBA_CUT, conv_backend="sliding_pallas", attn_decode="fused")
    model = models.build_model(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    from repro_torch.distributed.sharding import iter_leaves

    n_params = sum(t.numel() for _, t in iter_leaves(params))
    if n_params != JAMBA_PARAMS:
        raise AssertionError(f"{n_params} params, expected {JAMBA_PARAMS}")
    log(f"full width {cfg.name} cut to {JAMBA_CUT}: {n_params} params "
        f"({cfg.param_dtype}), d {cfg.d_model}, d_inner {cfg.mamba_d_inner}, "
        f"init {time.perf_counter() - t0:.2f}s")
    B, P, gen = SERVE["B"], SERVE["P"], SERVE["gen"]
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, P)),
                              dtype=torch.int32, device=DEV)
    n_mamba = cfg.attn_every - 1
    fp = _serve_request(serve, model, params, prompts, gen,
                        only(conv1d_depthwise=n_mamba,
                             attention_decode=gen - 1), "jamba full-width fp")

    model8 = models.build_model(cfg.replace(kv_quant="int8"))
    zero_launches()
    t0 = time.perf_counter()
    cfg_q, qparams = serve.quantize_for_serving(model8, params, prompts)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib = read_launches()
    if calib != only(conv1d_depthwise=n_mamba) or cfg_q.conv_precision != "w8a8":
        raise AssertionError(f"jamba calibration launches {calib}")
    int8 = _serve_request(serve, models.build_model(cfg_q), qparams, prompts,
                          gen, only(conv1d_depthwise_quant=n_mamba,
                                    attention_decode_int8=gen - 1),
                          "jamba full-width int8")
    int8.update(calibration_s=calib_s, calibration_launches=calib,
                kv_cache_bytes_fp=fp["kv_cache_bytes"])
    log(f"jamba int8 kv-cache bytes {int8['kv_cache_bytes']} (fp "
        f"{fp['kv_cache_bytes']}, ratio "
        f"{fp['kv_cache_bytes'] / int8['kv_cache_bytes']:.2f}x); calibration "
        f"{calib_s:.2f}s with launches {calib}")
    return dict(fp=fp, int8=int8, n_params=n_params)


def log_depthwise_plans(s) -> None:
    """Log the launch plans of rows 3 and 15 (bf16 x; int8 codes) at shape
    ``s`` on this card (``gemm_plan.depthwise_plan``)."""
    from repro_torch.kernels import build, gemm_plan
    lout = (s["L"] - s["K"]) // s["stride"] + 1
    for what, elem in (("bf16", 2), ("int8", 1)):
        plan = gemm_plan.depthwise_plan(s["B"], lout, s["C"], elem, s["K"],
                                        s["stride"], build.sm_count(
                                            torch.device(DEV)))
        log(f"depthwise plan {s} {what}: {plan}")


def phase_jamba_times(sc, sq, ad, launches, errs) -> tuple[list, dict]:
    """The depthwise kernels at mamba's prefill shape beside their plain
    versions, one library call and the bound; the attention kernels at
    jamba's decode shape (G=8, D=128). Returns the two depthwise rows and
    the attention times by kernel name."""
    s = DEPTHWISE_MAIN
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")
    log_depthwise_plans(s)
    # fp: the library is F.conv1d(groups=C) (cuDNN; TF32 off, bf16 anyway)
    # on x in its (B, C, L) layout, made ahead, + bias + silu
    sets = []
    for i in range(4):  # 4 inputs of 34 MB: > 50 MB
        x, w, b = depthwise_inputs(50 + i, B, L, C, K, torch.bfloat16)
        sets.append((x, w, b, x.transpose(1, 2).contiguous(),
                     w.t().contiguous()[:, None, :]))

    def library(x, w, b, x_lib, w_lib):
        return F.silu(F.conv1d(x_lib, w_lib, b.to(x_lib.dtype), groups=C))

    x, w, b, x_lib, w_lib = sets[0]
    close(library(*sets[0]).transpose(1, 2),
          sc.conv1d_depthwise_plain(x, w, b, activation="silu"), LIBTOL,
          "library depthwise")
    nbytes = 2 * (B * L * C + K * C + B * lout * C) + 4 * C
    ops = 2 * K * B * lout * C
    bms, by = bound_ms(nbytes, ops, torch.bfloat16)
    fp = dict(timings(
        cycling(lambda x, w, b, *_: sc.conv1d_depthwise(x, w, b,
                                                        activation="silu"), sets),
        cycling(lambda x, w, b, *_: sc.conv1d_depthwise_plain(
            x, w, b, activation="silu"), sets),
        cycling(library, sets)), bound_ms=bms, bound_by=by, bytes=nbytes,
        ops=ops)
    log(f"time depthwise {s} bf16 silu: {json.dumps(fp)}")
    del sets

    # int8 w8a8, bf16 out: no PyTorch call computes it; the library is the
    # codes widened to bf16 ahead, F.conv1d(groups=C), then the dequant,
    # bias and silu in torch
    sets = []
    for i in range(6):  # 6 inputs of 17 MB: > 50 MB
        x, w, ws, b, xs = dw_quant_inputs(60 + i, B, L, C, K, "w8a8")
        sets.append((x, w, ws, b, xs, x.transpose(1, 2).to(torch.bfloat16)
                     .contiguous(), w.t().to(torch.bfloat16).contiguous()[:, None, :],
                     (ws * xs).reshape(C, 1)))

    def qkernel(x, w, ws, b, xs, *_):
        return sq.conv1d_depthwise_quant(x, w, ws, b, x_scale=xs,
                                         activation="silu",
                                         out_dtype=torch.bfloat16)

    def qplain(x, w, ws, b, xs, *_):
        return sq.conv1d_depthwise_quant_plain(x, w, ws, b, x_scale=xs,
                                               activation="silu",
                                               out_dtype=torch.bfloat16)

    def qlibrary(x, w, ws, b, xs, x_lib, w_lib, s_lib):
        acc = F.conv1d(x_lib, w_lib, groups=C)
        return F.silu(acc.float() * s_lib + b[:, None]).to(torch.bfloat16)

    close(qlibrary(*sets[0]).transpose(1, 2), qplain(*sets[0]), LIBTOL,
          "library int8 depthwise")
    nbytes = B * L * C + K * C + 4 * C + 4 * C + 2 * B * lout * C
    bms, by = bound_ms(nbytes, ops, torch.int8)
    q = dict(timings(cycling(qkernel, sets), cycling(qplain, sets),
                     cycling(qlibrary, sets)),
             bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time int8 depthwise {s} w8a8 bf16 out silu: {json.dumps(q)}")
    del sets

    # attention at jamba's decode shape, the lengths of the request's middle
    # decode step
    Ba, S, KV, G, D = (ATTN_JAMBA[n] for n in ("B", "S", "KV", "G", "D"))
    lens = [272] * Ba
    attn = {}
    for name, make in (
            ("attention_decode", lambda i: attn_inputs(
                70 + i, **ATTN_JAMBA, dtype=torch.bfloat16, lengths=lens)),
            ("attention_decode_int8", lambda i: attn_int8_inputs(
                90 + i, **ATTN_JAMBA, q_dtype=torch.bfloat16, lengths=lens))):
        sets = []
        for i in range(16):  # 16 caches of 4.7 MB (bf16): > 50 MB
            args = make(i)
            mask = (torch.arange(S, device=DEV)[None, :]
                    < args[3][:, None])[:, None, None, :]
            sets.append((*args, mask))
        int8 = name.endswith("int8")

        def alibrary(q, k, v, ln, *rest, int8=int8):
            mask = rest[-1]
            if int8:  # the cache dequantized to bf16 first
                k = (k.float() * rest[0]).to(q.dtype)
                v = (v.float() * rest[1]).to(q.dtype)
            return F.scaled_dot_product_attention(
                q.reshape(Ba, KV * G, 1, D), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=mask, enable_gqa=True)

        close(alibrary(*sets[0]).float().reshape(Ba, KV, G, D),
              ad.attention_decode_plain(*sets[0][:-1]), BTOL,
              f"library {name} jamba shape")
        kv_bytes = (1 if int8 else 2) * 2 * sum(lens) * KV * D
        scale_bytes = 2 * 4 * sum(lens) * KV if int8 else 0
        nbytes = (2 * Ba * KV * G * D + kv_bytes + scale_bytes + 4 * Ba
                  + 4 * Ba * KV * G * D)
        a_ops = 4 * G * D * KV * sum(lens)
        bms, by = bound_ms(nbytes, a_ops, torch.float32 if int8 else
                           torch.bfloat16)
        attn[name] = dict(timings(
            cycling(lambda *a: ad.decode_attention(*a[:-1]), sets),
            cycling(lambda *a: ad.attention_decode_plain(*a[:-1]), sets),
            cycling(alibrary, sets)),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=a_ops,
            per=f"launch: B=4 S=288 KV=8 G=8 D=128, bf16 q, "
                f"{'int8' if int8 else 'bf16'} cache, lengths 272")
        log(f"time {name} {ATTN_JAMBA} lengths {lens}: {json.dumps(attn[name])}")
        del sets
    rows = [
        dict(name="conv1d_depthwise", route="cuda",
             source="src/repro_torch/kernels/csrc/conv1d_depthwise.cu",
             replaces="src/repro/kernels/sliding_conv1d.py:376",
             launches=launches["conv1d_depthwise"],
             max_abs_err=errs["conv1d_depthwise"],
             per="launch: mamba prefill conv B=4 L=259 C=16384 K=4 bf16, "
                 "bias + silu; library: F.conv1d(groups=C) + silu",
             **{k: fp[k] for k in keys + ("bound_by",)}),
        dict(name="conv1d_depthwise_quant", route="cuda",
             source="src/repro_torch/kernels/csrc/conv1d_depthwise_quant.cu",
             replaces="src/repro/kernels/sliding_conv_quant.py:534",
             launches=launches["conv1d_depthwise_quant"],
             max_abs_err=errs["conv1d_depthwise_quant"],
             per="launch: mamba prefill conv w8a8 B=4 L=259 C=16384 K=4, "
                 "bf16 out, bias + silu; library: no PyTorch call computes "
                 "it: the codes widened to bf16 ahead, F.conv1d(groups=C), "
                 "then dequant + bias + silu in torch",
             **{k: q[k] for k in keys + ("bound_by",)}),
    ]
    return rows, attn


# ---------------------------------------------------------------------------
# jamba training
# ---------------------------------------------------------------------------

# mamba's conv in a full-width training step (DEPTHWISE_TRAIN: B=2, 512
# tokens and K-1=3 rows of CAUSAL padding, d_inner 16384, K 4, bf16) comes
# from analysis.contracts
# the full-width run: phase 18's cut, B=2, 512 tokens (two SSM chunks of
# 256, so the carried state is exercised), 6 steps, 2 of them warm-up
JAMBA_TRAIN = dict(B=2, seq=512, steps=6, warmup=2)
MAMBA_POS = (0, 1, 2, 3, 5, 6, 7)  # the Mamba positions of a period


def rescale_fan_in(params, defs, iter_leaves,
                   stacks=("periods", "blocks")) -> None:
    """Rescale every period- or layer-stacked fan-in weight (under one of
    ``stacks``) to std 1/sqrt of its input width (experts and the attention
    output projection, (L, H, hd, D), contract more; rwkv6's (L, d, d)
    ``wo`` does not), in place: a well-conditioned model from the
    reference's init, whose fan-in quirk draws these with std 1/sqrt(stacked
    count), 1 when a jamba model has one period (ROADMAP Queue 3). No
    package's init changes."""
    want = dict(iter_leaves(defs))
    for path, t in iter_leaves(params):
        d, parts = want[path], path.split("/")
        if parts[0] not in stacks or d.init != "fan_in":
            continue
        heads_in = parts[-1] == "wo" and len(d.shape) == 4
        fan = (d.shape[2] if "moe" in parts else
               d.shape[1] * d.shape[2] if heads_in else d.shape[1])
        if d.shape[0] > 1:  # drawn with std 1/sqrt(stacked layers)
            t.mul_(d.shape[0] ** 0.5)
        t.div_(fan ** 0.5)


def phase_depthwise_train_kernels(sc, sb, ops) -> float:
    """The depthwise dw kernel, the forward kernel's saved pre-activation
    and the whole ``Conv1dDepthwise`` against their plain versions; returns
    the dw kernel's max |err| at the full-width training shape."""
    s = DEPTHWISE_TRAIN
    err_main = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x, dz = dw_inputs(80, s["B"], s["L"], s["C"], s["C"], s["K"],
                          s["stride"], dtype)
        got = sb.conv1d_depthwise_bwd_dw(x, dz, s["K"], has_bias=True)
        want = sb.conv1d_depthwise_bwd_dw_plain(x, dz, s["K"], has_bias=True)
        what = f"depthwise dw main {s} {dtype}"
        err = max(close(got[0], want[0], TOL, what, scaled=True),
                  close(got[1], want[1], TOL, what + " db", scaled=True))
        err_main = max(err_main, err)
        log(f"{what}: max|err| {err:.3e} (of max |dw| "
            f"{want[0].abs().max().item():.1f})")
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (K, stride, (C, L)) in enumerate(itertools.product(
                (1, 2, 3, 4, 5, 9), (1, 2),
                ((37, 203), (600, 9), (16384, 45)))):
            with_bias = i % 2 == 0
            x, dz = dw_inputs(i, 3, L, C, C, K, stride, dtype, offset=i % 3)
            what = (f"depthwise dw edge K={K} s={stride} C={C} L={L} "
                    f"bias={with_bias} offset={i % 3} {dtype}")
            got = sb.conv1d_depthwise_bwd_dw(x, dz, K, stride=stride,
                                             has_bias=with_bias)
            want = sb.conv1d_depthwise_bwd_dw_plain(x, dz, K, stride=stride,
                                                    has_bias=with_bias)
            close(got[0], want[0], TOL, what, scaled=True)
            if with_bias:
                close(got[1], want[1], TOL, what + " db", scaled=True)
            elif got[1] is not None:
                raise AssertionError(f"{what}: db without a bias")
            n += 1
    log(f"depthwise dw edge shapes: {n} cases within tolerance")

    # the forward kernel's saved pre-activation: y as without it, z the
    # post-bias sum (the plain version's bits in float32)
    x, w, b = depthwise_inputs(81, s["B"], s["L"], s["C"], s["K"],
                               torch.bfloat16)
    y, z = sc.conv1d_depthwise(x, w, b, activation="silu", save_preact=True)
    py, pz = sc.conv1d_depthwise_plain(x, w, b, activation="silu",
                                       save_preact=True)
    err = max(dw_check(y, py, "save_preact y main"),
              dw_check(z, pz, "save_preact z main"))
    if not torch.equal(y, sc.conv1d_depthwise(x, w, b, activation="silu")):
        raise AssertionError("save_preact changes y")
    log(f"depthwise save_preact {s} bf16 silu: y and z max|err| {err:.3e}")
    for i, (dtype, K, stride, act) in enumerate(itertools.product(
            (torch.float32, torch.bfloat16), (2, 4, 5), (1, 2),
            ("silu", "gelu"))):
        x, w, b = depthwise_inputs(90 + i, 3, 203, 600 if i % 2 else 37, K,
                                   dtype, offset=i % 3)
        args = dict(stride=stride, activation=act, save_preact=True)
        what = f"depthwise save_preact edge K={K} s={stride} {act} {dtype}"
        y, z = sc.conv1d_depthwise(x, w, b, **args)
        py, pz = sc.conv1d_depthwise_plain(x, w, b, **args)
        dw_check(y, py, what + " y")
        dw_check(z, pz, what + " z")
    log("depthwise save_preact edge shapes within tolerance")

    # the whole autograd Function at the training shape, one cotangent
    B, C, K = s["B"], s["C"], s["K"]
    Lx = s["L"] - (K - 1)  # the unpadded input: CAUSAL padding adds K-1
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=DEV).manual_seed(82)
        x = torch.randn((B, Lx, C), generator=g, device=DEV).to(dtype)
        leaves = [x, (torch.randn((K, C), generator=g, device=DEV)
                      / K ** 0.5).to(dtype),
                  (torch.randn((C,), generator=g, device=DEV) * 0.1).to(dtype)]
        ct = torch.randn((B, Lx, C), generator=g, device=DEV).to(dtype)

        def conv_grads():
            xg, wg, bg = (t.detach().requires_grad_(True) for t in leaves)
            y = ops.conv1d_depthwise(xg, wg, bias=bg, activation="silu")
            return torch.autograd.grad((y.float() * ct.float()).sum(),
                                       (xg, wg, bg))

        zero_launches()
        got = conv_grads()
        launches = read_launches()
        with plain_kernels():
            want = conv_grads()
        if launches != only(conv1d_depthwise=2, conv1d_depthwise_bwd_dw=1):
            raise AssertionError(f"depthwise autograd launches {launches}")
        for name, a, b_ in zip(("dx", "dw", "db"), got, want):
            what = f"Conv1dDepthwise {name} {dtype}"
            err = (close(a, b_, TOL, what, scaled=True)
                   if dtype == torch.float32 else bf16_close(a, b_, what))
            log(f"Conv1dDepthwise (B={B}, L={Lx}, C={C}, K={K}) {dtype} silu, "
                f"kernels vs plain: {name} max|err| {err:.3e} (of max "
                f"{b_.float().abs().max().item():.2f})")
    torch.cuda.synchronize()
    return err_main


def phase_smoke_train_jamba(models, configs, optim, steps_mod, train,
                            map_tree, iter_leaves):
    """jamba's smoke config (float32, 4 experts) with int8 moments, as
    jamba's own config keeps them: one set of weights trained 4 steps
    through the depthwise kernels on the card and through their plain
    versions on the CPU, the same token batches. At the reference's init
    this model's gradients are chaotic (on the CPU, summing the convs in
    another order moves the loss by up to 5e-3 within 4 steps), so the
    weights are rescaled to std 1/sqrt(input width) first
    (``rescale_fan_in``); the control is the CPU run with the convs summed
    in another order (``xla``), and the card is held to three times the
    control's difference or 1e-4, the larger, as in phase 8."""
    base = configs.smoke_config(configs.get_config(JAMBA)).replace(grad_accum=1)
    B, seq, n = SMOKE_TRAIN["B"], SMOKE_TRAIN["seq"], SMOKE_TRAIN["steps"]
    opt_cfg = optim.OptConfig(total_steps=n, warmup_steps=5,
                              state_dtype="int8")
    model = models.build_model(base)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rescale_fan_in(cpu_params, model.param_defs(), iter_leaves)
    losses, moved = {}, {}
    for run, dev, backend in (("card", DEV, "sliding_pallas"),
                              ("cpu", "cpu", "sliding_pallas"),
                              ("control", "cpu", "xla")):
        cfg = base.replace(conv_backend=backend)
        m = models.build_model(cfg)
        params = map_tree(lambda t: t.to(dev, copy=True), cpu_params)
        state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
        step_fn = steps_mod.make_train_step(m, opt_cfg)
        batches = train_batches(cfg, B, seq, n, 0, dev, train)
        zero_launches()
        losses[run] = []
        for batch in batches:
            state, metrics = step_fn(state, batch)
            losses[run].append(float(metrics["loss"]))
        if run == "card":
            launches = read_launches()
            want = only(conv1d_depthwise=21 * n, conv1d_depthwise_bwd_dw=7 * n)
            if launches != want:
                raise AssertionError(f"jamba smoke train launches {launches}, "
                                     f"expected {want}")
            moved = {j: (params["periods"][f"pos{j}"]["mamba"]["conv_w"].cpu()
                         - cpu_params["periods"][f"pos{j}"]["mamba"]["conv_w"]
                         ).abs().max().item() for j in MAMBA_POS}
    card, cpu, ctrl = (np.array(losses[k]) for k in ("card", "cpu", "control"))
    rel = np.abs(card - cpu) / np.abs(cpu)
    rel_ctrl = np.abs(ctrl - cpu) / np.abs(cpu)
    allowed = np.maximum(1e-4, 3 * rel_ctrl)
    if not (np.isfinite(card).all() and (rel <= allowed).all()):
        raise AssertionError(f"jamba smoke train losses card {card} vs CPU "
                             f"{cpu} (control {ctrl})")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"jamba smoke conv_w did not move: {moved}")
    log(f"jamba smoke train {SMOKE_TRAIN} (weights rescaled to std "
        f"1/sqrt(input width), int8 moments): losses card {card.tolist()} vs "
        f"CPU {cpu.tolist()}: rel diff {rel.tolist()}; control (CPU, xla "
        f"convs) rel diff {rel_ctrl.tolist()}; card launches per step "
        f"{{conv1d_depthwise: 21, conv1d_depthwise_bwd_dw: 7}}")


def phase_full_train_jamba(models, configs, optim, steps_mod, train,
                           iter_leaves) -> dict:
    """jamba-1.5-large at full width, phase 18's cut (one period, no
    experts, every width published), bf16 params, int8 moments, remat per
    position, B=2, 512 tokens, 6 steps, on the reference's init rescaled to
    std 1/sqrt(input width) (at the init itself the model collapses after
    layer 0 and six of the seven Mamba blocks would see zero gradient)."""
    cfg = configs.get_config(JAMBA).replace(
        **JAMBA_CUT, conv_backend="sliding_pallas", grad_accum=1)
    model = models.build_model(cfg)
    B, seq, n, warm = (JAMBA_TRAIN[k] for k in ("B", "seq", "steps", "warmup"))
    opt_cfg = optim.OptConfig(total_steps=n, warmup_steps=max(n // 20, 5),
                              state_dtype=cfg.opt_state_dtype)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    if n_params != JAMBA_PARAMS:
        raise AssertionError(f"{n_params} params, expected {JAMBA_PARAMS}")
    log(f"full-width train {cfg.name} cut to {JAMBA_CUT} (one period, no "
        f"experts, every width published): {n_params} params "
        f"({cfg.param_dtype}), {cfg.opt_state_dtype} moments, remat "
        f"{cfg.remat}; the reference's init rescaled to std 1/sqrt(input "
        f"width); set-up {time.perf_counter() - t0:.2f}s")
    conv0 = {j: params["periods"][f"pos{j}"]["mamba"]["conv_w"].clone()
             for j in MAMBA_POS}
    step_fn = steps_mod.make_train_step(model, opt_cfg)
    batches = train_batches(cfg, B, seq, n, 0, DEV, train)
    # every Mamba block's conv weight gets a gradient (before any update)
    loss0, grads = steps_mod.loss_and_grads(model, params, batches[0])
    conv_g = {j: grads["periods"][f"pos{j}"]["mamba"]["conv_w"].float().abs()
              .max().item() for j in MAMBA_POS}
    del grads
    if not (all(g > 0 and np.isfinite(g) for g in conv_g.values())
            and np.isfinite(float(loss0))):
        raise AssertionError(f"conv_w grads {conv_g}, loss {float(loss0)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    want = only(conv1d_depthwise=21 * n, conv1d_depthwise_bwd_dw=7 * n)
    if launches != want:
        raise AssertionError(f"jamba train launch counts {launches}, "
                             f"expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite jamba train loss: {losses}")
    moved = {j: (params["periods"][f"pos{j}"]["mamba"]["conv_w"].float()
                 - conv0[j].float()).abs().max().item() for j in MAMBA_POS}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"conv_w did not move: {moved}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(times[warm:]) * 1e3

    def one_step():
        with torch.enable_grad():
            step_fn(state, batches[0])

    prof = profile_busy(one_step, reps=1)
    # where a step's time goes: forward + backward, then the update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = steps_mod.loss_and_grads(model, params, batches[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    optim.apply_updates(params, grads, state["opt"], opt_cfg)
    torch.cuda.synchronize()
    fwd_bwd_ms, update_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    del grads
    res = dict(losses=losses, step_ms=step_ms, fwd_bwd_ms=fwd_bwd_ms,
               update_ms=update_ms, step_ms_all=[t * 1e3 for t in times],
               tok_per_s=B * seq / (step_ms / 1e3), peak_mem_gb=peak,
               launches=launches,
               launches_per_step={k: v // n for k, v in launches.items()},
               busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
               profiled_wall_ms=prof["wall_ms"],
               kernels_per_step=prof["kernels"], top=prof["top"],
               conv_w_grad_absmax=conv_g, conv_w_moved=moved,
               n_params=n_params)
    log(f"full-width jamba train B={B} seq={seq}: losses "
        f"{[round(x, 4) for x in losses]}; conv_w max |grad| per Mamba "
        f"block {[f'{g:.3e}' for g in conv_g.values()]}")
    log(f"full-width jamba train: step {step_ms:.1f} ms (median of "
        f"{n - warm} after {warm} warm-up), {res['tok_per_s']:.0f} tokens/s, "
        f"peak mem {peak:.2f} GB, launches per step "
        f"{res['launches_per_step']}, conv_w moved "
        f"{[f'{m:.3e}' for m in moved.values()]}")
    log(f"profile jamba train step: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['kernels']} kernels; top: {prof['top']}; apart: forward + "
        f"backward {fwd_bwd_ms:.1f} ms, AdamW update (int8 moments, in "
        f"place) {update_ms:.1f} ms")
    return res


def phase_depthwise_train_times(sc, sb, launches, err) -> tuple[dict, dict]:
    """The depthwise dw kernel at the full-width training shape beside its
    plain version, ``torch.nn.grad.conv1d_weight(groups=C)`` (cuDNN, dw
    only) and the bound; the forward depthwise kernel at the training
    shape with z written and without. Returns the dw kernel's row and the
    forward kernel's two times."""
    s = DEPTHWISE_TRAIN
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")
    from repro_torch.kernels import build, gemm_plan
    sms = build.sm_count(torch.device(DEV))
    log_depthwise_plans(s)
    for what, elem in (("bf16", 2), ("f32", 4)):
        log(f"depthwise dw plan {s} {what} on {sms} SMs: "
            f"{gemm_plan.depthwise_dw_plan(B, lout, C, elem, K, 1, sms)}")
    sets = []
    for i in range(2):  # 2 inputs of 67 MB: > 50 MB
        x, dz = dw_inputs(83 + i, B, L, C, C, K, 1, torch.bfloat16)
        # the library's layouts, (B, C, L), made ahead
        sets.append((x, dz, x.transpose(1, 2).contiguous(),
                     dz.transpose(1, 2).contiguous()))

    def library(x, dz, x_lib, dz_lib):
        return torch.nn.grad.conv1d_weight(x_lib, (C, 1, K), dz_lib, groups=C)

    x, dz, *_ = sets[0]
    want = sb.conv1d_depthwise_bwd_dw_plain(x, dz, K, has_bias=True)
    close(library(*sets[0]).reshape(C, K).t(), want[0], BTOL,
          "library depthwise dw", scaled=True)
    nbytes = 2 * (B * L * C + B * lout * C) + 4 * (K * C + C)
    ops = 2 * K * B * lout * C + B * lout * C
    bms, by = bound_ms(nbytes, ops, torch.bfloat16)
    t = dict(timings(
        cycling(lambda x, dz, *_: sb.conv1d_depthwise_bwd_dw(
            x, dz, K, has_bias=True), sets),
        cycling(lambda x, dz, *_: sb.conv1d_depthwise_bwd_dw_plain(
            x, dz, K, has_bias=True), sets),
        cycling(library, sets)), bound_ms=bms, bound_by=by, bytes=nbytes,
        ops=ops)
    log(f"time depthwise dw {s} bf16 with db: {json.dumps(t)}")
    del sets

    sets = []
    for i in range(3):  # 3 inputs of 34 MB: > 50 MB
        x, w, b = depthwise_inputs(86 + i, B, L, C, K, torch.bfloat16)
        # the library's layouts, (B, C, L) and (C, 1, K), made ahead
        sets.append((x, w, b, x.transpose(1, 2).contiguous(),
                     w.t().contiguous()[:, None, :]))
    fwd = {}
    for name, z in (("no_z_ms", False), ("z_ms", True), ("no_z_ms_again", False),
                    ("z_ms_again", True)):
        fwd[name] = card_ms(cycling(
            lambda x, w, b, *_, z=z: sc.conv1d_depthwise(
                x, w, b, activation="silu", save_preact=z), sets))
    # cuDNN's F.conv1d(groups=C) + bias + silu, as at the prefill shape
    x, w, b, x_lib, w_lib = sets[0]
    close(F.silu(F.conv1d(x_lib, w_lib, b.to(x_lib.dtype),
                          groups=C)).transpose(1, 2),
          sc.conv1d_depthwise_plain(x, w, b, activation="silu"), LIBTOL,
          "library depthwise, training shape")
    fwd["library_ms"] = card_ms(cycling(
        lambda x, w, b, x_lib, w_lib: F.silu(F.conv1d(
            x_lib, w_lib, b.to(x_lib.dtype), groups=C)), sets))
    fwd["per"] = f"launch: B={B} L={L} C={C} K={K} bf16 silu, training shape"
    # the bounds: x, w, bias read once, y (and z) written once
    for key, n_out in (("bound_ms", 1), ("z_bound_ms", 2)):
        fwd[key], fwd[key.replace("ms", "by")] = bound_ms(
            2 * (B * L * C + K * C + n_out * B * lout * C) + 4 * C,
            2 * K * B * lout * C, torch.bfloat16)
    log(f"time depthwise forward at the training shape, z written or not "
        f"(in turns): {json.dumps(fwd)}")
    row = dict(name="conv1d_depthwise_bwd_dw", route="cuda",
               source="src/repro_torch/kernels/csrc/conv1d_depthwise_bwd.cu",
               replaces="src/repro/kernels/sliding_conv_bwd.py:336",
               launches=launches["conv1d_depthwise_bwd_dw"], max_abs_err=err,
               per=f"launch: mamba conv dw+db in a jamba train step, x "
                   f"({B}, {L}, {C}), dz ({B}, {lout}, {C}), K={K}, bf16; "
                   f"library: torch.nn.grad.conv1d_weight(groups=C), dw only",
               **{k: t[k] for k in keys + ("bound_by",)})
    return row, fwd


# ---------------------------------------------------------------------------
# llava serving
# ---------------------------------------------------------------------------

LLAVA = "llava-next-34b"
# the full-width cut: 60 -> 40 layers, every width the published one
# (23,291,426,816 params, 46.6 GB in bf16): the init draws a leaf in
# float32, so at 40 layers it peaks near 69 GB of the card's 85
LLAVA_CUT = dict(num_layers=40)
LLAVA_PARAMS = 23_291_426_816
LLAVA_TILES = 5  # anyres: 5 tiles of 336 x 336 (576 patches each) a slot
LLAVA_TILE = 336
# the patch embedding of the full-width request (PATCH_MAIN: B=4 slots x 5
# tiles) and llava's decode read (ATTN_LLAVA: 56 query heads over 8 KV
# heads, head dim 128, 2880 + 256 + 32 cache rows) come from
# analysis.contracts
# the paper's fig1 shapes: (1, 128, 128, 32) x (k, k, 32, 32), stride 1
FIG1 = [dict(B=1, H=128, W=128, Cin=32, Cout=32, k=k, stride=1)
        for k in (3, 5, 17, 31)]


def conv2d_inputs(seed, B, H, W, Cin, Cout, k, dtype, with_bias=True,
                  uniform=False):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = (torch.rand if uniform else torch.randn)(
        (B, H, W, Cin), generator=g, device=DEV).to(dtype)
    w = (torch.randn((k, k, Cin, Cout), generator=g, device=DEV)
         / (k * k * Cin) ** 0.5).to(dtype)
    b = torch.randn((Cout,), generator=g, device=DEV) if with_bias else None
    return x, w, b


def conv2d_check(s2, x, w, b, what, **args) -> float:
    """The kernel against its plain version on the same inputs. float32:
    within TOL. bfloat16: the kernel's output within one bf16 step of the
    plain version's float32 sum (the plain version on the same bf16
    operands, not rounded), plus 1e-5 of max |y| for summing hundreds of
    terms in another float32 order: an output that cancels to near zero
    moves by more than its own bf16 step from that alone."""
    got = s2.conv2d_sliding(x, w, b, **args)
    if x.dtype != torch.bfloat16:
        return close(got, s2.conv2d_sliding_plain(x, w, b, **args), TOL, what)
    return bf16_step_close(
        got, s2.conv2d_sliding_plain(x.float(), w.float(), b, **args), what)


def bf16_step_close(got, want, what) -> float:
    """The kernel's bfloat16 output within one bf16 step of the plain
    version's float32 value, plus 1e-5 of max |y|."""
    if got.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"bfloat16 {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    err = (g - w).abs()
    bad = err > step + 1e-5 * w.abs().max()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements more than a bf16 step off, "
            f"max |err| {err.max().item():.3e}, worst at |want| "
            f"{w[bad].abs().min().item():.3e}")
    return err.max().item()


def phase_conv2d_kernels(s2, ad) -> dict:
    """The 2-D sliding conv kernel against its plain version at the patch
    embedding's shape and at the fig1 shapes, strides, every activation,
    bfloat16 and float32; the attention kernel at llava's decode shape
    (G=7, D=128, S=3168)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        s = PATCH_MAIN
        st = (s["stride"],) * 2
        x, w, b = conv2d_inputs(100, s["B"], s["H"], s["W"], s["Cin"],
                                s["Cout"], s["k"], dtype, uniform=True)
        for bias in (None, b):
            what = f"conv2d patch_embed {s} {dtype} bias={bias is not None}"
            err = conv2d_check(s2, x, w, bias, what, stride=st)
            if dtype == torch.bfloat16 and bias is None:
                errs["conv2d"] = err  # the main path's call
            log(f"{what}: max|err| {err:.3e}")
        for i, s in enumerate(FIG1):
            act = ACTS[i % len(ACTS)]
            x, w, b = conv2d_inputs(110 + i, s["B"], s["H"], s["W"], s["Cin"],
                                    s["Cout"], s["k"], dtype)
            what = f"conv2d fig1 k={s['k']} {dtype} bias {act}"
            err = conv2d_check(s2, x, w, b, what, activation=act)
            log(f"{what}: max|err| {err:.3e}")
        # strides, every activation, Cin 37 (a ragged channel chunk), Cout
        # 70 (a ragged block), odd sizes, bias or none
        for j, (k, st, act, with_bias) in enumerate((
                (3, (2, 2), "none", True), (5, (2, 1), "relu", False),
                (7, (1, 3), "gelu", True), (1, (1, 1), "silu", True),
                (20, (3, 2), "silu", False))):
            x, w, b = conv2d_inputs(120 + j, 3, 61, 77, 37, 70, k, dtype,
                                    with_bias)
            what = f"conv2d edge k={k} s={st} {act} bias={with_bias} {dtype}"
            err = conv2d_check(s2, x, w, b, what, stride=st, activation=act)
            log(f"{what}: max|err| {err:.3e}")

    lens = [0, 1, 3136, 3168]
    q, k, v, ln = attn_inputs(130, **ATTN_LLAVA, dtype=torch.bfloat16,
                              lengths=lens)
    got = ad.decode_attention(q, k, v, ln)
    err = close(got, ad.attention_decode_plain(q, k, v, ln), BTOL,
                "attention llava shape")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("attention: a length-0 slot must give a zero row")
    errs["attention_decode_llava"] = err
    log(f"attention {ATTN_LLAVA} bf16 lengths {lens}: max|err| {err:.3e}")
    torch.cuda.synchronize()
    return errs


def _llava_images(seed, n, size, dtype):
    """``n`` image tiles of size x size x 3 in [0, 1) and the patch weight
    (14, 14, 3, 1152), std 1/sqrt(588), from a seeded generator."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    img = torch.rand((n, size, size, 3), generator=g, device=DEV).to(dtype)
    w = (torch.randn((14, 14, 3, 1152), generator=g, device=DEV)
         / 588 ** 0.5).to(dtype)
    return img, w


def phase_smoke_serve_llava(serve, models, configs, map_tree, llava):
    """llava's smoke config (float32, 2 layers, 16 patches), one set of
    weights on the CPU and on the card: image tiles through
    ``patch_embed`` (the 2-D kernel on the card, its plain version on the
    CPU), then a request with those patches: equal greedy tokens, patches
    and prefill logits within TOL."""
    cfg = configs.smoke_config(configs.get_config(LLAVA))
    model = models.build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    img, w = (t.cpu() for t in _llava_images(140, SMOKE["B"], 56,
                                             torch.float32))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for dev, params in (("cpu", cpu_params),
                        (DEV, map_tree(lambda t: t.to(DEV), cpu_params))):
        zero_launches()
        with torch.no_grad():
            patches = llava.patch_embed(w.to(dev), img.to(dev),
                                        backend="sliding_pallas")
            logits, _ = serve.prefill_cache(model, params, prompts.to(dev),
                                            cache_len=cache_len,
                                            patches=patches)
        toks, _ = serve.generate(model, params, prompts.to(dev),
                                 gen_len=SMOKE["gen"], cache_len=cache_len,
                                 patches=patches)
        out[dev] = (patches.cpu(), logits.cpu(), toks.cpu(), read_launches())
    want = only(conv2d=1, attention_decode=cfg.num_layers * (SMOKE["gen"] - 1))
    if out[DEV][3] != want:
        raise AssertionError(f"llava smoke card launches {out[DEV][3]}, "
                             f"expected {want}")
    perr = close(out[DEV][0], out["cpu"][0], TOL, "llava smoke patches")
    err = close(out[DEV][1], out["cpu"][1], TOL, "llava smoke prefill logits")
    if not torch.equal(out[DEV][2], out["cpu"][2]):
        raise AssertionError(f"llava smoke greedy tokens differ: card "
                             f"{out[DEV][2].tolist()} vs CPU "
                             f"{out['cpu'][2].tolist()}")
    log(f"llava smoke serve {SMOKE}, {cfg.num_patches} patches a slot: greedy "
        f"tokens equal on card and CPU {out[DEV][2].tolist()}; patches max|err| "
        f"{perr:.3e}, prefill logits max|err| {err:.3e}; card launches "
        f"{out[DEV][3]}")


def phase_full_serve_llava(serve, models, configs, llava, iter_leaves, quant,
                           transformer) -> dict:
    """llava-next-34b at full width, cut to 40 layers (bf16, random weights
    from a seeded generator, the reference's init rescaled to std
    1/sqrt(input width)): a request of B=4 slots, each with 5 image tiles
    through ``patch_embed`` on the 2-D kernel (one launch) and P=256
    tokens, 32 generated; the same request int8 on the same weights
    (``_serve_llava_int8``); then one request through the CLI's own path,
    zero patches as the reference serves them."""
    cfg = configs.get_config(LLAVA).replace(**LLAVA_CUT, attn_decode="fused")
    model = models.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    if n_params != LLAVA_PARAMS:
        raise AssertionError(f"{n_params} params, expected {LLAVA_PARAMS}")
    log(f"full width {cfg.name} cut to {LLAVA_CUT}: {n_params} params "
        f"({cfg.param_dtype}), d {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, {cfg.num_patches} patches; the "
        f"reference's init rescaled to std 1/sqrt(input width); init "
        f"{time.perf_counter() - t0:.2f}s, peak {init_peak:.2f} GB")
    B, P, gen = SERVE["B"], SERVE["P"], SERVE["gen"]
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, P)),
                              dtype=torch.int32, device=DEV)
    img, w_patch = _llava_images(150, B * LLAVA_TILES, LLAVA_TILE,
                                 torch.bfloat16)
    prefix = cfg.num_patches
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen, prefix)

    def embed():
        return llava.patch_embed(w_patch, img, backend="sliding_pallas"
                                 ).reshape(B, prefix, llava.VISION_DIM)

    with torch.no_grad():  # warm-up request
        serve.generate(model, params, prompts, gen_len=2, cache_len=cache_len,
                       patches=embed())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        patches = embed()
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - t0) * 1e3
    toks, _ = serve.generate(model, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats, patches=patches)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = only(conv2d=1, attention_decode=cfg.num_layers * (gen - 1))
    if launches != want:
        raise AssertionError(f"llava launch counts {launches}, expected {want}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"llava: bad tokens {tuple(toks.shape)}")
    if (tuple(patches.shape) != (B, prefix, llava.VISION_DIM)
            or not torch.isfinite(patches).all()):
        raise AssertionError(f"llava patches {tuple(patches.shape)} not finite")
    ttft_ms = embed_ms + stats["ttft_s"] * 1e3
    step_ms = statistics.median(stats["step_s"]) * 1e3
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len,
                                            patches=patches)
        step, _ = model.decode_step(params, cache, toks[:, :1], prefix + P)
        # the same request with the kernels' plain versions on the card:
        # patches, prefill logits and one decode step, printed
        with plain_kernels():
            p_plain = embed()
            l_plain, c_plain = serve.prefill_cache(
                model, params, prompts, cache_len=cache_len, patches=p_plain)
            s_plain, _ = model.decode_step(params, c_plain, toks[:, :1],
                                           prefix + P)
    del c_plain
    for what, t in (("prefill", logits), ("decode step", step)):
        if t.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError(f"llava {what} logits not finite / bad shape")
    for what, a, b in (("patches", patches, p_plain),
                       ("prefill logits", logits, l_plain),
                       ("decode-step logits", step, s_plain)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        agree = ((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                 if "logits" in what else float("nan"))
        log(f"llava full width, kernels vs plain versions on the card: {what} "
            f"max |diff| {rel:.3e} of max, argmax agreement {agree:.2f}")
    nbytes = serve.cache_nbytes(model.cache_defs(B, cache_len), cfg.param_dtype)
    prof = {
        "patch_embed": profile_busy(embed, reps=3),
        "prefill": profile_busy(lambda: serve.prefill_cache(
            model, params, prompts, cache_len=cache_len, patches=patches),
            reps=1),
        "decode_step": profile_busy(lambda: model.decode_step(
            params, cache, toks[:, :1], prefix + P)),
    }
    for what, r in prof.items():
        log(f"profile llava {what}: wall {r['wall_ms']:.3f} ms, card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    res = dict(tok_per_s=B * gen / wall, ttft_ms=ttft_ms,
               patch_embed_ms=embed_ms, patch_embed_share=embed_ms / ttft_ms,
               decode_step_ms=step_ms, wall_s=wall, peak_mem_gb=peak,
               init_peak_mem_gb=init_peak, launches=launches,
               cache_len=cache_len, kv_cache_bytes=nbytes,
               max_abs_logit=logits.abs().max().item(),
               busy_share={k: r["busy_share"] for k, r in prof.items()},
               busy_ms={k: r["busy_ms"] for k, r in prof.items()},
               n_params=n_params)
    log(f"llava full-width serve B={B} P={P} gen={gen}, {prefix} patches a "
        f"slot: {res['tok_per_s']:.1f} tok/s, TTFT {ttft_ms:.2f} ms "
        f"(patch_embed {embed_ms:.3f} ms, {100 * res['patch_embed_share']:.2f}%), "
        f"decode step {step_ms:.3f} ms (median of {len(stats['step_s'])}), "
        f"{wall:.3f}s, peak mem {peak:.2f} GB, kv-cache bytes {nbytes}, "
        f"launches {launches}; sample {toks[0, :8].tolist()}")
    fp_ref = dict(patches=patches, logits=logits, kv_cache_bytes=nbytes)
    del cache, step, patches, logits, p_plain, l_plain, s_plain
    res["int8"] = _serve_llava_int8(serve, models, quant, llava, transformer,
                                    cfg, params, prompts, img, w_patch,
                                    cache_len, fp_ref)
    del fp_ref

    # the CLI's own path: zero patches, as the reference serves them
    zero_launches()
    cli: dict = {}
    serve.generate(model, params, prompts, gen_len=gen, cache_len=cache_len,
                   stats=cli)
    cli_launches = read_launches()
    if cli_launches != only(attention_decode=cfg.num_layers * (gen - 1)):
        raise AssertionError(f"llava CLI-path launches {cli_launches}")
    res["cli"] = dict(ttft_ms=cli["ttft_s"] * 1e3,
                      decode_step_ms=statistics.median(cli["step_s"]) * 1e3,
                      launches=cli_launches)
    log(f"llava full-width serve, the CLI's path (zero patches): TTFT "
        f"{res['cli']['ttft_ms']:.2f} ms, decode step "
        f"{res['cli']['decode_step_ms']:.3f} ms, launches {cli_launches}")
    return res


def conv2d_times(s2, s, dtype, act, with_bias, seed, n_sets) -> dict:
    """Row 4 at shape ``s`` (x of ``dtype``, bias or none, activation
    ``act``) beside its plain version, ``F.conv2d`` on channels_last (cuDNN,
    TF32 off) with the bias and activation, and the bound; ``n_sets`` input
    sets cycled (together past the L2)."""
    st = (s["stride"],) * 2
    sets = []
    for i in range(n_sets):
        x, w, b = conv2d_inputs(seed + i, s["B"], s["H"], s["W"], s["Cin"],
                                s["Cout"], s["k"], dtype, with_bias,
                                uniform=s is PATCH_MAIN)
        # the library's layouts made ahead: x as an NCHW view of its
        # NHWC storage (channels_last), w as OIHW in channels_last
        sets.append((x, w, b, x.permute(0, 3, 1, 2),
                     w.permute(3, 2, 0, 1).contiguous(
                         memory_format=torch.channels_last),
                     None if b is None else b.to(dtype)))

    def library(x, w, b, x_lib, w_lib, b_lib):
        y = F.conv2d(x_lib, w_lib, b_lib, stride=st)
        if act == "gelu":
            y = F.gelu(y, approximate="tanh")
        return y.permute(0, 2, 3, 1)

    x, w, b = sets[0][:3]
    want = s2.conv2d_sliding_plain(x, w, b, stride=st, activation=act)
    close(library(*sets[0]), want,
          LIBTOL if dtype == torch.bfloat16 else TOL,
          f"library conv2d {s} {dtype}")
    oh = (s["H"] - s["k"]) // s["stride"] + 1
    ow = (s["W"] - s["k"]) // s["stride"] + 1
    el = x.element_size()
    nbytes = (el * (x.numel() + w.numel() + s["B"] * oh * ow * s["Cout"])
              + (4 * s["Cout"] if with_bias else 0))
    ops = 2 * s["B"] * oh * ow * s["Cout"] * s["k"] ** 2 * s["Cin"]
    bms, by = bound_ms(nbytes, ops, dtype)
    t = dict(timings(
        cycling(lambda x, w, b, *_: s2.conv2d_sliding(
            x, w, b, stride=st, activation=act), sets),
        cycling(lambda x, w, b, *_: s2.conv2d_sliding_plain(
            x, w, b, stride=st, activation=act), sets),
        cycling(library, sets), HALF_BATCHES["p27"]),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time conv2d {s} {dtype} {act} bias={with_bias}: {json.dumps(t)}")
    return t


def phase_conv2d_times(s2, ad, launches, errs) -> tuple[dict, dict]:
    """The 2-D sliding conv kernel at the patch embedding's shape (bf16, the
    main path's call, and f32) and at the fig1 shapes (f32, bias + gelu)
    beside its plain version, ``F.conv2d`` on channels_last (cuDNN, TF32
    off) with the bias and activation, and the bound; the attention kernel
    at llava's decode shape beside its plain version and SDPA
    (``enable_gqa``). Returns the conv2d row and llava's attention times."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")

    main = conv2d_times(s2, PATCH_MAIN, torch.bfloat16, "none", False, 160, 4)
    extra = {"patch_embed_f32": conv2d_times(s2, PATCH_MAIN, torch.float32,
                                             "none", False, 170, 3)}
    for i, s in enumerate(FIG1):  # 2 MB inputs: 26 sets exceed the L2
        extra[f"fig1_k{s['k']}_f32"] = conv2d_times(
            s2, s, torch.float32, "gelu", True, 180 + 30 * i, 26)

    Ba, S, KV, G, D = (ATTN_LLAVA[n] for n in ("B", "S", "KV", "G", "D"))
    lens = [3152] * Ba  # the request's middle decode step
    sets = []
    for i in range(3):  # 3 caches of 52 MB: > 50 MB
        q, k, v, ln = attn_inputs(300 + i, **ATTN_LLAVA, dtype=torch.bfloat16,
                                  lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None])[:, None, None, :]
        sets.append((q, k, v, ln, mask))

    def alibrary(q, k, v, ln, mask):
        return F.scaled_dot_product_attention(
            q.reshape(Ba, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    close(alibrary(*sets[0]).float().reshape(Ba, KV, G, D),
          ad.attention_decode_plain(*sets[0][:-1]), BTOL,
          "library attention llava shape")
    nbytes = (2 * Ba * KV * G * D + 2 * 2 * sum(lens) * KV * D + 4 * Ba
              + 4 * Ba * KV * G * D)
    a_ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, a_ops, torch.bfloat16)
    attn = dict(timings(
        cycling(lambda *a: ad.decode_attention(*a[:-1]), sets),
        cycling(lambda *a: ad.attention_decode_plain(*a[:-1]), sets),
        cycling(alibrary, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=a_ops,
        max_abs_err=errs["attention_decode_llava"],
        per="launch: B=4 S=3168 KV=8 G=7 D=128 bf16, lengths 3152")
    log(f"time attention {ATTN_LLAVA} lengths {lens}: {json.dumps(attn)}")
    row = dict(name="conv2d", route="cuda",
               source="src/repro_torch/kernels/csrc/sliding_conv2d.cu",
               replaces="src/repro/kernels/sliding_conv2d.py:130",
               launches=launches["conv2d"], max_abs_err=errs["conv2d"],
               per="launch: llava patch_embed x (20, 336, 336, 3) bf16, w "
                   "(14, 14, 3, 1152), stride 14, no bias; library: F.conv2d "
                   "channels_last, TF32 off",
               **{k: main[k] for k in keys + ("bound_by",)}, shapes=extra)
    return row, attn


# ---------------------------------------------------------------------------
# llava int8 serving and the trained 2-D conv
# ---------------------------------------------------------------------------

# the paper's fig2 shapes: (1, 96, 96, 32) x (k, k, 32, 32), stride 1
FIG2 = [dict(B=1, H=96, W=96, Cin=32, Cout=32, k=k, stride=1) for k in (3, 17)]
# the 2-D conv's gradient at the grad/fig shapes, with dx: (fig, k, stride,
# activation); strides 1 and 2, activations none, relu and gelu
GRAD_FIG = [("fig1", 3, 1, "relu"), ("fig1", 9, 2, "gelu"),
            ("fig1", 31, 1, "none"), ("fig2", 3, 2, "none"),
            ("fig2", 17, 1, "gelu")]
# the full-width patch-embedding training step: phase 26's tiles, the
# projector at llava's widths (1152 -> 7168 -> 7168)
PATCH_TRAIN = dict(d=7168, steps=4, warmup=1, step=1e-3)


def conv2d_quant_inputs(seed, B, H, W, Cin, Cout, k, mode,
                        x_dtype=torch.float32, with_bias=True):
    """int8 weight codes (k, k, Cin, Cout) with per-Cout scales, and an int8
    input with its scale (w8a8) or a float input (w8a16), scaled so that
    the outputs are of order one."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=DEV,
                             dtype=torch.int32).to(torch.int8)

    n = k * k * Cin
    w = codes((k, k, Cin, Cout))
    ws = (torch.rand((Cout,), generator=g, device=DEV) + 0.5) / (73 * n ** 0.5)
    b = torch.randn((Cout,), generator=g, device=DEV) if with_bias else None
    if mode == "w8a8":
        return codes((B, H, W, Cin)), w, ws, b, torch.tensor(1 / 73, device=DEV)
    x = torch.randn((B, H, W, Cin), generator=g, device=DEV).to(x_dtype)
    return x, w, ws, b, None


def check_conv2d_quant(sq, x, w, ws, b, xs, *, mode, stride, act, out_dtype,
                       requant, what) -> float:
    """The int8 conv2d kernel against its plain version on the same
    inputs: float32 outputs within 1e-5 of max |y|, bfloat16 within one
    bf16 step of the plain float32 value; with ``requant`` the int8 codes
    on a grid that clips the largest outputs: equal with no activation in
    w8a8 (exact sums, the same float32 epilogue), else one apart at most
    and only at ties. Returns the float output's max |err|."""
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    y = sq.conv2d_quant_plain(x, w, ws, b, out_dtype=torch.float32, **args)
    got = sq.conv2d_quant(x, w, ws, b, out_dtype=out_dtype, **args)
    if out_dtype == torch.bfloat16:
        err = bf16_step_close(got, y, what)
    else:
        err = close(got, y, dict(rtol=0.0, atol=1e-5 * max(
            1.0, y.abs().max().item())), what)
    if requant:
        os = (y.abs().max() * 0.8 / 127).reshape(())
        want_q = sq.conv2d_quant_plain(x, w, ws, b, out_scale=os, **args)
        got_q = sq.conv2d_quant(x, w, ws, b, out_scale=os, **args)
        if want_q.abs().max().item() != 127:
            raise AssertionError(f"{what}: the requant clip is not exercised")
        if mode == "w8a8" and act == "none":
            if not torch.equal(got_q, want_q):
                raise AssertionError(f"{what}: requant codes differ")
        else:
            codes_close(got_q, want_q, y / os, what + " requant",
                        tie=1e-4 if mode == "w8a8" else 1e-3,
                        max_frac=1e-4 if mode == "w8a8" else 1e-3)
    return err


def phase_conv2d_quant_kernels(sq, ad) -> dict:
    """28: the int8 conv2d kernel against its plain version at the patch
    embedding (the model path's w8a8 call with a bfloat16 output, float32
    and requantized outputs, and w8a16), at the fig1 and fig2 shapes and at
    edge shapes; the int8 attention kernel at llava's decode shape (G=7,
    D=128, S=3168) with a length-0 slot. Returns the max |err| of the model
    path's conv call and of the attention."""
    s = PATCH_MAIN
    st = (s["stride"],) * 2
    dims = (s["B"], s["H"], s["W"], s["Cin"], s["Cout"], s["k"])
    err_main = 0.0
    for mode, x_dtype, out_dtype in (
            ("w8a8", None, torch.bfloat16), ("w8a8", None, torch.float32),
            ("w8a16", torch.bfloat16, torch.bfloat16),
            ("w8a16", torch.float32, torch.float32)):
        for with_bias in (False, True):
            x, w, ws, b, xs = conv2d_quant_inputs(
                200, *dims, mode, x_dtype or torch.float32, with_bias)
            what = (f"conv2d_quant patch_embed {mode} x {x.dtype} -> "
                    f"{out_dtype} bias={with_bias}")
            err = check_conv2d_quant(sq, x, w, ws, b, xs, mode=mode,
                                     stride=st, act="none",
                                     out_dtype=out_dtype, requant=True,
                                     what=what)
            if mode == "w8a8" and out_dtype == torch.bfloat16 and not with_bias:
                err_main = err  # the model path's call
            log(f"{what}: max|err| {err:.3e}, requant codes checked")
    for i, s in enumerate(FIG1 + FIG2):
        for mode in ("w8a8", "w8a16"):
            act = ACTS[i % len(ACTS)]
            x, w, ws, b, xs = conv2d_quant_inputs(
                210 + i, s["B"], s["H"], s["W"], s["Cin"], s["Cout"], s["k"],
                mode)
            what = (f"conv2d_quant fig {s['H']}x{s['W']} k={s['k']} {mode} "
                    f"bias {act}")
            err = check_conv2d_quant(sq, x, w, ws, b, xs, mode=mode,
                                     stride=(1, 1), act=act,
                                     out_dtype=torch.float32, requant=True,
                                     what=what)
            log(f"{what}: max|err| {err:.3e}, requant codes checked")
    n = 0
    # strides, every activation, Cin 37 (not a multiple of 4) and 130 (a
    # ragged second and third channel chunk), Cout 70, bias or none
    for j, (k, st, cin) in enumerate(((1, (1, 1), 37), (3, (2, 2), 130),
                                      (5, (2, 1), 37), (7, (1, 3), 130),
                                      (20, (3, 2), 37))):
        for mode, act in itertools.product(("w8a8", "w8a16"), ACTS):
            x, w, ws, b, xs = conv2d_quant_inputs(
                220 + j, 3, 41, 47, cin, 70, k, mode,
                with_bias=act in ("none", "gelu"))
            check_conv2d_quant(sq, x, w, ws, b, xs, mode=mode, stride=st,
                               act=act, out_dtype=torch.float32, requant=True,
                               what=f"conv2d_quant edge k={k} s={st} Cin={cin} "
                                    f"{mode} {act}")
            n += 1
    log(f"conv2d_quant edge shapes: {n} cases, float and requant outputs "
        "checked")
    S = ATTN_LLAVA["S"]
    lens = [0, 1, S - 32, S]
    args = attn_int8_inputs(290, **ATTN_LLAVA, q_dtype=torch.bfloat16,
                            lengths=lens)
    got = ad.decode_attention(*args)
    err = close(got, ad.attention_decode_plain(*args), TOL,
                "attention int8 llava shape")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("attention int8: a length-0 slot must give a "
                             "zero row")
    log(f"attention int8 {ATTN_LLAVA} bf16 q lengths {lens}: max|err| "
        f"{err:.3e}")
    torch.cuda.synchronize()
    return {"conv2d_quant": err_main, "attention_decode_int8_llava": err}


def conv2d_dw_inputs(seed, B, H, W, Cin, Cout, k, stride, dtype):
    """x (B, H, W, Cin) and dz (B, oh, ow, Cout)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    oh, ow = (H - k) // stride + 1, (W - k) // stride + 1
    x = torch.randn((B, H, W, Cin), generator=g, device=DEV).to(dtype)
    dz = torch.randn((B, oh, ow, Cout), generator=g, device=DEV).to(dtype)
    return x, dz


def fig_shape(name, k):
    """fig1's or fig2's input and channels with filter k."""
    s = FIG1[0] if name == "fig1" else FIG2[0]
    return dict(B=s["B"], H=s["H"], W=s["W"], Cin=s["Cin"], Cout=s["Cout"],
                k=k)


def phase_conv2d_train_kernels(s2, sb, ops) -> float:
    """29: the 2-D dw kernel, the 2-D kernel's saved pre-activation and the
    whole ``Conv2dSliding`` against their plain versions. Returns the dw
    kernel's max |err| at the patch embedding in bfloat16 (the main
    path's call)."""
    s = PATCH_MAIN
    st = (s["stride"],) * 2
    err_main = 0.0
    shapes = ([("patch_embed", s, s["stride"], dt)
               for dt in (torch.bfloat16, torch.float32)]
              + [(f"{name} k={k}", fig_shape(name, k), 1, torch.float32)
                 for name, k in (("fig1", 3), ("fig1", 9), ("fig1", 31),
                                 ("fig2", 3), ("fig2", 17))])
    for i, (name, d, stride, dtype) in enumerate(shapes):
        x, dz = conv2d_dw_inputs(230 + i, d["B"], d["H"], d["W"], d["Cin"],
                                 d["Cout"], d["k"], stride, dtype)
        args = dict(stride=(stride, stride), has_bias=True)
        got = sb.conv2d_bwd_dw(x, dz, (d["k"], d["k"]), **args)
        want = sb.conv2d_bwd_dw_plain(x, dz, (d["k"], d["k"]), **args)
        what = f"conv2d dw {name} {dtype}"
        again = sb.conv2d_bwd_dw(x, dz, (d["k"], d["k"]), **args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two calls differ")
        err = max(close(got[0], want[0], TOL, what, scaled=True),
                  close(got[1], want[1], TOL, what + " db", scaled=True))
        if i == 0:
            err_main = err
        log(f"{what}: max|err| {err:.3e} (of max |dw| "
            f"{want[0].abs().max().item():.1f})")
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for j, (k, stride, cin) in enumerate(((1, (1, 1), 37), (3, (2, 2), 5),
                                              (5, (2, 1), 37), (7, (1, 3), 70),
                                              (20, (3, 2), 37))):
            for with_bias in (True, False):
                x, dz = conv2d_dw_inputs(240 + j, 3, 41, 47, cin, 70, k, 1,
                                         dtype)
                oh = (41 - k) // stride[0] + 1
                ow = (47 - k) // stride[1] + 1
                dz = dz[:, :oh, :ow].contiguous()
                what = (f"conv2d dw edge k={k} s={stride} Cin={cin} "
                        f"bias={with_bias} {dtype}")
                got = sb.conv2d_bwd_dw(x, dz, (k, k), stride=stride,
                                       has_bias=with_bias)
                want = sb.conv2d_bwd_dw_plain(x, dz, (k, k), stride=stride,
                                              has_bias=with_bias)
                close(got[0], want[0], TOL, what, scaled=True)
                if with_bias:
                    close(got[1], want[1], TOL, what + " db", scaled=True)
                elif got[1] is not None:
                    raise AssertionError(f"{what}: db without a bias")
                n += 1
    log(f"conv2d dw edge shapes: {n} cases within tolerance")

    # row 4's saved pre-activation: y as without it, z the post-bias sum
    for i, (d, dtype, act, stride) in enumerate((
            (PATCH_MAIN, torch.bfloat16, "gelu", PATCH_MAIN["stride"]),
            (fig_shape("fig1", 3), torch.float32, "relu", 1),
            (fig_shape("fig1", 31), torch.float32, "gelu", 2),
            (dict(B=3, H=41, W=47, Cin=37, Cout=70, k=5), torch.bfloat16,
             "silu", 2))):
        x, w, b = conv2d_inputs(250 + i, d["B"], d["H"], d["W"], d["Cin"],
                                d["Cout"], d["k"], dtype)
        args = dict(stride=(stride, stride), activation=act)
        y, z = s2.conv2d_sliding(x, w, b, save_preact=True, **args)
        what = f"conv2d save_preact {d} {dtype} {act} s={stride}"
        if not torch.equal(y, s2.conv2d_sliding(x, w, b, **args)):
            raise AssertionError(f"{what}: save_preact changes y")
        zf = s2.conv2d_sliding_plain(x.float(), w.float(), b,
                                     stride=(stride, stride))
        err = (bf16_step_close(z, zf, what + " z") if dtype == torch.bfloat16
               else close(z, zf, TOL, what + " z"))
        log(f"{what}: z max|err| {err:.3e}")

    # the whole autograd Function at the grad/fig shapes, with dx
    for i, (name, k, stride, act) in enumerate(GRAD_FIG):
        d = fig_shape(name, k)
        x, w, b = conv2d_inputs(260 + i, d["B"], d["H"], d["W"], d["Cin"],
                                d["Cout"], k, torch.float32)
        oh = (d["H"] - k) // stride + 1
        g = torch.Generator(device=DEV).manual_seed(270 + i)
        ct = torch.randn((1, oh, oh, d["Cout"]), generator=g, device=DEV)

        def conv_grads():
            leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
            y = ops.conv2d(*leaves[:2], bias=leaves[2], stride=(stride, stride),
                           activation=act)
            return torch.autograd.grad((y * ct).sum(), leaves)

        zero_launches()
        got = conv_grads()
        launches = read_launches()
        with plain_kernels():
            want = conv_grads()
        if launches != only(conv2d=2, conv2d_bwd_dw=1):
            raise AssertionError(f"Conv2dSliding {name} launches {launches}")
        errs = [close(a, b_, TOL, f"Conv2dSliding {name} k={k} d{n}",
                      scaled=True)
                for n, a, b_ in zip("xwb", got, want)]
        log(f"Conv2dSliding grad/{name} k={k} s={stride} {act} f32, kernels "
            f"vs plain: dx dw db max|err| {[f'{e:.3e}' for e in errs]}")
    torch.cuda.synchronize()
    return err_main


def _serve_llava_int8(serve, models, quant, llava, transformer, cfg, params,
                      prompts, img, w_patch, cache_len, fp) -> dict:
    """26, int8: the request of phase 26 on the same weights with the patch
    embedding and the projector calibrated on the request's tiles, the
    patch weight quantized (w8a8 on the int8 conv2d kernel, dequantized in
    its epilogue) and an int8 cache; then the chained variant once: the
    patch embedding requantized onto the projector's grid, the projector
    the one dequant site."""
    B, P = prompts.shape
    gen, prefix = SERVE["gen"], cfg.num_patches
    zero_launches()
    t0 = time.perf_counter()
    calib = quant.Calibration()
    with torch.no_grad(), quant.collecting(calib):
        transformer.projector_apply(
            params["projector"],
            llava.patch_embed(w_patch, img, backend="sliding_pallas"))
    spec = calib.spec(chains=quant.CHAINS)
    pe, pr = spec["llava/patch_embed"], spec["llava/projector"]
    qw = quant.quantize_weight(w_patch, pe["x_scale"])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_launches = read_launches()
    if calib_launches != only(conv2d=1) or "out_scale" not in pe:
        raise AssertionError(f"llava int8 calibration launches "
                             f"{calib_launches}, spec {sorted(pe)}")
    model_q = models.build_model(cfg.replace(kv_quant="int8"))

    def embed():
        return llava.patch_embed(qw, img, backend="sliding_pallas",
                                 precision="w8a8").reshape(B, prefix,
                                                           llava.VISION_DIM)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    with torch.no_grad(), quant.counting_dequants() as sites:
        patches = embed()
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - t0) * 1e3
    toks, _ = serve.generate(model_q, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats, patches=patches)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = only(conv2d_quant=1,
                attention_decode_int8=cfg.num_layers * (gen - 1))
    if launches != want:
        raise AssertionError(f"llava int8 launch counts {launches}, "
                             f"expected {want}")
    if sites != ["llava/patch_embed"]:
        raise AssertionError(f"llava int8 dequant sites {sites}")
    if (tuple(patches.shape) != (B, prefix, llava.VISION_DIM)
            or patches.dtype != img.dtype or not torch.isfinite(patches).all()):
        raise AssertionError(f"llava int8 patches {tuple(patches.shape)} "
                             f"{patches.dtype}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"llava int8: bad tokens {tuple(toks.shape)}")
    nbytes = serve.cache_nbytes(model_q.cache_defs(B, cache_len),
                                cfg.param_dtype)
    if nbytes >= fp["kv_cache_bytes"]:
        raise AssertionError(f"int8 cache {nbytes} bytes, fp "
                             f"{fp['kv_cache_bytes']}")
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model_q, params, prompts,
                                            cache_len=cache_len,
                                            patches=patches)
    if cache["k"].dtype != torch.int8 or not torch.isfinite(logits).all():
        raise AssertionError("llava int8: cache not int8 or logits not finite")
    p_fp = fp.pop("patches")
    l_fp = fp.pop("logits")
    dist = dict(
        patches=((patches.float() - p_fp.float()).abs().max()
                 / p_fp.float().abs().max()).item(),
        prefill_logits=((logits.float() - l_fp.float()).abs().max()
                        / l_fp.float().abs().max()).item(),
        argmax_agreement=(logits.argmax(-1) == l_fp.argmax(-1)).float().mean().item())
    prof = {
        "patch_embed": profile_busy(embed, reps=3),
        "decode_step": profile_busy(lambda: model_q.decode_step(
            params, cache, toks[:, :1], prefix + P)),
    }
    for what, r in prof.items():
        log(f"profile llava int8 {what}: wall {r['wall_ms']:.3f} ms, card "
            f"busy {r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    del cache, logits

    # the chained variant: int8 codes into the projector, one dequant there
    qc = quant.quantize_weight(w_patch, pe["x_scale"], pe["out_scale"])
    zero_launches()
    with torch.no_grad():
        with quant.counting_dequants() as chain_sites:
            codes = llava.patch_embed(qc, img, backend="sliding_pallas",
                                      precision="w8a8")
            v_chain = transformer.projector_apply(
                params["projector"], codes, dtype=img.dtype,
                x_scale=pr["x_scale"])
        v_plain = transformer.projector_apply(
            params["projector"], patches.reshape(codes.shape),
            dtype=img.dtype)
    chain_launches = read_launches()
    if chain_sites != ["llava/projector"] or codes.dtype != torch.int8:
        raise AssertionError(f"llava chain: dequant sites {chain_sites}, "
                             f"codes {codes.dtype}")
    if chain_launches != only(conv2d_quant=1):
        raise AssertionError(f"llava chain launches {chain_launches}")
    chain_dist = ((v_chain.float() - v_plain.float()).abs().max()
                  / v_plain.float().abs().max()).item()
    step_ms = statistics.median(stats["step_s"]) * 1e3
    res = dict(tok_per_s=B * gen / wall, ttft_ms=embed_ms + stats["ttft_s"] * 1e3,
               patch_embed_ms=embed_ms, decode_step_ms=step_ms, wall_s=wall,
               peak_mem_gb=peak, calibration_s=calib_s,
               calibration_launches=calib_launches, launches=launches,
               kv_cache_bytes=nbytes, kv_cache_bytes_fp=fp["kv_cache_bytes"],
               dequant_sites=sites, chain_dequant_sites=chain_sites,
               chain_vs_unchained_projector=chain_dist, vs_fp=dist,
               busy_share={k: r["busy_share"] for k, r in prof.items()},
               busy_ms={k: r["busy_ms"] for k, r in prof.items()})
    log(f"llava full-width int8 serve (w8a8 patch embedding, int8 cache) "
        f"B={B} P={P} gen={gen}: {res['tok_per_s']:.1f} tok/s, TTFT "
        f"{res['ttft_ms']:.2f} ms (patch_embed {embed_ms:.3f} ms), decode "
        f"step {step_ms:.3f} ms (median of {len(stats['step_s'])}), peak mem "
        f"{peak:.2f} GB, kv-cache bytes {nbytes} (fp {fp['kv_cache_bytes']}, "
        f"ratio {fp['kv_cache_bytes'] / nbytes:.2f}x), calibration "
        f"{calib_s:.2f}s, launches {launches}; vs fp: {dist}; sample "
        f"{toks[0, :8].tolist()}")
    log(f"llava chained int8 patch embedding: dequant sites {chain_sites}, "
        f"projector output {chain_dist:.3e} of max from the unchained one")
    return res


def phase_smoke_serve_llava_int8(serve, models, configs, map_tree, llava,
                                 quant, transformer):
    """31: llava's smoke config with the patch embedding quantized (w8a8,
    calibrated on the CPU) and an int8 cache, one set of weights on the
    CPU and on the card: equal greedy tokens, patches and prefill logits
    within TOL; then the CLI's own line, ``--arch llava-next-34b --smoke
    --quant int8 --kv-quant int8``, on the card and on the CPU: the same
    calibration report (no conv site among the params, as the reference's
    CLI finds), cache bytes and attention keys."""
    cfg = configs.smoke_config(configs.get_config(LLAVA)).replace(
        kv_quant="int8")
    model = models.build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    img, w = (t.cpu() for t in _llava_images(141, SMOKE["B"], 56,
                                             torch.float32))
    calib = quant.Calibration()
    with torch.no_grad(), quant.collecting(calib):
        transformer.projector_apply(cpu_params["projector"],
                                    llava.patch_embed(w, img))
    qw = quant.quantize_weight(w, calib.spec()["llava/patch_embed"]["x_scale"])
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for dev, params in (("cpu", cpu_params),
                        (DEV, map_tree(lambda t: t.to(DEV), cpu_params))):
        zero_launches()
        with torch.no_grad():
            patches = llava.patch_embed(qw.to(dev), img.to(dev),
                                        backend="sliding_pallas",
                                        precision="w8a8")
            logits, _ = serve.prefill_cache(model, params, prompts.to(dev),
                                            cache_len=cache_len,
                                            patches=patches)
        toks, _ = serve.generate(model, params, prompts.to(dev),
                                 gen_len=SMOKE["gen"], cache_len=cache_len,
                                 patches=patches)
        out[dev] = (patches.cpu(), logits.cpu(), toks.cpu(), read_launches())
    want = only(conv2d_quant=1,
                attention_decode_int8=cfg.num_layers * (SMOKE["gen"] - 1))
    if out[DEV][3] != want:
        raise AssertionError(f"llava int8 smoke card launches {out[DEV][3]}, "
                             f"expected {want}")
    perr = close(out[DEV][0], out["cpu"][0], TOL, "llava int8 smoke patches")
    err = close(out[DEV][1], out["cpu"][1], TOL,
                "llava int8 smoke prefill logits")
    if not torch.equal(out[DEV][2], out["cpu"][2]):
        raise AssertionError(f"llava int8 smoke greedy tokens differ: card "
                             f"{out[DEV][2].tolist()} vs CPU "
                             f"{out['cpu'][2].tolist()}")
    log(f"llava int8 smoke serve {SMOKE}: greedy tokens equal on card and CPU "
        f"{out[DEV][2].tolist()}; patches max|err| {perr:.3e}, prefill "
        f"logits max|err| {err:.3e}; card launches {out[DEV][3]}")

    from repro_torch.kernels import ops

    lines = {}
    for dev in ("cpu", DEV):
        ops.ATTN_DECODE_DISPATCH.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", LLAVA, "--smoke", "--quant", "int8",
                        "--kv-quant", "int8", "--batch", "2", "--prompt-len",
                        "8", "--gen", "4", "--device", dev])
        text = buf.getvalue()
        lines[dev] = [ln.replace("impl=cuda", "impl=plain")
                      for ln in text.splitlines()
                      if ln.startswith(("[serve] --quant", "[serve] kv-cache",
                                        "[serve] attn-decode"))]
        if "has no conv sites; unchanged" not in text:
            raise AssertionError(f"llava int8 CLI on {dev}: {text}")
    if lines["cpu"] != lines[DEV] or len(lines[DEV]) != 3:
        raise AssertionError(f"llava int8 CLI lines differ: {lines}")
    log(f"llava int8 CLI on card and CPU: {lines[DEV]}")


def phase_patch_embed_train(llava, transformer) -> dict:
    """30: a gradient step through ``patch_embed`` on the kernels'
    ``Conv2dSliding`` into the projector at llava's full widths: x (20,
    336, 336, 3) bf16, w (14, 14, 3, 1152) and its bias, the projector
    1152 -> 7168 -> 7168, all bf16; the loss half the squared distance of
    each patch's projection to a fixed target drawn from the seed, averaged
    over the patches; a descent step in place, each leaf moved along its
    gradient by a thousandth of its own norm. One forward
    conv, one dw kernel and no dx conv a step; the first step's grads held
    to the same step on the plain versions; step ms and peak memory."""
    g = torch.Generator(device=DEV).manual_seed(280)
    img, w = _llava_images(280, PATCH_MAIN["B"], LLAVA_TILE, torch.bfloat16)
    d = PATCH_TRAIN["d"]
    leaves = {
        "w_patch": w,
        "b_patch": (0.1 * torch.randn((1152,), generator=g, device=DEV)
                    ).to(torch.bfloat16),
        "w1": (torch.randn((1152, d), generator=g, device=DEV)
               / 1152 ** 0.5).to(torch.bfloat16),
        "b1": (0.1 * torch.randn((d,), generator=g, device=DEV)
               ).to(torch.bfloat16),
        "w2": (torch.randn((d, d), generator=g, device=DEV)
               / d ** 0.5).to(torch.bfloat16),
    }
    n_patch = (LLAVA_TILE // 14) ** 2
    target = torch.randn((PATCH_MAIN["B"], n_patch, d), generator=g,
                         device=DEV).to(torch.bfloat16)

    def grads(params):
        p = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        patches = llava.patch_embed(p["w_patch"], img, backend="sliding_pallas",
                                    bias=p["b_patch"])
        out = transformer.projector_apply(
            {k: p[k] for k in ("w1", "b1", "w2")}, patches)
        loss = 0.5 * ((out.float() - target.float()) ** 2).sum(-1).mean()
        return loss, torch.autograd.grad(loss, list(p.values()))

    zero_launches()
    loss0, got = grads(leaves)
    launches = read_launches()
    if launches != only(conv2d=1, conv2d_bwd_dw=1):
        raise AssertionError(f"patch-embedding step launches {launches}")
    with plain_kernels():
        _, want = grads(leaves)
    errs = {}
    for name, a, b in zip(leaves, got, want):
        if a.dtype != torch.bfloat16 or not torch.isfinite(a.float()).all():
            raise AssertionError(f"patch-embedding grad {name}: {a.dtype}")
        # bf16 grads: tests/test_grads.py's bf16 tolerance, scaled
        errs[name] = close(a, b, BTOL, f"patch-embedding grad {name}",
                           scaled=True)
    log(f"patch-embedding step, kernels vs plain: grads max|err| "
        f"{ {k: f'{e:.3e}' for k, e in errs.items()} }, loss {loss0.item():.3f}")

    params = {k: t.clone() for k, t in leaves.items()}
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(PATCH_TRAIN["warmup"] + PATCH_TRAIN["steps"]):
        zero_launches()
        t0 = time.perf_counter()
        loss, gs = grads(params)
        with torch.no_grad():  # the gradient's scale sets no step size
            for t, gr in zip(params.values(), gs):
                rate = PATCH_TRAIN["step"] * t.float().norm() / gr.float().norm()
                t.sub_((gr.float() * rate).to(t.dtype))
        torch.cuda.synchronize()
        if step >= PATCH_TRAIN["warmup"]:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if read_launches() != only(conv2d=1, conv2d_bwd_dw=1):
            raise AssertionError(f"patch-embedding step {step} launches "
                                 f"{read_launches()}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"patch-embedding losses {losses}")
    def step_grads():  # profile_busy turns gradients off; this step needs them
        with torch.enable_grad():
            return grads(params)

    prof = profile_busy(step_grads, reps=2)
    res = dict(step_ms=statistics.median(times), peak_mem_gb=peak,
               losses=losses, launches=launches, grad_max_abs_err=errs,
               busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
               top=prof["top"])
    log(f"patch-embedding train step (x {tuple(img.shape)} bf16, projector "
        f"1152->{d}->{d}): {res['step_ms']:.3f} ms (median of {len(times)}), "
        f"peak mem {peak:.2f} GB, losses {[round(v, 3) for v in losses]}, "
        f"busy {100 * prof['busy_share']:.1f}%, launches a step {launches}; "
        f"top: {prof['top']}")
    return res


def phase_llava_train_cli(train) -> dict:
    """41: the port's train CLI for llava at the smoke config on the card,
    as the reference's own command runs it (2 steps, batch 2, seq 32, the
    per-step patches of ``build_batch_extras``): finite losses."""
    run_dir = ROOT / "build" / "chip_smoke_llava_train"
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = train.main(["--arch", LLAVA, "--smoke", "--steps", "2",
                          "--batch", "2", "--grad-accum", "1", "--seq", "32",
                          "--log-every", "1", "--run-dir", str(run_dir)])
    shutil.rmtree(run_dir, ignore_errors=True)
    losses = res["losses"]
    if len(losses) != 2 or not all(np.isfinite(losses)):
        raise AssertionError(f"llava train CLI losses {losses}:\n"
                             f"{out.getvalue()}")
    log(f"llava train CLI on the card (--smoke, 2 steps): losses "
        f"{[round(v, 4) for v in losses]} in "
        f"{time.perf_counter() - t0:.1f}s")
    return dict(losses=losses)


def reset_obs(obs, health, ops) -> None:
    """Tracing off, and an empty obs registry, trace ring, health record and
    attention log: the process-global state a CLI phase records into."""
    obs.enable(False)
    ops.ATTN_DECODE_DISPATCH.clear()
    obs.REGISTRY.reset()
    obs.trace.clear()
    health.HEALTH.reset()


def obs_report(run_dir) -> str:
    """``python -m repro_torch.obs report run_dir``'s output (a process of
    its own, off the card)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", str(run_dir)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode:
        raise AssertionError(f"obs report failed:\n{proc.stderr}")
    return proc.stdout


def ci_obs_checks(run_dir) -> None:
    """CI's checks of a traced serve run's artifacts (the traced serve
    smoke of .github/workflows/ci.yml)."""
    snap = json.load(open(run_dir / "metrics.json"))
    assert snap["schema"] == 1, snap["schema"]
    hists = snap["histograms"]
    assert hists.get("serve.ttft_s"), "no TTFT histogram"
    steps = hists.get("serve.decode_step_s")
    assert steps and steps[0]["count"] > 0, "no decode-step histogram"
    kv = snap["gauges"].get("serve.kv_cache_bytes", [])
    kinds = {g["labels"].get("kind") for g in kv}
    assert {"served", "fp"} <= kinds, f"kv gauge kinds: {kinds}"
    disp = snap["counters"].get("dispatch.seconds_total", [])
    keys = {c["labels"].get("key", "") for c in disp}
    assert any(k.startswith("attn_dec|") for k in keys), (
        "no per-autotune-key dispatch wall time: %s" % sorted(keys))
    evs = json.load(open(run_dir / "trace.json"))["traceEvents"]
    assert evs, "empty trace"
    assert all("ph" in e and "ts" in e and "name" in e for e in evs)
    assert any(e["name"] == "serve.decode_step" for e in evs)


def phase_serve_cli_obs(serve, configs, obs, health, ops, smi) -> dict:
    """42: the traced serve CLI at full width (whisper-medium, every
    published width, random weights from seed 0), two requests under
    ``--run-dir`` and ``--trace``, launches counted from zero; then the
    same command disarmed before and after it, for the decode step's p50
    armed and disarmed in one process at one shape."""
    argv = ["--arch", "whisper-medium", "--batch", str(SERVE["B"]),
            "--prompt-len", str(SERVE["P"]), "--gen", str(SERVE["gen"]),
            "--kv-quant", "int8", "--conv-backend", "sliding_pallas",
            "--requests", "2"]
    real_generate = serve.generate

    def run(run_dir, *extra):
        """One CLI run on a fresh registry; its printed lines and the
        ``stats`` decode steps of its requests."""
        shutil.rmtree(run_dir, ignore_errors=True)
        reset_obs(obs, health, ops)
        steps = []

        def generate(*a, **kw):  # the CLI's requests, their stats kept
            stats = {}
            out = real_generate(*a, stats=stats, **kw)
            steps.extend(stats["step_s"])
            return out

        serve.generate = generate
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                serve.main([*argv, "--run-dir", str(run_dir), *extra])
        finally:
            serve.generate = real_generate
        gc.collect()
        torch.cuda.empty_cache()
        hist = obs.REGISTRY.histogram("serve.decode_step_s")
        return out.getvalue(), dict(
            p50_ms=statistics.median(steps) * 1e3,
            hist_p50_ms=hist.quantile(0.5, arch="whisper-medium") * 1e3,
            steps=len(steps))

    base = ROOT / "build" / "chip_smoke_obs"
    t0 = time.perf_counter()
    _, before = run(base.with_name("chip_smoke_obs_off"))
    zero_launches()
    text, armed = run(base, "--trace")
    launches = read_launches()
    try:
        ci_obs_checks(base)
        report = obs_report(base)
        for needle in ("generated", "attn-decode:", "kv-cache bytes:",
                       "decode-step"):
            assert needle in report, f"report missing {needle!r}:\n{report}"
        recs = serve.RequestJournal(base).records()
        begun = [r["id"] for r in recs if r["event"] == "begin"]
        ends = [r for r in recs if r["event"] == "end"]
        assert begun == [r["id"] for r in ends] == ["req0", "req1"], recs
        assert ends[0]["tokens"] == ends[1]["tokens"]  # greedy: bit-identical
        samples = dict(re.findall(r"^\[serve\] sample\[(\w+)\]: (.*)$", text,
                                  re.MULTILINE))
        assert samples.keys() == {"req0", "req1"}, text
        assert samples["req0"] == samples["req1"], samples
        # two requests: two frontend convs each, and self- and
        # cross-attention in every decoder layer at every decode step
        layers = configs.get_config("whisper-medium").num_layers
        want = only(sliding_conv1d=2 * 2, attention_decode_int8=2 * 2 * layers
                    * (SERVE["gen"] - 1))
        assert launches == want, f"launch counts {launches}, expected {want}"
        calls = {(lb["site"], lb["rung"]): 0 for lb, _ in
                 obs.REGISTRY.counter("dispatch.calls").series()}
        for lb, v in obs.REGISTRY.counter("dispatch.calls").series():
            calls[lb["site"], lb["rung"]] += int(v)
        assert calls == {("conv1d", "cuda"): want["sliding_conv1d"],
                         ("attention_decode", "cuda"):
                         want["attention_decode_int8"]}, calls
        snap = json.load(open(base / "metrics.json"))
        dispatch_s = sum(c["value"] for c in
                         snap["counters"]["dispatch.seconds_total"])
        spans = sum(1 for e in json.load(open(base / "trace.json"))[
            "traceEvents"] if e["name"] == "kernel.dispatch")
    finally:
        reset_obs(obs, health, ops)
    _, after = run(base.with_name("chip_smoke_obs_off"))
    reset_obs(obs, health, ops)
    shutil.rmtree(base.with_name("chip_smoke_obs_off"), ignore_errors=True)
    for line in report.splitlines():
        log(f"obs report: {line}")
    log(f"serve CLI traced (whisper-medium full width, B {SERVE['B']}, P "
        f"{SERVE['P']}, {SERVE['gen']} tokens, 2 requests, int8 cache): "
        f"decode step p50 {armed['p50_ms']:.3f} ms armed vs "
        f"{before['p50_ms']:.3f} / {after['p50_ms']:.3f} ms disarmed before "
        f"/ after (histogram p50 {armed['hist_p50_ms']:.3f} vs "
        f"{before['hist_p50_ms']:.3f} / {after['hist_p50_ms']:.3f}), "
        f"{armed['steps']} steps each; {spans} kernel.dispatch spans, "
        f"dispatch host time {dispatch_s * 1e3:.1f} ms; launches row 1 "
        f"{launches['sliding_conv1d']}, row 2b "
        f"{launches['attention_decode_int8']}; {smi}; "
        f"{time.perf_counter() - t0:.1f}s")
    return dict(launches=launches, armed=armed, disarmed_before=before,
                disarmed_after=after, kernel_dispatch_spans=spans,
                dispatch_seconds_total=dispatch_s, device=smi)


def phase_train_cli_obs(train, obs, health, ops, smi) -> dict:
    """43: the traced train CLI on whisper's smoke config, 3 steps through
    the conv kernels (rows 1 and 10), launches counted from zero: three
    ``train.step`` spans, ``train.step_s`` count 3, a finite loss, the
    report's train lines."""
    run_dir = ROOT / "build" / "chip_smoke_train_obs"
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_obs(obs, health, ops)
    zero_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = train.main(["--arch", "whisper-medium", "--smoke",
                              "--steps", "3", "--batch", "2", "--seq", "64",
                              "--audio-frontend", "mels", "--conv-backend",
                              "sliding_pallas", "--trace", "--log-every",
                              "1", "--run-dir", str(run_dir)])
        launches = read_launches()
        assert launches["sliding_conv1d"] > 0 and launches["conv1d_bwd_dw"] > 0, (
            launches)
        evs = json.load(open(run_dir / "trace.json"))["traceEvents"]
        step_ms = [e["dur"] / 1e3 for e in evs if e["name"] == "train.step"]
        assert len(step_ms) == 3, out.getvalue()
        snap = json.load(open(run_dir / "metrics.json"))
        assert snap["histograms"]["train.step_s"][0]["count"] == 3
        loss = snap["gauges"]["train.loss"][0]["value"]
        assert np.isfinite(loss) and loss == res["losses"][-1], (loss, res)
        conv = {lb["rung"]: int(v) for lb, v in obs.REGISTRY.counter(
            "dispatch.calls").series() if lb["site"] == "conv1d"}
        assert conv.keys() == {"cuda"}, conv
        report = obs_report(run_dir)
        for needle in ("[train] steps=3 tokens=384", "[train] step: p50="):
            assert needle in report, f"report missing {needle!r}:\n{report}"
    finally:
        reset_obs(obs, health, ops)
        shutil.rmtree(run_dir, ignore_errors=True)
    for line in report.splitlines():
        log(f"obs report: {line}")
    log(f"train CLI traced (whisper-medium --smoke, 3 steps, B 2, seq 64): "
        f"steps {[round(t, 3) for t in step_ms]} ms, "
        f"losses {[round(v, 4) for v in res['losses']]}; conv1d dispatches "
        f"{conv['cuda']}; launches row 1 {launches['sliding_conv1d']}, row 10 "
        f"{launches['conv1d_bwd_dw']}; {smi}; "
        f"{time.perf_counter() - t0:.1f}s")
    return dict(launches=launches, step_ms=step_ms, losses=res["losses"],
                device=smi)


CHAOS = dict(B=2, P=16, gen=8)  # CI's chaos request, at full width
CHAOS_TRAIN = dict(B=2, seq=64, steps=3)
# each step's loss of the drilled run against the clean run's: step 0 was
# retried on the plain rung (bf16 activations through another conv
# evaluation), and steps 1 and 2 start from its update
CHAOS_LOSS_REL = 1e-2


class _NoCheckpoints:
    """A checkpoint manager that keeps nothing: phase 51's train drill
    saves no 7.7-GB full-width step (the drill is the step loop's)."""

    def __init__(self, *a, **k):
        pass

    def latest_valid_step(self):
        return None

    def save(self, *a, **k):
        pass

    def wait(self):
        pass


def _chaos_env(faults, spec: str | None, cooldown: str | None) -> None:
    """Arm ``REPRO_FAULTS`` (None: disarm) and the breakers' call cooldown
    (None: the default) for an in-process CLI run."""
    for name, value in (("REPRO_FAULTS", spec),
                        ("REPRO_HEALTH_COOLDOWN_CALLS", cooldown)):
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    faults.reload_env()


@contextlib.contextmanager
def recorded_calls(ops, names):
    """The ``ops`` entry points ``names`` pass each call through and keep
    its operands (tensors detached and cloned) in the yielded dict: the
    last call of each signature (name, shapes, dtypes, options)."""
    real = {n: getattr(ops, n) for n in names}
    got = {}

    def sig(v):
        return ((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                else repr(v))

    def keep(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v

    def wrapped(name):
        def call(*a, **kw):
            k = (name, tuple(map(sig, a)),
                 tuple((n, sig(v)) for n, v in sorted(kw.items())))
            got[k] = (name, [keep(v) for v in a],
                      {n: keep(v) for n, v in kw.items()})
            return real[name](*a, **kw)
        return call

    for n in names:
        setattr(ops, n, wrapped(n))
    try:
        yield got
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


# the launch counter of each entry point the drills record
_DRILL_ROW = {"conv1d": "sliding_conv1d", "attention_decode": "attention_decode"}


def _drill_tol(t: torch.Tensor) -> dict:
    """A float32 output at TOL (the kernels sum in another order than the
    plain versions: a conv2 of 3,072 products a sum, row 2 over the path's
    own activations); a bfloat16 one, which may round the other way, at
    QBTOL."""
    return TOL if t.dtype == torch.float32 else QBTOL


def drill_calls_vs_plain(ops, calls, *, grads: bool) -> dict:
    """Each call recorded on a drill's path, again on the card through the
    kernels and through their plain versions (``plain_kernels()``), on the
    same operands; returns max |err| by call. ``grads``: each conv1d also
    takes a seeded cotangent, and its dx, dw and db (rows 1 and 10) are
    held too, scaled as gradients. Raises unless each kernel launched."""
    errs = {}
    for i, (name, a, kw) in enumerate(calls.values()):
        fn = getattr(ops, name)
        what = (f"chaos drill {name} "
                f"{[tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]}"
                f" {a[0].dtype}")

        def run():
            if not grads:
                with torch.no_grad():
                    return (fn(*a, **kw),)
            x, w = (t.detach().requires_grad_(True) for t in a[:2])
            b = kw.get("bias")
            b = None if b is None else b.detach().requires_grad_(True)
            y = fn(x, w, *a[2:], **dict(kw, bias=b))
            g = torch.Generator(device=DEV).manual_seed(51 + i)
            ct = torch.randn(y.shape, generator=g, device=DEV).to(y.dtype)
            leaves = (x, w) if b is None else (x, w, b)
            return (y.detach(),
                    *torch.autograd.grad((y.float() * ct.float()).sum(),
                                         leaves))

        zero_launches()
        got = run()
        launched = read_launches()
        with plain_kernels():
            want = run()
        # with grads, row 1 runs the forward and dx, row 10 dw and db
        expect = (only(sliding_conv1d=2, conv1d_bwd_dw=1) if grads
                  else only(**{_DRILL_ROW[name]: 1}))
        if launched != expect:
            raise AssertionError(f"{what}: launches {launched}")
        err = 0.0
        for j, (gt, wt) in enumerate(zip(got, want)):
            err = max(err, close(gt, wt, _drill_tol(wt), f"{what} out {j}",
                                 scaled=j > 0))
        errs[what] = err
    return errs


def phase_chaos(serve, train, steps_mod, configs, faults, obs, health, ops,
                smi) -> dict:
    """51: CI's two chaos steps on the serve CLI at whisper-medium's full
    width (B 2, P 16, 8 tokens, ``--conv-backend sliding_pallas``), the
    train CLI's runtime drill, and a real kernel error; in process, with
    the obs registry, health record, faults and dispatch metrics reset
    around each run. (a) clean, two requests: no ``health:`` line, row 1
    only. (b) ``pallas_compile:conv1d``: a ``demote:cuda->plain`` line, no
    row-1 launch, every conv1d on ``plain``. (c)
    ``pallas_runtime:conv1d*1,nan_activations:serve/slot.1*1`` with a
    4-call cooldown, two requests under ``--run-dir``: the runtime
    demotion, the probe and the repromotion, slot 1 quarantined, CI's
    metrics and journal checks, row 1's exact count, request 1's slot 0
    bit for bit as (b) and request 2 as (a). (d) ``train.main`` at full
    width, 3 steps, clean and under ``pallas_runtime:conv1d*1`` (checkpoints
    not written): step 0 demoted and retried, each step's loss within
    ``CHAOS_LOSS_REL`` of the clean one, three optimizer steps, a
    repromotion. The conv1d and attention_decode calls of (a) and the
    conv1d calls of (d)'s clean run are recorded and replayed on the
    kernels and on their plain versions (``drill_calls_vs_plain``; (d)'s
    with dx, dw and db). (e) a row-1 wrapper that raises ``RuntimeError``:
    ``ops.conv1d`` on the card raises it, disarmed and armed, with no
    health event. (f) under ``REPRO_RUNTIME_SENTINEL=1`` a row-1 wrapper
    whose first output is NaN: the serve CLI's request fails with the
    sentinel's ``FaultError`` after one prefill, one
    ``error:cuda(sentinel)`` event, no breaker."""
    t0 = time.perf_counter()
    argv = ["--arch", "whisper-medium", "--batch", str(CHAOS["B"]),
            "--prompt-len", str(CHAOS["P"]), "--gen", str(CHAOS["gen"]),
            "--conv-backend", "sliding_pallas"]
    real_generate = serve.generate
    run_dir = ROOT / "build" / "chip_smoke_chaos"

    def reset():
        reset_obs(obs, health, ops)
        faults.reset()

    def run(*extra, spec=None, cooldown=None, record=None):
        """One serve CLI run: its stdout, each request's tokens, the
        dispatch calls by (site, rung) and the launch counts. ``record``:
        a dict that receives the run's conv1d and attention_decode calls
        (``recorded_calls``)."""
        reset()
        _chaos_env(faults, spec, cooldown)
        obs.metrics.enable_dispatch()
        toks = {}

        def generate(*a, **kw):
            out = real_generate(*a, **kw)
            toks[kw["request_id"]] = out[0].cpu()
            return out

        serve.generate = generate
        rec = (recorded_calls(ops, ("conv1d", "attention_decode"))
               if record is not None else contextlib.nullcontext({}))
        zero_launches()
        try:
            with rec as calls, \
                    contextlib.redirect_stdout(io.StringIO()) as out:
                serve.main([*argv, *extra])
            launches = read_launches()
            if record is not None:
                record.update(calls)
        finally:
            serve.generate = real_generate
            obs.metrics.enable_dispatch(False)
            _chaos_env(faults, None, None)
        calls = {}
        for lb, v in obs.REGISTRY.counter("dispatch.calls").series():
            k = (lb["site"], lb["rung"])
            calls[k] = calls.get(k, 0) + int(v)
        gc.collect()
        torch.cuda.empty_cache()
        return out.getvalue(), toks, calls, launches

    cfg = configs.get_config("whisper-medium")
    # a request's row-2 launches: self- and cross-attention in every decoder
    # layer at every decode step
    attn = 2 * cfg.num_layers * (CHAOS["gen"] - 1)
    serve_calls = {}
    try:
        # (a) clean
        clean, a_toks, a_calls, a_launch = run("--requests", "2",
                                               record=serve_calls)
        assert "generated" in clean, clean
        assert not any("health:" in ln for ln in clean.splitlines()), clean
        assert a_launch == only(sliding_conv1d=4, attention_decode=2 * attn), (
            a_launch)
        assert a_calls == {("conv1d", "cuda"): 4,
                           ("attention_decode", "cuda"): 2 * attn}, a_calls
        assert torch.equal(a_toks["req0"], a_toks["req1"])
        # (b) compile drill
        comp, b_toks, b_calls, b_launch = run(spec="pallas_compile:conv1d")
        lines = comp.splitlines()
        assert "generated" in comp, comp
        assert any("health:" in ln and "pallas_compile" in ln
                   and "demote:cuda->plain" in ln for ln in lines), comp
        assert b_launch == only(attention_decode=attn), b_launch
        assert b_calls == {("conv1d", "plain"): 2,
                           ("attention_decode", "cuda"): attn}, b_calls
        # (c) runtime drill
        shutil.rmtree(run_dir, ignore_errors=True)
        rt, c_toks, c_calls, c_launch = run(
            "--requests", "2", "--run-dir", str(run_dir),
            spec="pallas_runtime:conv1d*1,nan_activations:serve/slot.1*1",
            cooldown="4")
        cl = rt.splitlines()
        assert "generated" in rt, rt
        for needle in ("demote:cuda(runtime)", "probe:cuda",
                       "repromote:cuda"):
            assert any("health:" in ln and needle in ln for ln in cl), (
                needle, rt)
        assert any("health:" in ln and "pallas_runtime" in ln
                   and "demote:cuda(runtime)" in ln for ln in cl), rt
        assert any("action=quarantine" in ln and "serve/slot" in ln
                   for ln in cl), rt
        assert "load_shed" not in rt
        names = json.dumps(json.load(open(run_dir / "metrics.json")))
        for key in ("runtime.demote", "runtime.retrace_ms",
                    "health.repromote", "serve.quarantined"):
            assert key in names, f"{key} missing from metrics.json"
        assert "serve.shed" not in names
        recs = serve.RequestJournal(run_dir).records()
        begun = {r["id"] for r in recs if r["event"] == "begin"}
        ended = {r["id"] for r in recs if r["event"] == "end"}
        assert begun == ended == {"req0", "req1"}, recs
        # request 1: its first prefill launched both convs and tripped at
        # the first; the re-run served both on plain; request 2 probed and
        # repromoted the kernel: 2 + 0 + 2 launches
        assert c_launch == only(sliding_conv1d=4, attention_decode=2 * attn), (
            c_launch)
        assert c_calls == {("conv1d", "cuda"): 4, ("conv1d", "plain"): 2,
                           ("attention_decode", "cuda"): 2 * attn}, c_calls
        eos = torch.full_like(c_toks["req0"][1], cfg.eos_id)
        assert torch.equal(c_toks["req0"][0], b_toks["req0"][0])
        assert torch.equal(c_toks["req0"][1], eos)  # slot 1 quarantined
        assert torch.equal(c_toks["req1"], a_toks["req0"])
        serve_launches = {k: a_launch[k] + b_launch[k] + c_launch[k]
                          for k in a_launch}
    finally:
        reset()
        shutil.rmtree(run_dir, ignore_errors=True)
    # the kernels at (a)'s shapes against their plain versions
    assert sorted(c[0] for c in serve_calls.values()).count("conv1d") == 2
    drill_errs = drill_calls_vs_plain(ops, serve_calls, grads=False)

    # (d) the train drill
    tdir = ROOT / "build" / "chip_smoke_chaos_train"
    targv = ["--arch", "whisper-medium", "--steps", str(CHAOS_TRAIN["steps"]),
             "--batch", str(CHAOS_TRAIN["B"]), "--seq", str(CHAOS_TRAIN["seq"]),
             "--audio-frontend", "mels", "--conv-backend", "sliding_pallas",
             "--no-resume", "--ckpt-every", "0", "--log-every", "1",
             "--run-dir", str(tdir)]
    real_apply, real_mgr = steps_mod.apply_updates, train.CheckpointManager
    counts = []

    def counting(params, grads, opt, cfg):
        out = real_apply(params, grads, opt, cfg)
        counts.append(int(out[1]["count"]))
        return out

    steps_mod.apply_updates, train.CheckpointManager = counting, _NoCheckpoints
    try:
        reset()
        zero_launches()
        with recorded_calls(ops, ("conv1d",)) as train_calls, \
                contextlib.redirect_stdout(io.StringIO()):
            tclean = train.main(targv)
        d_launch = read_launches()
        gc.collect()
        torch.cuda.empty_cache()
        clean_counts, counts[:] = list(counts), []
        reset()
        _chaos_env(faults, "pallas_runtime:conv1d*1", "2")
        zero_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            tchaos = train.main(targv)
        d_launch = {k: d_launch[k] + n for k, n in read_launches().items()}
        tlog = out.getvalue()
        acts = [e.action for e in health.HEALTH.events_for("conv1d")]
        retrace = obs.REGISTRY.counter("runtime.retrace_ms").value(
            arch="whisper-medium")
        repromoted = obs.REGISTRY.counter("health.repromote").value(
            site="conv1d", rung="cuda")
    finally:
        steps_mod.apply_updates, train.CheckpointManager = real_apply, real_mgr
        _chaos_env(faults, None, None)
        reset()
        shutil.rmtree(tdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    assert acts == ["demote:cuda(runtime)", "probe:cuda", "repromote:cuda"], (
        acts, tlog)
    assert counts == clean_counts == [1, 2, 3], (counts, clean_counts)
    assert retrace > 0 and repromoted == 1.0, (retrace, repromoted)
    assert np.isfinite(tchaos["losses"]).all(), tchaos
    loss_rel = [abs(c - k) / abs(k)
                for c, k in zip(tchaos["losses"], tclean["losses"])]
    assert len(loss_rel) == CHAOS_TRAIN["steps"], (tchaos, tclean)
    assert max(loss_rel) <= CHAOS_LOSS_REL, (tchaos["losses"],
                                             tclean["losses"])
    assert d_launch["sliding_conv1d"] > 0 and d_launch["conv1d_bwd_dw"] > 0
    # rows 1 and 10 at (d)'s shapes against their plain versions
    assert len(train_calls) == 2, list(train_calls)
    drill_errs.update(drill_calls_vs_plain(ops, train_calls, grads=True))

    # (e) a real kernel error is not hidden
    conv = ops.sliding_conv1d
    real_kernel = conv.conv1d_sliding
    exc = RuntimeError("CUDA error: an illegal memory access was encountered")

    def broken(*a, **k):
        raise exc

    g = torch.Generator(device="cpu").manual_seed(51)
    x = torch.randn(1, 64, 80, generator=g).to(DEV)
    w = torch.randn(3, 80, 64, generator=g).to(DEV)
    raised = []
    reset()
    conv.conv1d_sliding = broken
    try:
        for armed in (False, True):
            ctx = (faults.inject("slow_step", site="elsewhere") if armed
                   else contextlib.nullcontext())
            with ctx:
                try:
                    ops.conv1d(x, w)
                except RuntimeError as e:
                    raised.append(e is exc)
    finally:
        conv.conv1d_sliding = real_kernel
        events = list(health.HEALTH.events)
        reset()
    assert raised == [True, True], raised
    assert events == [], events

    # (f) a kernel's own non-finite output under the sentinel fails the
    # request: no demotion, no re-run
    nan_calls = []

    def nan_once(*a, **k):
        out = real_kernel(*a, **k)
        nan_calls.append(1)
        if len(nan_calls) > 1:
            return out
        if isinstance(out, tuple):
            return tuple(torch.full_like(t, float("nan")) for t in out)
        return torch.full_like(out, float("nan"))

    sentinel_err = None
    conv.conv1d_sliding = nan_once
    os.environ[faults.SENTINEL_ENV] = "1"
    try:
        run()
    except faults.FaultError as e:
        sentinel_err = e
    finally:
        conv.conv1d_sliding = real_kernel
        os.environ.pop(faults.SENTINEL_ENV)
        sentinel_events = [(e.site, e.reason, e.action)
                           for e in health.HEALTH.events]
        sentinel_breakers = health.HEALTH.has_breakers
        reset()
        gc.collect()
        torch.cuda.empty_cache()
    assert sentinel_err is not None and "(sentinel)" in str(sentinel_err), (
        sentinel_err)
    assert sentinel_events == [("conv1d", "nan_activations",
                                "error:cuda(sentinel)")], sentinel_events
    assert not sentinel_breakers
    assert len(nan_calls) == 2, nan_calls  # one prefill's convs

    launches = {k: serve_launches[k] + d_launch[k] for k in serve_launches}
    s = time.perf_counter() - t0
    log(f"chaos (whisper-medium full width, B {CHAOS['B']}, P {CHAOS['P']}, "
        f"{CHAOS['gen']} tokens): clean, compile drill (conv1d on plain, "
        f"row 1 launched {b_launch['sliding_conv1d']} times), runtime drill "
        f"(row 1 launched {c_launch['sliding_conv1d']} times, demote, probe, "
        f"repromote, slot 1 quarantined, request 1 slot 0 = compile drill, "
        f"request 2 = clean); train drill losses "
        f"{[round(v, 4) for v in tchaos['losses']]} vs clean "
        f"{[round(v, 4) for v in tclean['losses']]} (rel "
        f"{[f'{r:.2e}' for r in loss_rel]}), optimizer counts {counts}; "
        f"the drills' kernels vs plain max |err| "
        f"{ {k: f'{e:.3e}' for k, e in drill_errs.items()} }; a raised "
        f"RuntimeError propagated with no event; a sentinel trip failed "
        f"the request with no demotion; {smi}; {s:.1f}s")
    return dict(launches=launches, seconds=s, train_losses=tchaos["losses"],
                clean_train_losses=tclean["losses"], loss_rel=loss_rel,
                drill_max_abs_err=drill_errs, retrace_ms=retrace, device=smi)


def unfolded(x, k, stride, kpad):
    """x (B, H, W, Cin) -> (B*oh*ow, kpad): each position's k*k*Cin
    values in (i, j, c) order, zero-padded to kpad."""
    cols = x.unfold(1, k, stride).unfold(2, k, stride)  # B oh ow C i j
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * x.shape[3])
    return F.pad(cols, (0, kpad - cols.shape[1]))


def conv2d_quant_times(sq, name, s, mode, out, act, with_bias, seed,
                       n_sets) -> dict:
    """Row 14 at shape ``s`` (``mode``; w8a16 on bf16 x; output ``out``:
    "bf16", "f32" or "int8", requantized) beside its plain version,
    ``torch._int_mm`` on the input unfolded ahead (K padded to a multiple
    of 8) plus the epilogue in torch (w8a16: ``F.conv2d`` on the widened
    codes, cuDNN, TF32 off), and the bound; ``n_sets`` input sets cycled."""
    k, st = s["k"], (s["stride"],) * 2
    oh = (s["H"] - k) // s["stride"] + 1
    ow = (s["W"] - k) // s["stride"] + 1
    K = k * k * s["Cin"]
    kpad = (K + 7) // 8 * 8
    sets, lib_sets = [], []
    for i in range(n_sets):
        x, w, ws, b, xs = conv2d_quant_inputs(
            seed + i, s["B"], s["H"], s["W"], s["Cin"], s["Cout"], k,
            mode, torch.bfloat16, with_bias)
        sets.append((x, w, ws, b, xs))
    os = torch.tensor(0.05, device=DEV) if out == "int8" else None
    odt = torch.bfloat16 if out == "bf16" else torch.float32
    for x, w, ws, b, xs in sets[:2]:  # each > 50 MB, or unfolded ahead
        if mode == "w8a8":
            lib_sets.append((unfolded(x, k, s["stride"], kpad),
                             F.pad(w.reshape(K, -1), (0, 0, 0, kpad - K)),
                             ws * xs, b))
        else:
            lib_sets.append((x.permute(0, 3, 1, 2),
                             w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
                                 memory_format=torch.channels_last),
                             ws, b))

    def kernel(x, w, ws, b, xs):
        return sq.conv2d_quant(x, w, ws, b, x_scale=xs, out_scale=os,
                               mode=mode, stride=st, activation=act,
                               out_dtype=odt)

    def plain(x, w, ws, b, xs):
        return sq.conv2d_quant_plain(x, w, ws, b, x_scale=xs,
                                     out_scale=os, mode=mode, stride=st,
                                     activation=act, out_dtype=odt)

    def library(a, w2, s_row, b):
        if mode == "w8a8":
            y = torch._int_mm(a, w2).float().reshape(
                s["B"], oh, ow, -1) * s_row
        else:
            y = F.conv2d(a, w2, stride=st).permute(0, 2, 3, 1).float() * s_row
        if b is not None:
            y = y + b
        if act == "gelu":
            y = F.gelu(y, approximate="tanh")
        if os is not None:
            return torch.clamp(torch.round(y / os), -127, 127).to(torch.int8)
        return y.to(odt)

    want = plain(*sets[0])
    lib = library(*lib_sets[0])
    if os is not None:
        if (lib.int() - want.int()).abs().max().item() > 1:
            raise AssertionError(f"library conv2d_quant {name}")
    else:  # cuDNN rounds the w8a16 sum to bf16 before the scale
        close(lib, want, LIBTOL if mode == "w8a16" else
              QBTOL if odt == torch.bfloat16 else TIGHT,
              f"library conv2d_quant {name}", scaled=True)
    x, w = sets[0][:2]
    out_bytes = {"int8": 1, "bf16": 2, "f32": 4}[out]
    nbytes = (x.numel() * x.element_size() + w.numel() + 4 * s["Cout"]
              + (4 * s["Cout"] if with_bias else 0)
              + out_bytes * s["B"] * oh * ow * s["Cout"])
    ops = 2 * s["B"] * oh * ow * s["Cout"] * K
    bms, by = bound_ms(nbytes, ops,
                       torch.int8 if mode == "w8a8" else torch.bfloat16)
    t = dict(timings(cycling(kernel, sets), cycling(plain, sets),
                     cycling(library, lib_sets), HALF_BATCHES["p32"]),
             bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time conv2d_quant {name} {s} {mode} -> {out} {act} "
        f"bias={with_bias}: {json.dumps(t)}")
    return t


def phase_conv2d_quant_train_times(sq, sb, ad, launches, errs) -> list[dict]:
    """32: the int8 conv2d kernel at the patch embedding (the model path's
    w8a8 call with a bf16 output, the chained one with an int8 output, and
    w8a16) and at fig1 and fig2 (w8a8, f32 out, bias + gelu) beside its
    plain version, ``torch._int_mm`` on the input unfolded ahead (K padded
    to a multiple of 8) plus the epilogue in torch (w8a16: ``F.conv2d`` on
    the widened weights, cuDNN, TF32 off), and the bound; the 2-D dw kernel
    at the patch embedding (bf16, the main path's call, and f32) and at
    fig1 and fig2 (f32) beside its plain version,
    ``torch.nn.grad.conv2d_weight`` (cuDNN, TF32 off) plus the bias sum,
    and the bound; the int8 attention kernel at llava's decode shape.
    Returns the two kernel rows; the attention times go to row 2b."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")

    q_main = conv2d_quant_times(sq, "patch_embed", PATCH_MAIN, "w8a8",
                                "bf16", "none", False, 300, 4)
    q_shapes = {
        "patch_embed_chained": conv2d_quant_times(
            sq, "patch_embed chained", PATCH_MAIN, "w8a8", "int8", "none",
            False, 310, 4),
        "patch_embed_w8a16": conv2d_quant_times(
            sq, "patch_embed w8a16", PATCH_MAIN, "w8a16", "bf16", "none",
            False, 320, 3),
    }
    for i, (fig, s) in enumerate((("fig1", FIG1[0]), ("fig1", FIG1[-1]),
                                  ("fig2", FIG2[0]), ("fig2", FIG2[1]))):
        name = f"{fig}_k{s['k']}"
        # 0.5 MB inputs: 100 sets exceed the L2
        q_shapes[name] = conv2d_quant_times(sq, name, s, "w8a8", "f32",
                                            "gelu", True, 330 + 100 * i, 100)

    def dw_times(name, s, dtype, seed, n_sets):
        k, stride = s["k"], s["stride"]
        sets = []
        for i in range(n_sets):
            x, dz = conv2d_dw_inputs(seed + i, s["B"], s["H"], s["W"],
                                     s["Cin"], s["Cout"], k, stride, dtype)
            sets.append((x, dz, x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)))
        args = dict(stride=(stride, stride), has_bias=True)

        def library(x, dz, x_lib, dz_lib):
            dw = torch.nn.grad.conv2d_weight(
                x_lib, (s["Cout"], s["Cin"], k, k), dz_lib, stride=stride)
            return dw.permute(2, 3, 1, 0), dz.sum(dim=(0, 1, 2))

        x, dz = sets[0][:2]
        want = sb.conv2d_bwd_dw_plain(x, dz, (k, k), **args)
        lib = library(*sets[0])
        for a, b in zip(lib, want):
            close(a, b, LIBTOL if dtype == torch.bfloat16 else TOL,
                  f"library conv2d dw {name} {dtype}", scaled=True)
        el = x.element_size()
        nbytes = el * (x.numel() + dz.numel()) + 4 * (k * k * s["Cin"]
                                                      * s["Cout"] + s["Cout"])
        ops = 2 * dz.numel() * k * k * s["Cin"]
        bms, by = bound_ms(nbytes, ops, dtype)
        t = dict(timings(
            cycling(lambda x, dz, *_: sb.conv2d_bwd_dw(x, dz, (k, k), **args),
                    sets),
            cycling(lambda x, dz, *_: sb.conv2d_bwd_dw_plain(x, dz, (k, k),
                                                             **args), sets),
            cycling(library, sets), HALF_BATCHES["p32"]),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        log(f"time conv2d dw {name} {s} {dtype}: {json.dumps(t)}")
        return t

    d_main = dw_times("patch_embed", PATCH_MAIN, torch.bfloat16, 400, 3)
    d_shapes = {"patch_embed_f32": dw_times("patch_embed", PATCH_MAIN,
                                            torch.float32, 410, 2)}
    for i, (name, k) in enumerate((("fig1", 3), ("fig1", 31), ("fig2", 17))):
        s = dict(fig_shape(name, k), stride=1)
        d_shapes[f"{name}_k{k}_f32"] = dw_times(name, s, torch.float32,
                                                420 + 30 * i, 26)

    Ba, S, KV, G, D = (ATTN_LLAVA[n] for n in ("B", "S", "KV", "G", "D"))
    lens = [S - 16] * Ba  # the request's middle decode step
    sets = []
    for i in range(3):  # 3 int8 caches of 26 MB: > 50 MB
        q, kq, vq, ln, ks, vs = attn_int8_inputs(430 + i, **ATTN_LLAVA,
                                                 q_dtype=torch.bfloat16,
                                                 lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None])[:, None, None, :]
        sets.append((q, kq, vq, ln, ks, vs, mask))

    def alibrary(q, kq, vq, ln, ks, vs, mask):
        k = (kq.float() * ks).to(q.dtype)
        v = (vq.float() * vs).to(q.dtype)
        return F.scaled_dot_product_attention(
            q.reshape(Ba, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    close(alibrary(*sets[0]).float().reshape(Ba, KV, G, D),
          ad.attention_decode_plain(*sets[0][:6]), BTOL,
          "library attention int8 llava shape")
    nbytes = (2 * Ba * KV * G * D + 2 * sum(lens) * KV * D
              + 2 * 4 * sum(lens) * KV + 4 * Ba + 4 * Ba * KV * G * D)
    a_ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, a_ops, torch.float32)
    attn = dict(timings(
        cycling(lambda *a: ad.decode_attention(*a[:6]), sets),
        cycling(lambda *a: ad.attention_decode_plain(*a[:6]), sets),
        cycling(alibrary, sets), HALF_BATCHES["p32"]),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=a_ops,
        max_abs_err=errs["attention_decode_int8_llava"],
        per="launch: B=4 S=3168 KV=8 G=7 D=128, bf16 q, int8 cache, lengths "
            "3152; library: dequant to bf16 + SDPA (enable_gqa)")
    log(f"time attention int8 {ATTN_LLAVA} lengths {lens}: {json.dumps(attn)}")
    rows = [
        dict(name="conv2d_quant", route="cuda",
             source="src/repro_torch/kernels/csrc/sliding_conv2d_quant.cu",
             replaces="src/repro/kernels/sliding_conv_quant.py:361",
             launches=launches["conv2d_quant"],
             max_abs_err=errs["conv2d_quant"],
             per="launch: llava patch_embed w8a8, x (20, 336, 336, 3) int8, w "
                 "(14, 14, 3, 1152) int8, stride 14, bf16 out, no bias; "
                 "library: torch._int_mm on the input unfolded ahead (K 588 "
                 "padded to 592) + epilogue",
             **{k: q_main[k] for k in keys + ("bound_by",)}, shapes=q_shapes),
        dict(name="conv2d_bwd_dw", route="cuda",
             source="src/repro_torch/kernels/csrc/sliding_conv2d_bwd.cu",
             replaces="src/repro/kernels/sliding_conv_bwd.py:440",
             launches=launches["conv2d_bwd_dw"],
             max_abs_err=errs["conv2d_bwd_dw"],
             per="launch: llava patch_embed x (20, 336, 336, 3) bf16, dz (20, "
                 "24, 24, 1152) bf16, stride 14, with db; library: "
                 "torch.nn.grad.conv2d_weight (cuDNN, TF32 off) + dz.sum",
             **{k: d_main[k] for k in keys + ("bound_by",)}, shapes=d_shapes),
    ]
    return rows, attn



# ---------------------------------------------------------------------------
# the paper's GEMM-convolution baselines (rows 5, 6, 7)
# ---------------------------------------------------------------------------

# the paper's companion 1-D table: (1, 16384, 32) x (K, 32, 32), stride 1
CONV1D_TABLE = [dict(B=1, L=16384, Cin=32, Cout=32, K=K, stride=1)
                for K in (3, 17, 65)]


def comparison_cases() -> list[dict]:
    """Phase 35's shapes, each a conv the baselines and the sliding
    kernels compute: fig1 and fig2 (f32), the companion 1-D table (f32),
    whisper's frontend (f32) and llava's patch embedding (bf16, f32).
    ``sets``: input sets cycled so that together they exceed the L2."""
    cases = [dict(name=f"fig1_k{s['k']}", dims=2, s=s, dtype=torch.float32,
                  sets=26) for s in FIG1]
    cases += [dict(name=f"fig2_k{s['k']}", dims=2, s=s, dtype=torch.float32,
                   sets=26) for s in FIG2]
    cases += [dict(name=f"conv1d_K{s['K']}", dims=1, s=s,
                   dtype=torch.float32, sets=26) for s in CONV1D_TABLE]
    cases += [dict(name=f"whisper_{n}", dims=1, s=s, dtype=torch.float32,
                   sets=8 if s["Cin"] < 512 else 4)
              for n, s in CONV_MAIN.items()]
    cases += [dict(name="patch_embed_bf16", dims=2, s=PATCH_MAIN,
                   dtype=torch.bfloat16, sets=4),
              dict(name="patch_embed_f32", dims=2, s=PATCH_MAIN,
                   dtype=torch.float32, sets=3)]
    return cases


def main_cases() -> dict:
    """Each kernel row's shape in the JSON line: the widest fig1 filter
    (row 7, and row 5 on its hbm column) and the widest 1-D filter (row
    6)."""
    fig = f"fig1_k{FIG1[-1]['k']}"
    return {"matmul": fig, "im2col_conv1d": f"conv1d_K{CONV1D_TABLE[-1]['K']}",
            "im2col_conv2d": fig}


def case_inputs(c, seed):
    """x, w and the stride of a comparison case (no bias: the baselines'
    kernels have no epilogue)."""
    s = c["s"]
    if c["dims"] == 1:
        x, w, _ = conv_inputs(seed, s["B"], s["L"], s["Cin"], s["Cout"],
                              s["K"], c["dtype"], with_bias=False)
        return x, w, s["stride"]
    x, w, _ = conv2d_inputs(seed, s["B"], s["H"], s["W"], s["Cin"], s["Cout"],
                            s["k"], c["dtype"], with_bias=False,
                            uniform=s is PATCH_MAIN)
    return x, w, (s["stride"],) * 2


def im2col_close(got, want, what) -> float:
    """Rows 5-9 and 16 against their plain versions (``want``: for rows
    5-7 the plain version on the same operands widened to float32):
    float32 within 1e-5 of max |want|, their float32 sums (prefix sums,
    read-outs) taken in another order; bfloat16 within one bf16 step of
    the plain value plus 1e-5 of max |want|."""
    if got.dtype == torch.bfloat16:
        return bf16_step_close(got, want, what)
    return close(got, want, dict(rtol=0.0, atol=1e-5 * want.abs().max().item()),
                 what)


def _conv_fns(ig, dims):
    """(fused, plain, hbm, columns) of the baselines for 1-D or 2-D."""
    if dims == 1:
        return (ig.conv1d_im2col_fused, ig.conv1d_im2col_fused_plain,
                ig.conv1d_im2col_hbm,
                lambda x, w, st: ig.columns_1d(x, w.shape[0], st))
    return (ig.conv2d_im2col_fused, ig.conv2d_im2col_fused_plain,
            ig.conv2d_im2col_hbm,
            lambda x, w, st: ig.columns_2d(x, w.shape[0], w.shape[1], st))


def phase_im2col_kernels(ig, ops, quant) -> dict:
    """33: rows 5, 6 and 7 against their plain versions, float32 and
    bfloat16: the GEMM at ragged shapes; the fused convs and the hbm
    baseline (the column, then row 5) at the reference tests' filters,
    strides 1-3, Cin 3 and 37, and at phase 35's real shapes. Then
    ``ops.conv1d`` / ``ops.conv2d`` on every backend and padding with bias
    and an activation, each call's launches counted, against ``xla``;
    ``ops.matmul``; a call needing a gradient raising; a ``QuantizedWeight``
    built from calibration's CPU scales through ``ops.conv2d`` on the card.
    Returns each row's max |err| at its phase-35 shape."""
    g = torch.Generator(device=DEV).manual_seed(330)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        # and row 5's edges: K 588 (8-byte bf16 rows), N 1 and
        # 32, M < 16, splits; two calls bitwise equal
        for M, K, N in ((200, 70, 90), (333, 517, 65), (1, 1, 1),
                        (129, 31, 1152), (64, 32, 64), (15, 588, 32),
                        (300, 588, 1), (1000, 588, 1152), (9604, 4096, 32)):
            a, b = randn(M, K, dtype=dtype), randn(K, N, scale=K ** -0.5,
                                                   dtype=dtype)
            what = f"matmul ({M}, {K}) @ ({K}, {N}) {dtype}"
            got = ig.matmul(a, b)
            err = im2col_close(got, ig.matmul_plain(a.float(), b.float()),
                               what)
            if not torch.equal(got, ig.matmul(a, b)):
                raise AssertionError(f"{what}: two calls differ")
            log(f"{what}: max|err| {err:.3e}")
        for dims, cases in ((1, ((3, 1), (7, 2), (17, 3), (3, 3))),
                            (2, ((3, 3, (1, 1)), (5, 5, (2, 2)),
                                 (7, 5, (2, 3)), (3, 3, (3, 2))))):
            fused, plain, hbm, _ = _conv_fns(ig, dims)
            for case in cases:
                for cin in (3, 37):
                    if dims == 1:
                        K, st = case
                        x = randn(3, 301, cin, dtype=dtype)
                        w = randn(K, cin, 70, scale=(K * cin) ** -0.5,
                                  dtype=dtype)
                    else:
                        kh, kw, st = case
                        x = randn(2, kh + 40, kw + 45, cin, dtype=dtype)
                        w = randn(kh, kw, cin, 70,
                                  scale=(kh * kw * cin) ** -0.5, dtype=dtype)
                    want = plain(x.float(), w.float(), stride=st)
                    for name, fn in (("fused", fused), ("hbm", hbm)):
                        what = (f"im2col {dims}-D {name} w {tuple(w.shape)} "
                                f"s={st} {dtype}")
                        err = im2col_close(fn(x, w, stride=st), want, what)
                    log(f"im2col {dims}-D w {tuple(w.shape)} s={st} {dtype}: "
                        f"fused and hbm max|err| <= {err:.3e}")
    main_case = main_cases()
    for c in comparison_cases():
        x, w, st = case_inputs(c, 340)
        fused, plain, hbm, columns = _conv_fns(ig, c["dims"])
        want = plain(x.float(), w.float(), stride=st)
        e_f = im2col_close(fused(x, w, stride=st), want,
                           f"im2col fused {c['name']} {c['dtype']}")
        col = columns(x, w, st)
        e_m = im2col_close(ig.matmul(col, w.reshape(col.shape[1], -1)),
                           want.reshape(col.shape[0], -1),
                           f"matmul on the hbm column {c['name']}")
        del col
        row = "im2col_conv1d" if c["dims"] == 1 else "im2col_conv2d"
        if main_case[row] == c["name"]:
            errs[row] = e_f
        if main_case["matmul"] == c["name"]:
            errs["matmul"] = e_m
        log(f"im2col {c['name']} {c['dtype']}: fused max|err| {e_f:.3e}, "
            f"row 5 on its column {e_m:.3e}")

    # the ops entry points: every backend and padding, bias + activation,
    # each call's launches, against the library conv
    b = randn(70)
    x1, w1 = randn(2, 130, 37), randn(5, 37, 70, scale=(5 * 37) ** -0.5)
    x2, w2 = randn(2, 40, 45, 37), randn(3, 5, 37, 70,
                                         scale=(15 * 37) ** -0.5)
    want1 = {"sliding": {"sliding_conv1d": 1},
             "sliding_pallas": {"sliding_conv1d": 1},
             "xla": {}, "im2col_gemm": {"im2col_conv1d": 1},
             "im2col_hbm": {"matmul": 1}}
    want2 = dict(want1, sliding={"conv2d": 1},
                 sliding_pallas={"conv2d": 1},
                 im2col_gemm={"im2col_conv2d": 1})
    for fn, x, w, pads, wants in (
            (ops.conv1d, x1, w1, ("VALID", "SAME", "CAUSAL", (3, 1)), want1),
            (ops.conv2d, x2, w2, ("VALID", "SAME", ((2, 1), (0, 3))), want2)):
        for pad in pads:
            args = dict(padding=pad, bias=b, activation="gelu")
            ref = fn(x, w, backend="xla", **args)
            for backend, counts in wants.items():
                zero_launches()
                got = fn(x, w, backend=backend, **args)
                launches = read_launches()
                if launches != only(**counts):
                    raise AssertionError(f"ops.{fn.__name__} {backend} {pad}: "
                                         f"launches {launches}")
                close(got, ref, TOL, f"ops.{fn.__name__} {backend} {pad}")
        log(f"ops.{fn.__name__}: every backend and padding {pads} against "
            f"xla within TOL, launches as expected")
    a, bm = randn(300, 77), randn(77, 50)
    zero_launches()
    got = ops.matmul(a, bm)
    if read_launches() != only(matmul=1):
        raise AssertionError(f"ops.matmul launches {read_launches()}")
    im2col_close(got, ig.matmul_plain(a, bm), "ops.matmul")
    for what, call in (
            ("conv2d im2col_gemm", lambda: ops.conv2d(
                x2, w2.clone().requires_grad_(), backend="im2col_gemm")),
            ("conv1d im2col_hbm", lambda: ops.conv1d(
                x1.clone().requires_grad_(), w1, backend="im2col_hbm")),
            ("matmul", lambda: ops.matmul(a, bm.clone().requires_grad_()))):
        try:
            call()
        except NotImplementedError as e:
            if "forward only" not in str(e):
                raise
        else:
            raise AssertionError(f"{what}: a call needing a gradient ran")
    log("the baselines refuse calls that need a gradient")

    # a QuantizedWeight built by hand from calibration's CPU scales
    calib = quant.Calibration()
    calib.observe("by_hand", x2)
    xs = calib.spec()["by_hand"]["x_scale"]
    if xs.device.type != "cpu":
        raise AssertionError(f"calibration scale on {xs.device}")
    qw = quant.quantize_weight(w2, xs)
    if qw.x_scale.device != x2.device:
        raise AssertionError(f"x_scale left on {qw.x_scale.device}")
    args = dict(backend="sliding_pallas", bias=b, precision="w8a8",
                w_scale=qw.scale)
    got = ops.conv2d(x2, qw.q, x_scale=qw.x_scale, **args)
    if not torch.equal(got, ops.conv2d(x2, qw.q, x_scale=xs.to(DEV), **args)):
        raise AssertionError("w8a8 conv2d from CPU calibration scales differs "
                             "from the same call with the scale moved")
    log(f"a QuantizedWeight from CPU calibration scales runs on the card "
        f"(x_scale on {qw.x_scale.device})")
    torch.cuda.synchronize()
    return errs


def phase_baselines(ops) -> dict:
    """The slice's main path: the paper's comparison through the entry
    points a user calls, at its real shapes: ``ops.conv2d`` at fig1 and
    fig2 and ``ops.conv1d`` at the companion 1-D table, each on
    ``im2col_gemm`` and ``im2col_hbm`` with bias + gelu, and one
    ``ops.matmul``; launch counts read, every output held to ``xla``."""
    g = torch.Generator(device=DEV).manual_seed(350)
    zero_launches()
    t0 = time.perf_counter()
    outs = []
    for c in comparison_cases():
        if not c["name"].startswith(("fig", "conv1d_")):
            continue
        x, w, st = case_inputs(c, 351)
        b = torch.randn((w.shape[-1],), generator=g, device=DEV)
        fn = ops.conv1d if c["dims"] == 1 else ops.conv2d
        for backend in ("im2col_gemm", "im2col_hbm"):
            outs.append((c["name"], backend,
                         fn(x, w, stride=st, backend=backend, bias=b,
                            activation="gelu"), (fn, x, w, st, b)))
    a = torch.randn((4096, 512), generator=g, device=DEV)
    bm = torch.randn((512, 1024), generator=g, device=DEV) / 512 ** 0.5
    mm = ops.matmul(a, bm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n2 = len(FIG1) + len(FIG2)
    want = only(im2col_conv2d=n2, im2col_conv1d=len(CONV1D_TABLE),
                matmul=n2 + len(CONV1D_TABLE) + 1)
    if launches != want:
        raise AssertionError(f"baselines launches {launches}, expected {want}")
    for name, backend, y, (fn, x, w, st, b) in outs:
        close(y, fn(x, w, stride=st, backend="xla", bias=b,
                    activation="gelu"), TOL, f"baselines {name} {backend}")
    close(mm, a @ bm, TOL, "baselines ops.matmul")
    log(f"baselines path: {len(outs)} convs + 1 matmul in {wall:.3f}s, "
        f"launches {launches}")
    return dict(launches=launches, wall_s=wall)


def phase_smoke_serve_im2col(serve, models, configs, map_tree):
    """34: whisper's smoke config (float32) served on the card through
    ``--conv-backend im2col_gemm`` (the frontend on the core column-tensor
    twin, as the reference's layers route it) and through
    ``sliding_pallas``, from one set of weights: equal greedy tokens,
    prefill logits within TOL. Both sum the frontend's float32 products in
    another order (the kernel's FMA chain, the library GEMM over the
    column), about 1e-6 of the conv output apart; TOL is what the CPU
    tests hold the two packages' whisper to end to end. The CLI on both
    backends (same seed, same weights): equal sample lines. jamba's mamba
    conv has no im2col_gemm and raises, as in the reference."""
    cfg = configs.smoke_config(configs.get_config("whisper-medium"))
    params = map_tree(lambda t: t.to(DEV), models.build_model(cfg).init(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(34)
    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])).astype(np.int32)
    ).to(DEV)
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for backend in ("sliding_pallas", "im2col_gemm"):
        model = models.build_model(cfg.replace(conv_backend=backend))
        zero_launches()
        with torch.no_grad():
            logits, _ = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len)
        toks, _ = serve.generate(model, params, prompts, gen_len=SMOKE["gen"],
                                 cache_len=cache_len)
        out[backend] = (logits.cpu(), toks.cpu(), read_launches())
    conv_k = {k: v for k, v in out["im2col_gemm"][2].items()
              if k != "attention_decode"}
    if (any(conv_k.values()) or out["sliding_pallas"][2]["sliding_conv1d"] != 4
            or out["im2col_gemm"][2]["attention_decode"]
            != out["sliding_pallas"][2]["attention_decode"]):
        raise AssertionError(f"smoke im2col_gemm launches {out['im2col_gemm'][2]}"
                             f", sliding_pallas {out['sliding_pallas'][2]}")
    err = close(out["im2col_gemm"][0], out["sliding_pallas"][0], TOL,
                "smoke prefill logits, im2col_gemm vs sliding_pallas")
    if not torch.equal(out["im2col_gemm"][1], out["sliding_pallas"][1]):
        raise AssertionError(f"smoke tokens differ: im2col_gemm "
                             f"{out['im2col_gemm'][1].tolist()}, sliding_pallas "
                             f"{out['sliding_pallas'][1].tolist()}")
    samples = {}
    for backend in ("sliding_pallas", "im2col_gemm"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", "whisper-medium", "--smoke", "--batch", "2",
                        "--prompt-len", "8", "--gen", "4", "--conv-backend",
                        backend])
        samples[backend] = next(ln for ln in buf.getvalue().splitlines()
                                if "[serve] sample:" in ln)
    if samples["im2col_gemm"] != samples["sliding_pallas"]:
        raise AssertionError(f"CLI samples differ: {samples}")
    jcfg = configs.smoke_config(configs.get_config(JAMBA)).replace(
        conv_backend="im2col_gemm")
    jmodel = models.build_model(jcfg)
    jparams = map_tree(lambda t: t.to(DEV), jmodel.init(
        torch.Generator().manual_seed(0)))
    jprompts = torch.from_numpy(rng.integers(
        2, jcfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])).astype(np.int32)
    ).to(DEV)
    try:
        with torch.no_grad():
            serve.prefill_cache(jmodel, jparams, jprompts, cache_len=cache_len)
    except ValueError as e:
        if "im2col_gemm" not in str(e):
            raise
    else:
        raise AssertionError("jamba served on im2col_gemm")
    log(f"smoke serve im2col_gemm {SMOKE}: tokens equal to sliding_pallas "
        f"{out['im2col_gemm'][1].tolist()}, prefill logits max|err| "
        f"{err:.3e}; CLI {samples['im2col_gemm']}; jamba raises ValueError")


def phase_im2col_times(ig, sc, s2, launches, errs) -> list[dict]:
    """35: the paper's comparison on this card. Each shape of
    ``comparison_cases``: the sliding kernel (row 1 or row 4), the fused
    im2col kernel (row 6 or 7), the hbm baseline whole and its two parts
    timed apart (the column by torch ops, row 5 on it), cuDNN
    (``F.conv1d`` / ``F.conv2d`` on channels_last, TF32 off), row 5 against
    ``torch.matmul`` (TF32 off) at the column's shape, the plain version,
    and the bounds (the conv's, row 5's at the column, and the hbm
    baseline's with its column written and read). Card time per call from
    CUDA events, queue filled, median of 10 batches of 5, inputs cycled
    past the L2. Returns the JSON rows of rows 5, 6 and 7."""
    rows = {}
    for c in comparison_cases():
        dims, dtype, el = c["dims"], c["dtype"], c["dtype"].itemsize
        fused, plain, hbm, columns = _conv_fns(ig, dims)
        sets = []
        for i in range(c["sets"]):
            x, w, st = case_inputs(c, 360 + 40 * i)
            if dims == 1:  # the library's layouts, made ahead
                lib = (x.transpose(1, 2), w.permute(2, 1, 0).contiguous())
            else:
                lib = (x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last))
            sets.append((x, w, *lib))
        x, w = sets[0][:2]
        cout = w.shape[-1]
        col = columns(x, w, st)
        M, Kr = col.shape
        col_bytes = el * col.numel()
        # enough columns to exceed the L2 (one when a column alone does)
        n_col = min(len(sets), -(-120_000_000 // col_bytes))
        cols = [(col, w.reshape(Kr, cout))] + [
            (columns(xx, ww, st), ww.reshape(Kr, cout))
            for xx, ww, *_ in sets[1:n_col]]

        if dims == 1:
            def sliding(x, w, *_):
                return sc.conv1d_sliding(x, w, None, stride=st)

            def library(x, w, x_lib, w_lib):
                return F.conv1d(x_lib, w_lib, stride=st).transpose(1, 2)
        else:
            def sliding(x, w, *_):
                return s2.conv2d_sliding(x, w, None, stride=st)

            def library(x, w, x_lib, w_lib):
                return F.conv2d(x_lib, w_lib, stride=st).permute(0, 2, 3, 1)

        want = plain(x, w, stride=st)
        close(library(*sets[0]), want,
              LIBTOL if dtype == torch.bfloat16 else TOL,
              f"library conv {c['name']}")
        close(torch.matmul(*cols[0]).reshape(want.shape), want,
              LIBTOL if dtype == torch.bfloat16 else TOL,
              f"library matmul {c['name']}")
        ops_n = 2 * M * cout * Kr
        y_bytes = el * M * cout
        conv_bytes = el * (x.numel() + w.numel()) + y_bytes
        bms, by = bound_ms(conv_bytes, ops_n, dtype)
        mm_bms, mm_by = bound_ms(col_bytes + el * w.numel() + y_bytes, ops_n,
                                 dtype)
        hbm_bms, hbm_by = bound_ms(conv_bytes + 2 * col_bytes, ops_n, dtype)
        t = {}
        for key, fn, args in (
                ("sliding_ms", sliding, sets), ("ms", lambda x, w, *_: fused(
                    x, w, stride=st), sets),
                ("plain_ms", lambda x, w, *_: plain(x, w, stride=st), sets),
                ("hbm_ms", lambda x, w, *_: hbm(x, w, stride=st), sets),
                ("column_ms", lambda x, w, *_: columns(x, w, st), sets),
                ("matmul_ms", ig.matmul, cols),
                ("matmul_library_ms", torch.matmul, cols),
                ("matmul_plain_ms", ig.matmul_plain, cols),
                ("library_ms", library, sets)):
            t[key] = card_ms(cycling(fn, args), batches=10, inner=5)
        del cols, col
        r = dict(t, bound_ms=bms, bound_by=by, bytes=conv_bytes, ops=ops_n,
                 column=(M, Kr), column_bytes=col_bytes, matmul_bound_ms=mm_bms,
                 matmul_bound_by=mm_by, hbm_bound_ms=hbm_bms,
                 hbm_bound_by=hbm_by)
        rows[c["name"]] = r
        sl = t["sliding_ms"]
        log(f"compare {c['name']} {c['s']} {dtype}: sliding {sl:.4f} / "
            f"im2col_fused {t['ms']:.4f} / im2col_hbm {t['hbm_ms']:.4f} "
            f"(column {t['column_ms']:.4f} + row 5 {t['matmul_ms']:.4f}) / "
            f"cuDNN {t['library_ms']:.4f} ms = 1 : {t['ms'] / sl:.3f} : "
            f"{t['hbm_ms'] / sl:.3f} : {t['library_ms'] / sl:.3f}; bound "
            f"{bms:.5f} ({by}), hbm bound {hbm_bms:.5f} ({hbm_by}); row 5 vs "
            f"torch.matmul {t['matmul_library_ms']:.4f}, bound {mm_bms:.5f}; "
            f"plain {t['plain_ms']:.4f}")
        torch.cuda.empty_cache()

    def is_1d(n):
        return n.startswith(("conv1d_", "whisper_"))

    def kernel_row(name, source_line, key, plain_key, lib_key, bkey, per):
        main = main_cases()[name]
        m = rows[main]
        others = [n for n in rows if n != main and (
            name == "matmul" or is_1d(n) == (name == "im2col_conv1d"))]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/im2col_gemm.cu",
            replaces=f"src/repro/kernels/im2col_gemm.py:{source_line}",
            launches=launches[name], max_abs_err=errs[name], ms=m[key],
            plain_ms=m[plain_key], library_ms=m[lib_key],
            bound_ms=m[bkey], bound_by=m[bkey.replace("_ms", "_by")], per=per,
            shapes={n: {k: rows[n][k] for k in (key, plain_key, lib_key, bkey)}
                    for n in others})

    return [
        kernel_row("matmul", 48, "matmul_ms", "matmul_plain_ms",
                   "matmul_library_ms", "matmul_bound_ms",
                   "launch: fig1 k=31's hbm column (9604, 30752) @ (30752, "
                   "32) f32; library: torch.matmul, TF32 off"),
        kernel_row("im2col_conv1d", 104, "ms", "plain_ms",
                   "library_ms", "bound_ms",
                   "launch: (1, 16384, 32) x (65, 32, 32) f32; library: "
                   "F.conv1d (cuDNN, TF32 off)"),
        kernel_row("im2col_conv2d", 183, "ms", "plain_ms",
                   "library_ms", "bound_ms",
                   "launch: fig1 (1, 128, 128, 32) x (31, 31, 32, 32) f32; "
                   "library: F.conv2d channels_last (cuDNN, TF32 off)"),
    ]


# ---------------------------------------------------------------------------
# sliding-window pooling (rows 8, 9) and the selective scan (row 16)
# ---------------------------------------------------------------------------

# the companion paper's pooling shape and windows (the reference
# benchmark's autotune/pool1d rows, benchmarks/run.py:106-113); one
# bandwidth-sized shape; the scan at one chunk of jamba-1.5-large's prefill
# (SCAN_MAIN, from analysis.contracts: d_inner 16384, d_state 16,
# SSM_CHUNK 256)
POOL_PAPER = dict(B=1, L=16384, C=32)
POOL_WINDOWS = (4, 16, 64, 256)
POOL_WIDE = dict(B=8, L=16384, C=1024, w=16)
# row 8's forms: (counter and JSON name, op, method)
POOL_FORMS = (("sliding_pool_sum", "sum", "scan"),
              ("sliding_pool_avg", "avg", "scan"),
              ("sliding_pool_max_scan", "max", "scan"),
              ("sliding_pool_max_shift", "max", "shift"))


def pool_input(seed, B, L, C, dtype, kind="normal"):
    """x (B, L, C): normals, zeros, post-relu normals (ties at 0), or
    "distinct": each (b, c) column a random permutation of L distinct
    values in [-4, 4) (no ties in any window, whatever its size)."""
    if kind == "zeros":
        return torch.zeros((B, L, C), device=DEV, dtype=dtype)
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, L, C), generator=g, device=DEV)
    if kind == "distinct":
        x = (torch.argsort(x, dim=1).float() / L - 0.5) * 8
    return (x.clamp(min=0) if kind == "relu" else x).to(dtype)


def check_pool(sp, x, window, what) -> dict:
    """Every form of row 8, the sum gradient (row 8 on the padded
    cotangent) and row 9 on one input, each against its plain version:
    row 8 within ``im2col_close`` and equal (sum, avg and the sum gradient
    bit for bit: the plain version walks the kernel's layout in its float32
    order); the max forms equal to each other; in float32 the max
    gradient's mass conserved (dy = 1: every window's unit split over its
    ties, so each (b, c) column of dx sums to the number of windows).
    Returns max |err| by counter name."""
    errs, ys = {}, {}
    for name, op, method in POOL_FORMS:
        got = sp.sliding_pool(x, window=window, op=op, method=method)
        want = sp.sliding_pool_plain(x, window=window, op=op, method=method)
        errs[name] = im2col_close(got, want, f"{what} {name}")
        if not torch.equal(got, want):
            raise AssertionError(f"{what} {name}: not equal to its plain "
                                 "version")
        ys[name] = got
    y = ys["sliding_pool_max_scan"]
    if not torch.equal(y, ys["sliding_pool_max_shift"]):
        raise AssertionError(f"{what}: max scan and max shift differ")
    g = torch.Generator(device=DEV).manual_seed(window)
    dy = torch.randn(y.shape, generator=g, device=DEV).to(x.dtype)
    got = sp.sum_pool_bwd(dy, window=window)
    want = sp.sum_pool_bwd_plain(dy, window=window)
    errs["sum_pool_bwd"] = im2col_close(got, want, f"{what} sum_pool_bwd")
    if not torch.equal(got, want):
        raise AssertionError(f"{what} sum_pool_bwd: not equal to its plain "
                             "version")
    errs["max_pool_bwd"] = im2col_close(
        sp.max_pool_bwd(x, y, dy, window=window),
        sp.max_pool_bwd_plain(x, y, dy, window=window),
        f"{what} max_pool_bwd")
    if x.dtype == torch.float32:
        mass = sp.max_pool_bwd(x, y, torch.ones_like(y), window=window).sum(1)
        n = y.shape[1]
        if not torch.allclose(mass, torch.full_like(mass, n), rtol=1e-5,
                              atol=1e-5 * n):
            raise AssertionError(f"{what}: max-pool gradient mass "
                                 f"{mass.min().item()}..{mass.max().item()}, "
                                 f"expected {n} a channel")
    return errs


def phase_pool_kernels(sp) -> dict:
    """36: rows 8 and 9 against their plain versions (``check_pool``): the
    paper's shape (1, 16384, 32) f32 and bf16 at w in {4, 16, 64, 256};
    the edges w = 1, w = L, (1, 300, 8) at w 100 and 256, C = 1 as (8,
    16384, 1) (``benchmarks/table_conv1d.py``'s layout), C = 37 with ragged
    last blocks, (4, 4096, 64) at w 3 (row 9's threads walk 4 blocks
    each), (2, 3000, 37) at w 2000 (row 8's halos streamed in pieces),
    each on normals, zeros and post-relu normals; row 9 alone at (8, 3000,
    1024), w 300 (its slots in global scratch); (8, 2000, 1024) at w 200 in
    bf16, the case a parallel prefix once moved the average two bf16
    steps from, on the three inputs; a float16 call refused. Row 9 shares
    each block among lanes at the paper's shape from w 64 and at the small
    edges. Returns each row's max |err| at the paper's shape."""
    P = POOL_PAPER
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = pool_input(360, P["B"], P["L"], P["C"], dtype)
        for w in POOL_WINDOWS:
            for k, v in check_pool(sp, x, w, f"pool {P} w={w} {dtype}").items():
                errs[k] = max(errs.get(k, 0.0), v)
    edges = (((2, 300, 37), 1), ((2, 300, 37), 300), ((1, 300, 8), 100),
             ((1, 300, 8), 256), ((8, P["L"], 1), 16), ((2, 1001, 37), 7),
             ((3, 5000, 64), 33), ((4, 4096, 64), 3), ((2, 3000, 37), 2000))
    for dtype in (torch.float32, torch.bfloat16):
        for (B, L, C), w in edges:
            for kind in ("normal", "zeros", "relu"):
                check_pool(sp, pool_input(361 + w, B, L, C, dtype, kind), w,
                           f"pool ({B}, {L}, {C}) w={w} {kind} {dtype}")
        # row 9 alone where its slots live in global scratch (one lane a
        # block of 300 rows), on the exact max forward
        for kind in ("normal", "relu"):
            x = pool_input(362, 8, 3000, 1024, dtype, kind)
            y = sp.sliding_pool(x, window=300, op="max")
            if not torch.equal(y, sp.sliding_pool_plain(x, window=300,
                                                        op="max")):
                raise AssertionError("pool (8, 3000, 1024) w=300: max not "
                                     "exact")
            dy = pool_input(363, 8, 2701, 1024, dtype)
            im2col_close(sp.max_pool_bwd(x, y, dy, window=300),
                         sp.max_pool_bwd_plain(x, y, dy, window=300),
                         f"pool (8, 3000, 1024) w=300 {kind} {dtype} "
                         "max_pool_bwd")
            del x, y, dy
    for kind in ("normal", "zeros", "relu"):
        check_pool(sp, pool_input(364, 8, 2000, 1024, torch.bfloat16, kind),
                   200, f"pool (8, 2000, 1024) w=200 {kind} bf16")
    try:
        sp.sliding_pool(torch.zeros((1, 8, 2), device=DEV,
                                    dtype=torch.float16), window=3)
    except TypeError:
        pass
    else:
        raise AssertionError("a float16 pool call was not refused")
    torch.cuda.synchronize()
    log(f"pool kernels vs plain: max|err| {errs}")
    return errs


def scan_inputs(seed, B, L, D, N, dtype):
    """abar in [0.3, 1), bx and c normal, in ``dtype``; h0 normal, float32."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    abar = (torch.rand((B, L, D, N), generator=g, device=DEV) * 0.7 + 0.3)
    bx = torch.randn((B, L, D, N), generator=g, device=DEV)
    c = torch.randn((B, L, N), generator=g, device=DEV)
    h0 = torch.randn((B, D, N), generator=g, device=DEV)
    return abar.to(dtype), bx.to(dtype), c.to(dtype), h0


def check_scan(ss, args, what) -> float:
    y, h = ss.ssm_scan(*args)
    yw, hw = ss.ssm_scan_plain(*args)
    return max(im2col_close(y, yw, f"{what} y"),
               im2col_close(h, hw, f"{what} h_last"))


def phase_scan_kernels(ss) -> tuple[float, dict]:
    """37: row 16 against its plain version: jamba-1.5-large's prefill
    chunk (4, 256, 16384, 16) f32, random h0, is row 16's path (one call,
    launches counted from zero), then bf16 there; the edges L in {1, 37},
    D 200 (not a multiple of the block of 128 d), N in {4, 8, 16, 17, 20,
    65, 128} (17 and 20 at the next compiled width, the lanes past N
    masked; 65 and 128 in groups of 64), f32 and bf16. y and h_last within
    1e-5 of max (f32), y within one bf16 step (bf16). Returns max |err| at
    the jamba chunk (f32) and the path."""
    S = SCAN_MAIN
    args = scan_inputs(370, S["B"], S["L"], S["D"], S["N"], torch.float32)
    zero_launches()
    t0 = time.perf_counter()
    y, h = ss.ssm_scan(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches != only(ssm_scan=1):
        raise AssertionError(f"ssm_scan path launches {launches}")
    yw, hw = ss.ssm_scan_plain(*args)
    err = max(im2col_close(y, yw, "ssm_scan jamba chunk f32 y"),
              im2col_close(h, hw, "ssm_scan jamba chunk f32 h_last"))
    del args, y, h, yw, hw
    args = scan_inputs(371, S["B"], S["L"], S["D"], S["N"], torch.bfloat16)
    err_bf16 = check_scan(ss, args, "ssm_scan jamba chunk bf16")
    del args
    for dtype in (torch.float32, torch.bfloat16):
        for L in (1, 37):
            for N in (4, 8, 16, 17, 20, 65, 128):
                check_scan(ss, scan_inputs(372 + L + N, 2, L, 200, N, dtype),
                           f"ssm_scan (2, {L}, 200, {N}) {dtype}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"ssm_scan vs plain: jamba chunk {S} f32 max|err| {err:.3e}, bf16 "
        f"{err_bf16:.3e}; path {wall:.3f}s, launches {launches}")
    return err, dict(launches=launches, wall_s=wall)


def phase_pool_path(sp, ops) -> dict:
    """38: the pooling path through the entry point a user calls:
    ``ops.pool1d`` forward and backward (``Pool1d``) at the paper's shape
    (1, 16384, 32) f32 for sum, avg and max at each window of
    ``POOL_WINDOWS``, the max method resolved by ``_pool_method`` (shift
    at 4 and 16, scan at 64 and 256); launches counted from zero over the
    path, and per call (sum/avg: 1 row-8 launch forward, 1 backward; max:
    1 forward, 1 row-9); every output and gradient held to the same call
    on CPU tensors (the plain versions). Then ``ops.conv1d(backend=
    "sliding")`` on a CUDA tensor: one row-1 launch."""
    P = POOL_PAPER
    x = pool_input(380, P["B"], P["L"], P["C"], torch.float32)
    g = torch.Generator(device=DEV).manual_seed(381)
    runs = []
    zero_launches()
    t0 = time.perf_counter()
    for op in ("sum", "avg", "max"):
        for w in POOL_WINDOWS:
            before = read_launches()
            xd = x.detach().requires_grad_()
            y = ops.pool1d(xd, window=w, op=op)
            dy = torch.randn(y.shape, generator=g, device=DEV)
            y.backward(dy)
            after = read_launches()
            method = ops._pool_method(x, w, op, None)
            form = f"sliding_pool_{op if op != 'max' else 'max_' + method}"
            bwd = {"max_pool_bwd": 1} if op == "max" else {"sum_pool_bwd": 1}
            got = {k: after[k] - before[k] for k in after}
            if got != only(**{form: 1}, **bwd):
                raise AssertionError(f"pool1d {op} w={w}: launches {got}")
            runs.append((op, w, y.detach(), xd.grad, dy))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    errs = {}
    for op, w, y, dx, dy in runs:
        xc = x.cpu().detach().requires_grad_()
        yc = ops.pool1d(xc, window=w, op=op)
        yc.backward(dy.cpu())
        what = f"pool path {op} w={w}"
        errs[f"{op}_w{w}"] = max(im2col_close(y.cpu(), yc.detach(), what),
                                 im2col_close(dx.cpu(), xc.grad, what + " dx"))
    xs, ws, bs = conv_inputs(382, 2, 514, 80, 1024, 3, torch.float32)
    zero_launches()
    ys = ops.conv1d(xs, ws, bias=bs, padding="SAME", backend="sliding",
                    activation="gelu")
    torch.cuda.synchronize()
    if read_launches() != only(sliding_conv1d=1):
        raise AssertionError(f"ops.conv1d(backend='sliding'): launches "
                             f"{read_launches()}, expected one row-1 launch")
    if not torch.equal(ys, ops.conv1d(xs, ws, bias=bs, padding="SAME",
                                      backend="sliding_pallas",
                                      activation="gelu")):
        raise AssertionError("ops.conv1d: sliding and sliding_pallas differ")
    close(ys, ops.conv1d(xs, ws, bias=bs, padding="SAME", backend="xla",
                         activation="gelu"), TOL, "ops.conv1d sliding vs xla")
    log(f"pool path: {len(runs)} pool1d calls with backward in {wall:.3f}s, "
        f"launches {launches}; vs CPU max|err| {max(errs.values()):.3e}; "
        "ops.conv1d(backend='sliding') on one row-1 launch")
    return dict(launches=launches, wall_s=wall, max_abs_err_vs_cpu=errs)


def _pool_case_times(sp, B, L, C, w, n_sets, batches, inner,
                     dtype=torch.float32) -> dict:
    """Row 8's forms, the sum gradient and, in float32, row 9 at one shape:
    card ms per call of the kernel, its plain version and one library call,
    on input sets cycled past the L2 (tie-free in float32, so that autograd
    of ``F.max_pool1d``, one argmax a window, computes row 9's function);
    the bytes bound of each."""
    el = dtype.itemsize
    n_out = L - w + 1
    xs = [pool_input(390 + i, B, L, C, dtype, "distinct")
          for i in range(n_sets)]
    g = torch.Generator(device=DEV).manual_seed(391)
    dys = [torch.randn((B, n_out, C), generator=g, device=DEV).to(dtype)
           for _ in range(n_sets)]
    x_lib = [x.transpose(1, 2).contiguous() for x in xs]  # (B, C, L), ahead
    # the padded cotangent in the library's layout, made ahead
    dyp_lib = [F.pad(dy, (0, 0, w - 1, w - 1)).transpose(1, 2).contiguous()
               for dy in dys]
    ys = [sp.sliding_pool(x, window=w, op="max") for x in xs]
    # autograd of F.max_pool1d: its graph (argmax indices) made ahead
    lib_graphs = []
    for xl, dy in zip(x_lib, dys):
        xr = xl.detach().requires_grad_()
        lib_graphs.append((xr, F.max_pool1d(xr, w, stride=1),
                           dy.transpose(1, 2).contiguous()))
    io = el * (B * L * C + B * n_out * C)
    lib = {
        "sum": lambda i: F.avg_pool1d(x_lib[i], w, stride=1) * w,
        "avg": lambda i: F.avg_pool1d(x_lib[i], w, stride=1),
        "max": lambda i: F.max_pool1d(x_lib[i], w, stride=1),
    }
    fns = {}
    for name, op, method in POOL_FORMS:
        fns[name] = (
            lambda i, op=op, m=method: sp.sliding_pool(xs[i], window=w, op=op,
                                                       method=m),
            lambda i, op=op, m=method: sp.sliding_pool_plain(
                xs[i], window=w, op=op, method=m),
            lib[op], io, (2 if op == "sum" else 3) * B * L * C)
    fns["sum_pool_bwd"] = (
        lambda i: sp.sum_pool_bwd(dys[i], window=w),
        lambda i: sp.sum_pool_bwd_plain(dys[i], window=w),
        lambda i: F.avg_pool1d(dyp_lib[i], w, stride=1) * w, io,
        2 * B * L * C)
    fns["max_pool_bwd"] = (
        lambda i: sp.max_pool_bwd(xs[i], ys[i], dys[i], window=w),
        lambda i: sp.max_pool_bwd_plain(xs[i], ys[i], dys[i], window=w),
        lambda i: torch.autograd.grad(lib_graphs[i][1], lib_graphs[i][0],
                                      lib_graphs[i][2], retain_graph=True)[0],
        el * (2 * B * L * C + B * n_out * C), 2 * B * (L + n_out) * C)
    if dtype != torch.float32:  # ties in bf16: the library takes one argmax
        del fns["max_pool_bwd"]
    out = {}
    for name, (kernel, plain, library, nbytes, ops_n) in fns.items():
        want = plain(0)
        got = library(0)
        got = got.transpose(1, 2)  # back to (B, L, C)
        close(got, want, TOL if dtype == torch.float32 else LIBTOL,
              f"library {name} w={w} {dtype}")
        bms, by = bound_ms(nbytes, ops_n, torch.float32)
        t = {}
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            t[key] = card_ms(cycling(fn, [(i,) for i in range(n_sets)]),
                             batches=batches, inner=inner)
        out[name] = dict(t, bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops_n)
    del xs, dys, x_lib, dyp_lib, ys, lib_graphs
    torch.cuda.empty_cache()
    return out


def phase_pool_times(sp, ss, mamba, launches, errs) -> list[dict]:
    """39: rows 8, 9 and 16 on this card. Each pool row at the paper's
    shape (1, 16384, 32) f32 at every window of ``POOL_WINDOWS`` (26 input
    sets cycled past the L2; the shape is launch-bound) and at (8, 16384,
    1024) f32, w 16 (512 MiB an input); library calls: ``F.avg_pool1d``
    (× w for sum; on the padded cotangent for the sum gradient),
    ``F.max_pool1d`` and autograd of it (one argmax per window on tie-free
    input), each on the (B, C, L) layout made ahead. Row 16 at the jamba
    chunk (4, 256, 16384, 16), f32 and bf16; no PyTorch call computes the
    scan, so ``library_ms`` is null and the port's mamba
    ``_assoc_scan`` with its read-out (what jamba's prefill runs today)
    stands beside it. Card ms per call from CUDA events, queue filled,
    median of 5 batches of 5."""
    P, W = POOL_PAPER, POOL_WIDE
    cases = {f"paper_w{w}": _pool_case_times(sp, P["B"], P["L"], P["C"], w,
                                             26, HALF_BATCHES["p39"], 5)
             for w in POOL_WINDOWS}
    cases[f"wide_w{W['w']}"] = _pool_case_times(sp, W["B"], W["L"], W["C"],
                                                W["w"], 2, HALF_BATCHES["p39"],
                                                5)
    for case, rows in cases.items():
        log(f"time pool {case}: " + "; ".join(
            f"{n} {r['ms']:.4f} (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f})"
            for n, r in rows.items()))

    S = SCAN_MAIN
    scan = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = scan_inputs(392, S["B"], S["L"], S["D"], S["N"], dtype)
        el = dtype.itemsize
        B, L, D, N = S["B"], S["L"], S["D"], S["N"]
        nbytes = (el * (2 * B * L * D * N + B * L * N + B * L * D)
                  + 4 * 2 * B * D * N)
        bms, by = bound_ms(nbytes, 4 * B * L * D * N, torch.float32)
        t = dict(ms=card_ms(lambda: ss.ssm_scan(*args),
                            batches=HALF_BATCHES["p39"], inner=5),
                 plain_ms=card_ms(lambda: ss.ssm_scan_plain(*args),
                                  batches=HALF_BATCHES["p39"], inner=5),
                 library_ms=None, bound_ms=bms, bound_by=by, bytes=nbytes,
                 ops=4 * B * L * D * N)
        if dtype == torch.float32:
            def assoc(abar, bx, c, h0):
                h_all, h_last = mamba._assoc_scan(abar, bx, h0)
                y = torch.bmm(h_all.reshape(B * L, D, N),
                              c.reshape(B * L, N, 1)).reshape(B, L, D)
                return y, h_last

            yw, hw = ss.ssm_scan_plain(*args)
            ya, ha = assoc(*args)
            close(ya, yw, TOL, "assoc scan y")
            close(ha, hw, TOL, "assoc scan h_last")
            del yw, hw, ya, ha
            t["assoc_scan_ms"] = card_ms(lambda: assoc(*args),
                                         batches=HALF_BATCHES["p39"], inner=5)
        scan[str(dtype).removeprefix("torch.")] = t
        del args
        torch.cuda.empty_cache()
    log(f"time ssm_scan {S}: {json.dumps(scan)}")

    main_w = {"sliding_pool_max_shift": 16}
    sources = {"sum_pool_bwd": 142, "max_pool_bwd": 180}
    rows = []
    for name in [n for n, _, _ in POOL_FORMS] + ["sum_pool_bwd",
                                                 "max_pool_bwd"]:
        main = f"paper_w{main_w.get(name, 64)}"
        m = cases[main][name]
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/sliding_pool.cu",
            replaces=f"src/repro/kernels/sliding_pool.py:"
                     f"{sources.get(name, 87)}",
            launches=launches[name], max_abs_err=errs[name],
            **{k: m[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
            per=f"launch: {main} (1, 16384, 32) f32",
            shapes={c: {k: r[name][k] for k in ("ms", "plain_ms",
                                                "library_ms", "bound_ms")}
                    for c, r in cases.items() if c != main}))
    f32 = scan["float32"]
    rows.append(dict(
        name="ssm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:61",
        launches=launches["ssm_scan"], max_abs_err=errs["ssm_scan"],
        **{k: f32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "assoc_scan_ms")},
        per="launch: jamba prefill chunk (4, 256, 16384, 16) f32, random "
            "h0; library: none (no PyTorch call computes the scan); "
            "assoc_scan_ms: the port's mamba._assoc_scan + read-out",
        shapes={"bfloat16": scan["bfloat16"]}))
    return rows


# the redesigned rows' times with the kernels they replaced, measured by
# this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6 names the
# runs; rows 7 and 8 from the runs that first timed them; row 1 in bf16 by
# scripts/conv1d_times.py on the tree before its redesign)
EARLIER_MS = {
    # rows 3 and 15 a thread a 16-row walk of 16 bytes of channels, at
    # phase 19's prefill shape and (row 3) phase 23's training shape
    "conv1d_depthwise": {"prefill": 0.0574, "train_no_z": 0.0575,
                         "train_z": 0.0641},
    "conv1d_depthwise_quant": {"prefill": 0.1073},
    # row 11 a thread a 32-row walk of 16 bytes of channels, its split of
    # the row tiles from the card, at phase 23's training shape (bf16, db)
    "conv1d_depthwise_bwd_dw": {"train": 0.0800},
    # row 1 on its 64 x 64 CUDA-core tile at phase 6's shapes (bias + gelu)
    "sliding_conv1d": {"conv1": 0.0638, "conv2": 0.4253,
                       "conv1_bf16": 0.0637, "conv2_bf16": 0.5375},
    # row 13 (the 1-D int8 conv, w8a8) on its __dp4a CUDA-core tiles and
    # row 10 on its KT x 4 x 4 CUDA-core tiles, at phase 15's and phase
    # 10's shapes
    "sliding_conv_quant": {"conv1": 0.0310, "conv2": 0.1642},
    "conv1d_bwd_dw": {"conv1": 0.0697, "conv2": 0.2617},
    # row 6 on gemm_tile.cuh at phase 35's 1-D shapes
    "im2col_conv1d": {"conv1d_K3": 0.0135, "conv1d_K17": 0.0531,
                      "conv1d_K65": 0.1880, "whisper_conv1": 0.0468,
                      "whisper_conv2": 0.2875},
    "attention_decode": {"whisper": 0.0242, "jamba": 0.0524,
                         "llava": 0.3325},
    "attention_decode_int8": {"whisper": 0.0198, "jamba": 0.0444,
                              "llava": 0.2754},
    "max_pool_bwd": {"paper_w4": 0.0742, "paper_w16": 0.1320,
                     "paper_w64": 0.3113, "paper_w256": 0.9754,
                     "wide_w16": 5.4306},
    # row 5 on the hbm columns, row 12 at phase 32's shapes
    "matmul": {"fig1_k31": 3.0528, "fig1_k3": 0.0325, "conv1d_K65": 0.2075,
               "patch_embed_bf16": 0.5933, "patch_embed_f32": 0.5930},
    "conv2d_bwd_dw": {"patch_embed": 1.3744, "patch_embed_f32": 1.4075,
                      "fig1_k3_f32": 0.0539, "fig1_k31_f32": 1.7963,
                      "fig2_k17_f32": 0.4667},
    # rows 4 and 14 on their CUDA-core tiles, at phase 27's and phase 32's
    # shapes
    "conv2d": {"patch_embed": 1.2553, "patch_embed_f32": 1.1914,
               "fig1_k3_f32": 0.0628, "fig1_k5_f32": 0.1526,
               "fig1_k17_f32": 1.6148, "fig1_k31_f32": 5.4151},
    "conv2d_quant": {"patch_embed": 0.6467, "patch_embed_chained": 0.6495,
                     "patch_embed_w8a16": 1.3017, "fig1_k3": 0.0401,
                     "fig1_k31": 2.8601, "fig2_k3": 0.0347,
                     "fig2_k17": 0.9205},
    # row 7 on gemm_tile.cuh at phase 35's 2-D shapes
    "im2col_conv2d": {"fig1_k31": 2.7651, "fig1_k3": 0.0319,
                      "fig1_k5": 0.0777, "fig1_k17": 0.8362,
                      "fig2_k3": 0.0308, "fig2_k17": 0.6302,
                      "patch_embed_bf16": 0.6164, "patch_embed_f32": 0.6178},
    # row 8 a thread a (batch, tile, channel), at phase 39's shapes
    "sliding_pool_sum": {"paper_w4": 0.0095, "paper_w64": 0.0123,
                         "paper_w256": 0.0329, "wide_w16": 0.4768},
    "sliding_pool_avg": {"paper_w64": 0.0186, "wide_w16": 0.7368},
    "sliding_pool_max_scan": {"paper_w64": 0.0280, "wide_w16": 1.2393},
    "sliding_pool_max_shift": {"paper_w16": 0.0237, "paper_w256": 0.0878,
                               "wide_w16": 0.9268},
    "sum_pool_bwd": {"paper_w64": 0.0123, "wide_w16": 0.4693},
}
# rows 2 and 2b at the three decode shapes: (shape, the lengths of the
# request's middle decode step)
ATTN_TIMED = {"whisper": (ATTN_MAIN, 256), "jamba": (ATTN_JAMBA, 272),
              "llava": (ATTN_LLAVA, 3152)}


def phase_attention_f32_times(ad) -> dict:
    """40: row 2 over a float32 cache (float32 q) at the three decode
    shapes of ``ATTN_TIMED``, beside its plain version, SDPA in float32
    (``enable_gqa`` where G > 1) and the bound; caches cycled past the L2,
    timed as in phase 6."""
    out = {}
    for name, (shape, ln0) in ATTN_TIMED.items():
        B, S, KV, G, D = (shape[n] for n in ("B", "S", "KV", "G", "D"))
        lens = [ln0] * B
        n_sets = max(2, -(-64 * 2 ** 20 // (8 * B * S * KV * D)))
        sets = []
        for i in range(n_sets):
            q, k, v, ln = attn_inputs(400 + i, **shape, dtype=torch.float32,
                                      lengths=lens)
            mask = (torch.arange(S, device=DEV)[None, :]
                    < ln[:, None])[:, None, None, :]
            sets.append((q, k, v, ln, mask))

        def library(q, k, v, ln, mask, B=B, KV=KV, G=G, D=D):
            return F.scaled_dot_product_attention(
                q.reshape(B, KV * G, 1, D), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=mask, enable_gqa=G > 1)

        want = ad.attention_decode_plain(*sets[0][:-1])
        close(library(*sets[0]).reshape(B, KV, G, D), want, TOL,
              f"library attention f32 {name}")
        err = close(ad.decode_attention(*sets[0][:-1]), want, TOL,
                    f"attention f32 {name}")
        nbytes = (4 * B * KV * G * D + 4 * 2 * sum(lens) * KV * D + 4 * B
                  + 4 * B * KV * G * D)
        a_ops = 4 * G * D * KV * sum(lens)
        bms, by = bound_ms(nbytes, a_ops, torch.float32)
        out[name] = dict(timings(
            cycling(lambda *a: ad.decode_attention(*a[:-1]), sets),
            cycling(lambda *a: ad.attention_decode_plain(*a[:-1]), sets),
            cycling(library, sets), HALF_BATCHES["p40"]),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=a_ops,
            max_abs_err=err,
            per=f"launch: B={B} S={S} KV={KV} G={G} D={D}, f32 q, f32 "
                f"cache, lengths {ln0}; library: SDPA f32")
        log(f"time attention f32 cache {name} {shape} lengths {ln0}: "
            f"{json.dumps(out[name])}")
        del sets
        torch.cuda.empty_cache()
    return out


def report_redesigned(kernels) -> None:
    """Each redesigned row's time in this run beside its earlier one
    (``EARLIER_MS``), the library call's and the bound, one line a shape.
    The earlier times go to the log only: the kernels' JSON line holds
    what this run measured."""
    main_shape = {"max_pool_bwd": "paper_w64", "matmul": "fig1_k31",
                  "conv2d_bwd_dw": "patch_embed", "conv2d": "patch_embed",
                  "conv2d_quant": "patch_embed", "im2col_conv2d": "fig1_k31",
                  "im2col_conv1d": "conv1d_K65",
                  "sliding_pool_sum": "paper_w64",
                  "sliding_pool_avg": "paper_w64",
                  "sliding_pool_max_scan": "paper_w64",
                  "sliding_pool_max_shift": "paper_w16",
                  "sum_pool_bwd": "paper_w64"}
    for row in kernels:
        before = EARLIER_MS.get(row["name"])
        if before is None:
            continue
        if row["name"] in main_shape:
            now = {main_shape[row["name"]]: row,
                   **{k: row["shapes"][k] for k in before
                      if k != main_shape[row["name"]]}}
        elif "shapes" in row:  # row 1: the row sums its shapes
            now = {k: row["shapes"][k] for k in before}
        elif "by_shape" in row:  # rows 13 and 10, the same
            now = {k: row["by_shape"][k] for k in before}
        elif row["name"] == "conv1d_depthwise_bwd_dw":  # row 11
            now = {"train": row}
        elif row["name"].startswith("conv1d_depthwise"):  # rows 3 and 15
            now = {"prefill": row}
            if "train_shape" in row:
                t = row["train_shape"]
                now["train_no_z"] = dict(ms=t["no_z_ms"],
                                         library_ms=t.get("library_ms"),
                                         bound_ms=t["bound_ms"])
                now["train_z"] = dict(ms=t["z_ms"], bound_ms=t["z_bound_ms"])
        else:
            now = {"whisper": row, "jamba": row["jamba_shape"],
                   "llava": row["llava_shape"]}
        for shape, t in now.items():
            # row 5's other shapes keep the comparison's key names
            ms, lib, bound = (t.get(k, t.get("matmul_" + k)) for k in
                              ("ms", "library_ms", "bound_ms"))
            lib = "not timed" if lib is None else f"{lib:.4f}"
            log(f"redesigned {row['name']} {shape}: {ms:.4f} ms (earlier "
                f"{before[shape]:.4f}, {before[shape] / ms:.2f}x), "
                f"library {lib}, bound {bound:.5f}")


# ---------------------------------------------------------------------------
# the remaining decoders: gemma-2b, llama3-8b, granite-8b, qwen3-moe, phi3.5-moe
# ---------------------------------------------------------------------------

MOE = "qwen3-moe-30b-a3b"
DECODERS = ("gemma-2b", "llama3-8b", "granite-8b", MOE, "phi3.5-moe-42b-a6.6b")
# phi3.5-moe whole is 83.7 GB in bf16: 24 of its 32 layers fit the card
DECODER_CUT = {"phi3.5-moe-42b-a6.6b": dict(num_layers=24)}
# exact parameter counts at the served depths (param_defs)
DECODER_PARAMS = {MOE: 30_532_122_624,
                  "phi3.5-moe-42b-a6.6b": 31_470_063_616,
                  "llama3-8b": 8_030_261_248,
                  "granite-8b": 8_053_362_688,
                  "gemma-2b": 2_506_172_416}
# row 2 at gemma-2b's serving shape (ATTN_GEMMA: one KV head of D 256 for 8
# queries), rows 2 and 2b at qwen3-moe's (ATTN_QWEN_MOE) and row 2 at the
# shape of llama3-8b, granite-8b and phi3.5-moe (ATTN_GQA4: 8 KV heads of 4
# queries) come from analysis.contracts
# cache lengths a request of P 256 and 32 tokens gives its decode steps
DECODER_LENS = [257, 266, 279, 287]


def phase_attention_decoder_kernels(ad) -> dict:
    """44: rows 2 (bf16 q and cache) and 2b (int8 cache, bf16 q) against
    their plain versions at the decoders' serving shapes, as jamba's shape
    is held; row 2 at gemma's shape is held where it is timed."""
    errs = {}
    for key, shape, seed in (("qwen3_moe", ATTN_QWEN_MOE, 520),
                             ("gqa4", ATTN_GQA4, 530)):
        q, k, v, ln = attn_inputs(seed, **shape, dtype=torch.bfloat16,
                                  lengths=DECODER_LENS)
        errs[f"attention_decode_{key}"] = close(
            ad.decode_attention(q, k, v, ln),
            ad.attention_decode_plain(q, k, v, ln), BTOL,
            f"attention bf16 {key} shape")
    args = attn_int8_inputs(540, **ATTN_QWEN_MOE, q_dtype=torch.bfloat16,
                            lengths=DECODER_LENS)
    errs["attention_decode_int8_qwen3_moe"] = close(
        ad.decode_attention(*args), ad.attention_decode_plain(*args), TOL,
        "attention int8 qwen3_moe shape")
    log(f"attention at the decoders' shapes, lengths {DECODER_LENS}: "
        f"qwen3-moe {ATTN_QWEN_MOE} bf16 max|err| "
        f"{errs['attention_decode_qwen3_moe']:.3e}, int8 max|err| "
        f"{errs['attention_decode_int8_qwen3_moe']:.3e}; {ATTN_GQA4} bf16 "
        f"max|err| {errs['attention_decode_gqa4']:.3e}")
    torch.cuda.synchronize()
    return errs


def phase_smoke_serve_decoders(serve, models, configs, map_tree) -> None:
    """44: each decoder's smoke config (float32), one set of weights on the
    CPU and on the card: equal greedy tokens, prefill logits within TOL,
    row 2 once a layer a decode step on the card."""
    for arch in DECODERS:
        cfg = configs.smoke_config(configs.get_config(arch))
        model = models.build_model(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(
            rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                         ).astype(np.int32))
        cache_len = SMOKE["P"] + SMOKE["gen"]
        out = {}
        for dev, params in (("cpu", cpu_params),
                            (DEV, map_tree(lambda t: t.to(DEV), cpu_params))):
            with torch.no_grad():
                logits, _ = serve.prefill_cache(model, params, prompts.to(dev),
                                                cache_len=cache_len)
            zero_launches()
            toks, _ = serve.generate(model, params, prompts.to(dev),
                                     gen_len=SMOKE["gen"], cache_len=cache_len)
            out[dev] = (logits.cpu(), toks.cpu(), read_launches())
        want = only(attention_decode=cfg.num_layers * (SMOKE["gen"] - 1))
        if out[DEV][2] != want:
            raise AssertionError(f"{arch} smoke card launches {out[DEV][2]}, "
                                 f"expected {want}")
        err = close(out[DEV][0], out["cpu"][0], TOL,
                    f"{arch} smoke prefill logits")
        if not torch.equal(out[DEV][1], out["cpu"][1]):
            raise AssertionError(f"{arch} smoke greedy tokens differ: card "
                                 f"{out[DEV][1].tolist()} vs CPU "
                                 f"{out['cpu'][1].tolist()}")
        log(f"{arch} smoke serve {SMOKE}: greedy tokens equal on card and "
            f"CPU {out[DEV][1].tolist()}; prefill logits max|err| {err:.3e}")


@contextlib.contextmanager
def counting_drops(moe_lib, cfg):
    """Yield a list that receives (copies, dropped) for each MoE layer run
    in the block: of the T*K expert copies the router makes, those past an
    expert's capacity (the first ``cap`` of each expert in token order keep
    their slot, as ``moe._ep_group`` places them)."""
    seen: list = []
    route = moe_lib._route

    def spy(xt, router, k):
        gates, ids, aux = route(xt, router, k)
        T, E = xt.shape[0], router.shape[1]
        cap = int(max(1, (T * k / E) * cfg.capacity_factor))
        per = torch.bincount(ids.reshape(-1), minlength=E)
        seen.append((T * k, int((per - cap).clamp(min=0).sum())))
        return gates, ids, aux

    moe_lib._route = spy
    try:
        yield seen
    finally:
        moe_lib._route = route


def _decoder_init(models, configs, arch, iter_leaves):
    """A decoder at its published widths (cut per ``DECODER_CUT``), bf16,
    drawn on the card in bounded draws (``sharding.MAX_DRAW``) and
    rescaled to std 1/sqrt(input width); its exact parameter count
    checked."""
    from repro_torch.distributed.sharding import MAX_DRAW

    cfg = configs.get_config(arch).replace(**DECODER_CUT.get(arch, {}),
                                           attn_decode="fused")
    model = models.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    if n_params != DECODER_PARAMS[arch]:
        raise AssertionError(f"{arch}: {n_params} params, expected "
                             f"{DECODER_PARAMS[arch]}")
    cut = f" cut to {DECODER_CUT[arch]}" if arch in DECODER_CUT else ""
    experts = (f", {cfg.num_experts} experts top-{cfg.experts_per_token}"
               if cfg.num_experts else "")
    log(f"full width {arch}{cut}: {n_params} params ({cfg.param_dtype}), "
        f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads "
        f"over {cfg.num_kv_heads} of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}{experts}, vocab {cfg.vocab_size}; init in draws of <= "
        f"{MAX_DRAW} float32 "
        f"elements, rescaled to std 1/sqrt(input width): {init_s:.2f}s, peak "
        f"{init_peak:.2f} GB")
    return model, params, dict(n_params=n_params, init_s=init_s,
                               init_peak_mem_gb=init_peak)


def _decoder_prompts(cfg):
    rng = np.random.default_rng(0)
    return torch.as_tensor(
        rng.integers(2, cfg.vocab_size, size=(SERVE["B"], SERVE["P"])),
        dtype=torch.int32, device=DEV)


def phase_full_serve_moe(serve, models, configs, iter_leaves, moe_lib) -> dict:
    """45: qwen3-moe-30b-a3b at full width and depth, one request fp, the
    kernels against their plain versions on one decode step, the experts'
    capacity drops in a prefill and a decode step, then the same request
    with an int8 cache on the same weights."""
    model, params, res = _decoder_init(models, configs, MOE, iter_leaves)
    cfg = model.cfg
    prompts = _decoder_prompts(cfg)
    gen, steps = SERVE["gen"], cfg.num_layers * (SERVE["gen"] - 1)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    fp = _serve_request(serve, model, params, prompts, gen,
                        only(attention_decode=steps), f"{MOE} full-width fp")
    cache_len = fp["cache_len"]
    with torch.no_grad():
        with counting_drops(moe_lib, cfg) as pre:
            _, cache = serve.prefill_cache(model, params, prompts,
                                           cache_len=cache_len)
        tok = torch.full((SERVE["B"], 1), 2, dtype=torch.int32, device=DEV)
        with counting_drops(moe_lib, cfg) as dec:
            step, _ = model.decode_step(params, cache, tok, SERVE["P"])
        with plain_kernels():
            plain, _ = model.decode_step(params, cache, tok, SERVE["P"])
    del cache
    rel = ((step - plain).abs().max() / plain.abs().max()).item()
    agree = (step.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{MOE} full width, kernels vs plain versions on the card: decode-"
        f"step logits max |diff| {rel:.3e} of max, argmax agreement "
        f"{agree:.2f}")
    drops = {name: dict(copies=sum(c for c, _ in seen),
                        dropped=sum(d for _, d in seen), layers=len(seen))
             for name, seen in (("prefill", pre), ("decode_step", dec))}
    for name, d in drops.items():
        if d["layers"] != cfg.num_layers:
            raise AssertionError(f"{MOE} {name}: {d['layers']} MoE layers")
        log(f"{MOE} {name}: the capacity dropped {d['dropped']} of "
            f"{d['copies']} expert copies over {d['layers']} layers "
            f"({100 * d['dropped'] / d['copies']:.2f}%)")
    model8 = models.build_model(cfg.replace(kv_quant="int8"))
    int8 = _serve_request(serve, model8, params, prompts, gen,
                          only(attention_decode_int8=steps),
                          f"{MOE} full-width int8 cache")
    int8["kv_cache_bytes_fp"] = fp["kv_cache_bytes"]
    for what, r in (("fp", fp), ("int8", int8)):
        if r["peak_mem_gb"] >= total:
            raise AssertionError(f"{MOE} {what} peak {r['peak_mem_gb']:.2f} "
                                 f"GB of the card's {total:.2f} GB")
    log(f"{MOE} int8 kv-cache bytes {int8['kv_cache_bytes']} (fp "
        f"{fp['kv_cache_bytes']}, ratio "
        f"{fp['kv_cache_bytes'] / int8['kv_cache_bytes']:.2f}x); card memory "
        f"{total:.2f} GB")
    res.update(fp=fp, int8=int8, drops=drops, plain_rel_diff=rel,
               plain_argmax_agreement=agree)
    return res


def phase_full_serve_decoders(serve, models, configs, iter_leaves) -> dict:
    """46: the other four decoders at full width, one after another, one fp
    request each; each model freed before the next is drawn."""
    out = {}
    for arch in DECODERS:
        if arch == MOE:
            continue
        model, params, res = _decoder_init(models, configs, arch, iter_leaves)
        cfg = model.cfg
        res.update(_serve_request(
            serve, model, params, _decoder_prompts(cfg), SERVE["gen"],
            only(attention_decode=cfg.num_layers * (SERVE["gen"] - 1)),
            f"{arch} full-width fp"))
        out[arch] = res
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_attention_gemma_times(ad) -> dict:
    """46: row 2 at gemma-2b's serving shape (``ATTN_GEMMA``, bf16 q and
    cache, the lengths of the request's middle decode step) beside its
    plain version, SDPA (``enable_gqa``) and the bound; caches cycled past
    the L2, timed as in phase 6."""
    B, S, KV, G, D = (ATTN_GEMMA[n] for n in ("B", "S", "KV", "G", "D"))
    lens = [272] * B
    n_sets = max(2, -(-64 * 2 ** 20 // (4 * B * S * KV * D)))
    sets = []
    for i in range(n_sets):
        q, k, v, ln = attn_inputs(500 + i, **ATTN_GEMMA, dtype=torch.bfloat16,
                                  lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :]
                < ln[:, None])[:, None, None, :]
        sets.append((q, k, v, ln, mask))

    def library(q, k, v, ln, mask):
        return F.scaled_dot_product_attention(
            q.reshape(B, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    want = ad.attention_decode_plain(*sets[0][:-1])
    close(library(*sets[0]).float().reshape(B, KV, G, D), want, BTOL,
          "library attention gemma shape")
    err = close(ad.decode_attention(*sets[0][:-1]), want, BTOL,
                "attention gemma shape")
    nbytes = (2 * B * KV * G * D + 2 * 2 * sum(lens) * KV * D + 4 * B
              + 4 * B * KV * G * D)
    a_ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, a_ops, torch.bfloat16)
    out = dict(timings(
        cycling(lambda *a: ad.decode_attention(*a[:-1]), sets),
        cycling(lambda *a: ad.attention_decode_plain(*a[:-1]), sets),
        cycling(library, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=a_ops, max_abs_err=err,
        per=f"launch: B={B} S={S} KV={KV} G={G} D={D}, bf16 q, bf16 cache, "
            f"lengths {lens[0]}; library: SDPA bf16, enable_gqa")
    log(f"time attention_decode gemma {ATTN_GEMMA} lengths {lens[0]}: "
        f"{json.dumps(out)}")
    del sets
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 47: the tuning layer
# ---------------------------------------------------------------------------

# the tuning shapes (TUNE_FIGS, TUNE_CONV1D, TUNE_POOL_WINDOWS,
# TUNE_ATTN_INT8, from analysis.contracts): the reference benchmark's
# autotune rows (``benchmarks/run.py`` ``autotune_rows``, its quick lists)
# at the tables' full sizes: conv2d at fig1 k 3, 9, 31 and fig2 k 3, 17;
# conv1d (1, 16384, 32) K 3, 33, fp and w8a8; max pooling there at w 4,
# 256; the int8 decode read at qwen3's smoke cache


def _plan_fields(p) -> dict:
    """A launched plan's tunable fields, named as a tuning-cache entry
    names them."""
    from repro_torch.kernels import gemm_plan

    if isinstance(p, gemm_plan.GemmPlan):
        return {"tile": p.tile.name, "splits": p.splits}
    if isinstance(p, gemm_plan.DepthwisePlan):
        return {"rows": p.rows, "stages": p.stages}
    if isinstance(p, gemm_plan.DepthwiseDwPlan):
        return {"bwd_rows": p.rows, "bwd_stages": p.stages,
                "bwd_splits": p.splits}
    return {"split_rows": p[1]}  # decode attention's (splits, rows)


@contextlib.contextmanager
def keeping(mod, name, calls):
    """Route ``mod.name`` through a wrapper that appends (args, kwargs,
    result) of each call to ``calls``. The launch code counts on the
    module's name, so the wrapper carries the launch counter and
    ``last_plan`` while it stands, and hands them back after."""
    real = getattr(mod, name)
    attrs = ("launches", "last_plan")

    def keep(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    for attr in attrs:
        setattr(keep, attr, getattr(real, attr))
    setattr(mod, name, keep)
    try:
        yield
    finally:
        setattr(mod, name, real)
        for attr in attrs:
            setattr(real, attr, getattr(keep, attr))


def phase_tuning(autotune, ops, sc, s2, sq, sb, ad, sp
                 ) -> tuple[dict, dict, Path]:
    """47. Tune each shape into a fresh cache (``REPRO_TORCH_AUTOTUNE_CACHE``
    pointed at a temporary file, restored after), then drive the entry
    through ``ops`` with the cache armed: the launch must run the
    recorded plan (the wrapper's ``last_plan``; row 8's form counter),
    the output must match its plain version at the row's tolerance, and
    the tuned and untuned dispatch are timed (``card_ms``). Then the quant
    guard at each conv1d shape. The searches rank and prune as
    ``kernels/autotune.py`` does by default. Returns ({key: times and
    winner}, the launches of the checking calls, the cache file, kept for
    phase 52, which removes it)."""
    from repro_torch.quant.apply import quantize_depthwise_weight

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    saved_env = os.environ.get(autotune.ENV_CACHE)
    armed = str(tmp / "autotune_cuda.json")
    tuned, launches = {}, only()

    @contextlib.contextmanager
    def cache_off():
        os.environ[autotune.ENV_CACHE] = str(tmp / "absent.json")
        autotune.invalidate()
        try:
            yield
        finally:
            os.environ[autotune.ENV_CACHE] = armed
            autotune.invalidate()

    def case(res, run, check, launched, spied=None):
        """One tuned key: its line, the armed call's plan and hold, and
        the tuned and untuned dispatch's card times."""
        best = {k: v for k, v in res.best.items()
                if k not in ("us", "default_us", "dispatch_us")}
        log(f"tuned {res.key}: default_us {res.best['default_us']} us "
            f"{res.best['us']} winner {best} timed {res.timed}")
        if res.best["us"] > res.best["default_us"]:
            raise AssertionError(f"{res.key}: us above default_us")
        if autotune.lookup(res.key) != res.best:
            raise AssertionError(f"{res.key}: the cache does not hold the "
                                 "winner")
        calls = []
        zero_launches()
        for fn in (sc.conv1d_sliding, sc.conv1d_depthwise, s2.conv2d_sliding,
                   sq.conv1d_quant, sq.conv2d_quant,
                   sq.conv1d_depthwise_quant, sb.conv1d_bwd_dw,
                   sb.conv1d_depthwise_bwd_dw, sb.conv2d_bwd_dw,
                   ad.decode_attention):
            fn.last_plan = None
        with (keeping(*spied, calls) if spied else contextlib.nullcontext()):
            out = run()
        torch.cuda.synchronize()
        counts = read_launches()
        for k, n in counts.items():
            launches[k] += n
        ran = launched()
        for k, v in ran.items():
            if best.get(k) != v:
                raise AssertionError(f"{res.key}: launched {ran}, the cache "
                                     f"holds {best}")
        err = check(out, calls)
        t_tuned = card_ms(run, batches=10)
        with cache_off():
            t_untuned = card_ms(run, batches=10)
        log(f"tuned {res.key}: launched {ran}, max|err| {err:.3e}; dispatch "
            f"tuned {t_tuned:.4f} ms, untuned {t_untuned:.4f} ms")
        tuned[res.key] = dict(default_us=res.best["default_us"],
                              us=res.best["us"],
                              dispatch_us=res.best.get("dispatch_us"),
                              winner=best,
                              timed=res.timed, tuned_ms=t_tuned,
                              untuned_ms=t_untuned, max_abs_err=err)

    def grad_check(plain, K, what):
        """Hold the weight-gradient kernel's own f32 output on its own
        inputs (the call's spied arguments) against its plain version."""
        def check(_, calls):
            (x, dz, _k), kw, (dw, db) = calls[-1]
            want = plain(x, dz, K, stride=kw["stride"],
                         has_bias=kw["has_bias"])
            err = close(dw, want[0], TOL, what, scaled=True)
            if db is not None:
                err = max(err, close(db, want[1], TOL, what + " db",
                                     scaled=True))
            return err
        return check

    os.environ[autotune.ENV_CACHE] = armed
    autotune.invalidate()
    t0 = time.perf_counter()
    try:
        # (a) the reference benchmark's autotune rows
        for name, H, ks in TUNE_FIGS:
            for k in ks:
                x, w, _ = conv2d_inputs(600 + k, 1, H, H, 32, 32, k,
                                        torch.float32, with_bias=False)
                case(autotune.autotune_conv2d(x, w),
                     lambda x=x, w=w: ops.conv2d(x, w, backend="sliding"),
                     lambda y, _, x=x, w=w, n=f"{name} k{k}": close(
                         y, s2.conv2d_sliding_plain(x, w), TOL,
                         f"tuned conv2d {n}"),
                     lambda: _plan_fields(s2.conv2d_sliding.last_plan))
        B, L, C = (TUNE_CONV1D[n] for n in ("B", "L", "C"))
        guard = {}
        for K in TUNE_CONV1D["Ks"]:
            x, w, _ = conv_inputs(620 + K, B, L, C, C, K, torch.float32,
                                  with_bias=False)
            rf = autotune.autotune_conv1d(x, w)
            case(rf, lambda x=x, w=w: ops.conv1d(x, w),
                 lambda y, _, x=x, w=w: close(
                     y, sc.conv1d_sliding_plain(x, w), TOL,
                     f"tuned conv1d K{K}"),
                 lambda: _plan_fields(sc.conv1d_sliding.last_plan))
            rq = autotune.autotune_conv1d(x, w, precision="w8a8")
            xq, wq, ws, xs, _ = ops._quant_operands(x, w, None, None, "w8a8")
            case(rq,  # int8 input: pinned to the quant kernel
                 lambda xq=xq, wq=wq, ws=ws, xs=xs: ops.conv1d(
                     xq, wq, precision="w8a8", w_scale=ws, x_scale=xs),
                 lambda y, _, xq=xq, wq=wq, ws=ws, xs=xs: close(
                     y, sq.conv1d_quant_plain(xq, wq, ws, x_scale=xs,
                                              mode="w8a8"),
                     TIGHT, f"tuned conv1d w8a8 K{K}"),
                 lambda: _plan_fields(sq.conv1d_quant.last_plan))
            # the quant guard: a float-input w8a8 call serves the winner,
            # its dispatch (x quantized, scales read back) against fp's
            fp_won = rq.best["dispatch_us"] > rf.best["us"]
            ev = ("conv1d.w8a8", "quant_slower", "fallback:fp")
            before = sum(e.count for e in ops.HEALTH.events
                         if (e.site, e.reason, e.action) == ev)
            zero_launches()
            y = ops.conv1d(x, w, precision="w8a8")
            torch.cuda.synchronize()
            counts = read_launches()
            after = sum(e.count for e in ops.HEALTH.events
                        if (e.site, e.reason, e.action) == ev)
            want = (only(sliding_conv1d=1) if fp_won
                    else only(sliding_conv_quant=1))
            if counts != want or after - before != int(fp_won):
                raise AssertionError(
                    f"quant guard K{K}: {'fp' if fp_won else 'w8a8'} won "
                    f"(us {rf.best['us']} fp, dispatch_us "
                    f"{rq.best['dispatch_us']} w8a8) but the "
                    f"call launched {counts}, {after - before} quant_slower "
                    "event(s)")
            for k, n in counts.items():
                launches[k] += n
            if fp_won:
                close(y, sc.conv1d_sliding_plain(x, w), TOL,
                      f"quant guard K{K} (fp)")
                # the quant path the guard passed over, pinned by its plan
                zero_launches()
                y = ops.conv1d(x, w, precision="w8a8",
                               plan={f: rq.best[f] for f in ("tile",
                                                             "splits")})
                torch.cuda.synchronize()
                pinned = read_launches()
                if pinned != only(sliding_conv_quant=1):
                    raise AssertionError(f"quant guard K{K}: the pinned "
                                         f"w8a8 call launched {pinned}")
                for k, n in pinned.items():
                    launches[k] += n
            # the float-input w8a8 call: x quantized on its dynamic absmax
            # scale, then row 13
            close(y, sq.conv1d_quant_plain(xq, wq, ws, x_scale=xs,
                                           mode="w8a8"),
                  TIGHT, f"quant guard K{K} (w8a8, float input)")
            guard[rq.key] = "fp" if fp_won else "w8a8"
            log(f"quant guard {rq.key}: {guard[rq.key]} won (fp "
                f"{rf.best['us']} us, w8a8 kernel {rq.best['us']} us, "
                f"dispatch {rq.best['dispatch_us']} us); the "
                f"float-input w8a8 call launched "
                f"{ {k: n for k, n in counts.items() if n} }")
        for win in TUNE_POOL_WINDOWS:
            x = pool_input(640 + win, B, L, C, torch.float32)
            case(autotune.autotune_pool1d(x, window=win, op="max"),
                 lambda x=x, win=win: ops.pool1d(x, window=win, op="max"),
                 lambda y, _, x=x, win=win: close(
                     y, sp.sliding_pool_plain(x, window=win, op="max"),
                     dict(rtol=0.0, atol=0.0), f"tuned pool max w{win}"),
                 lambda: {"method": "scan" if sp.sliding_pool.launches_max_scan
                          else "shift"})

        def attn_case(seed, s, lens, dtype, int8):
            Ba, S, KV, G, D = (s[n] for n in ("B", "S", "KV", "G", "D"))
            if int8:
                q, k, v, ln, ks, vs = attn_int8_inputs(seed, **s,
                                                       q_dtype=dtype,
                                                       lengths=lens)
            else:
                (q, k, v, ln), ks, vs = attn_inputs(
                    seed, **s, dtype=dtype, lengths=lens), None, None
            q3 = q.reshape(Ba, KV * G, D)
            case(autotune.autotune_attention_decode(
                     q3, k, v, lengths=ln, k_scale=ks, v_scale=vs),
                 lambda: ops.attention_decode(q3, k, v, lengths=ln,
                                              k_scale=ks, v_scale=vs),
                 lambda y, _: close(
                     y, ad.attention_decode_plain(q, k, v, ln, ks, vs)
                     .reshape(Ba, KV * G, D), TOL if int8 else BTOL,
                     f"tuned attention {s} {'int8' if int8 else dtype}"),
                 lambda: _plan_fields(ad.decode_attention.last_plan))

        S = TUNE_ATTN_INT8["S"]
        attn_case(650, TUNE_ATTN_INT8, [S, 3 * S // 4 + 1], torch.float32,
                  True)
        # (b) the model paths' shapes (PERF.md section 6)
        for name in ("conv1", "conv2"):
            s = CONV_MAIN[name]
            x, w, b = conv_inputs(660, s["B"], s["L"], s["Cin"], s["Cout"],
                                  s["K"], torch.bfloat16)
            args = dict(stride=s["stride"], bias=b, activation="gelu")
            case(autotune.autotune_conv1d(x, w, **args),
                 lambda x=x, w=w, args=args: ops.conv1d(x, w, **args),
                 lambda y, _, x=x, w=w, args=args, name=name: close(
                     y, sc.conv1d_sliding_plain(
                         x, w, args["bias"], stride=args["stride"],
                         activation="gelu"), BTOL, f"tuned row 1 {name}"),
                 lambda: _plan_fields(sc.conv1d_sliding.last_plan))
        s = CONV_MAIN["conv2"]
        for dtype in (torch.bfloat16, torch.float32):
            x, w, _ = conv_inputs(670, s["B"], s["L"], s["Cin"], s["Cout"],
                                  s["K"], dtype, with_bias=False)
            xg, wg = x.requires_grad_(), w.detach().requires_grad_()
            dy = torch.randn((s["B"], (s["L"] - s["K"]) // s["stride"] + 1,
                              s["Cout"]), device=DEV).to(dtype)

            def run10(xg=xg, wg=wg, dy=dy):
                y = ops.conv1d(xg, wg, stride=s["stride"])
                return torch.autograd.grad(y, (xg, wg), dy)

            case(autotune.autotune_conv1d_grad(xg, wg, stride=s["stride"]),
                 run10, grad_check(sb.conv1d_bwd_dw_plain, s["K"],
                                   f"tuned row 10 conv2 {dtype}"),
                 lambda: _plan_fields(sb.conv1d_bwd_dw.last_plan),
                 spied=(sb, "conv1d_bwd_dw"))
        s = DEPTHWISE_MAIN
        x, w, b = depthwise_inputs(680, s["B"], s["L"], s["C"], s["K"],
                                   torch.bfloat16)
        args = dict(padding="VALID", bias=b, activation="silu")
        case(autotune.autotune_conv1d_depthwise(
                 x, w, precision="fp", bias=b, activation="silu"),
             lambda: ops.conv1d_depthwise(x, w, **args),
             lambda y, _: dw_check(y, sc.conv1d_depthwise_plain(
                 x, w, b, activation="silu"), "tuned row 3 prefill"),
             lambda: _plan_fields(sc.conv1d_depthwise.last_plan))
        xq, wq, ws, xs, _ = ops._quant_operands(
            x, w, None, None, "w8a8", quantize_depthwise_weight)
        case(autotune.autotune_conv1d_depthwise(
                 x, w, precision="w8a8", bias=b, activation="silu"),
             lambda: ops.conv1d_depthwise(x, w, precision="w8a8", **args),
             lambda y, _: dw_check(y, sq.conv1d_depthwise_quant_plain(
                 xq, wq, ws, b, x_scale=xs, mode="w8a8", activation="silu",
                 out_dtype=torch.bfloat16), "tuned row 15 prefill"),
             lambda: _plan_fields(sq.conv1d_depthwise_quant.last_plan))
        s = DEPTHWISE_TRAIN
        x, w, b = depthwise_inputs(690, s["B"], s["L"], s["C"], s["K"],
                                   torch.bfloat16)
        xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))
        dy = torch.randn((s["B"], s["L"] - s["K"] + 1, s["C"]),
                         device=DEV).to(torch.bfloat16)

        def run11():
            y = ops.conv1d_depthwise(xg, wg, padding="VALID", bias=bg,
                                     activation="silu")
            return torch.autograd.grad(y, (xg, wg, bg), dy)

        case(autotune.autotune_conv1d_depthwise(
                 xg, wg, precision="fp", bias=bg, activation="silu"),
             run11, grad_check(sb.conv1d_depthwise_bwd_dw_plain, s["K"],
                               "tuned row 11 training"),
             lambda: {**_plan_fields(sc.conv1d_depthwise.last_plan),
                      **_plan_fields(sb.conv1d_depthwise_bwd_dw.last_plan)},
             spied=(sb, "conv1d_depthwise_bwd_dw"))
        for s, lens, seed in ((ATTN_QWEN_MOE, DECODER_LENS, 700),
                              (ATTN_LLAVA, [ATTN_LLAVA["S"] - 16] * 4, 710)):
            attn_case(seed, s, lens, torch.bfloat16, False)
            attn_case(seed + 1, s, lens, torch.bfloat16, True)
        p = PATCH_MAIN
        st = (p["stride"], p["stride"])
        x, w, b = conv2d_inputs(720, p["B"], p["H"], p["W"], p["Cin"],
                                p["Cout"], p["k"], torch.bfloat16)
        case(autotune.autotune_conv2d(x, w, stride=st, bias=b),
             lambda: ops.conv2d(x, w, stride=st, backend="sliding", bias=b),
             lambda y, _: bf16_step_close(y, s2.conv2d_sliding_plain(
                 x.float(), w.float(), b, stride=st), "tuned row 4 patch"),
             lambda: _plan_fields(s2.conv2d_sliding.last_plan))
        xq, wq, ws, xs, _ = ops._quant_operands(x, w, None, None, "w8a8")
        case(autotune.autotune_conv2d(x, w, stride=st, bias=b,
                                      precision="w8a8"),
             lambda: ops.conv2d(x, w, stride=st, backend="sliding", bias=b,
                                precision="w8a8"),
             lambda y, _: bf16_step_close(y, sq.conv2d_quant_plain(
                 xq, wq, ws, b, x_scale=xs, mode="w8a8", stride=st),
                 "tuned row 14 patch"),
             lambda: _plan_fields(sq.conv2d_quant.last_plan))
        wg = w.detach().requires_grad_()  # an image needs no gradient
        dy = torch.randn((p["B"], p["H"] // p["k"], p["W"] // p["k"],
                          p["Cout"]), device=DEV).to(torch.bfloat16)

        def run12():
            y = ops.conv2d(x, wg, stride=st, backend="sliding")
            return torch.autograd.grad(y, (wg,), dy)

        def check12(_, calls):
            (xa, dz, hw), kw, (dw, _db) = calls[-1]
            return close(dw, sb.conv2d_bwd_dw_plain(
                xa, dz, hw, stride=kw["stride"])[0], TOL,
                "tuned row 12 patch", scaled=True)

        case(autotune.autotune_conv2d_grad(x, wg, stride=st), run12, check12,
             lambda: _plan_fields(sb.conv2d_bwd_dw.last_plan),
             spied=(sb, "conv2d_bwd_dw"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        if saved_env is None:
            os.environ.pop(autotune.ENV_CACHE, None)
        else:
            os.environ[autotune.ENV_CACHE] = saved_env
        autotune.invalidate()
    log(f"tuning: {len(tuned)} keys in {time.perf_counter() - t0:.1f}s; "
        f"quant guard {guard}; the checking calls launched "
        f"{ {k: n for k, n in launches.items() if n} }")
    return tuned, launches, Path(armed)


# ---------------------------------------------------------------------------
# 52: the analysis gate
# ---------------------------------------------------------------------------

# (c)'s keys: conv1d (1, 16384, 32) K 33 f32 (row 1), whisper's conv2 bf16
# (row 1), fig1 conv2d k 31 f32 (row 4), row 11 at jamba's training shape
# bf16, row 2 at llava's decode shape bf16
ANALYSIS_SLACK = 1.05  # the ranked winner's card time over the exhaustive's
ANALYSIS_FEWER = 3  # keys at which the ranked arm must time fewer plans
# (d)'s rungs on the card: the 2-D ones at fig1 k 31, the 1-D ones at the
# conv1d table's (1, 16384, 32) with K 31
BLOAT_CARD = {"conv2d": ((1, 128, 128, 32), (31, 31, 32, 32)),
              "conv1d": ((1, 16384, 32), (31, 32, 32))}
PLAN_META = ("us", "default_us", "dispatch_us")


def analysis_keys(autotune) -> list:
    """(name, search thunk) of (c)'s five keys, inputs made once."""
    x1, w1, _ = conv_inputs(800, 1, 16384, 32, 32, 33, torch.float32,
                            with_bias=False)
    s = CONV_MAIN["conv2"]
    x2, w2, b2 = conv_inputs(810, s["B"], s["L"], s["Cin"], s["Cout"],
                             s["K"], torch.bfloat16)
    x4, w4, _ = conv2d_inputs(820, 1, 128, 128, 32, 32, 31, torch.float32,
                              with_bias=False)
    t = DEPTHWISE_TRAIN
    x11, w11, b11 = (v.detach().requires_grad_() for v in depthwise_inputs(
        830, t["B"], t["L"], t["C"], t["K"], torch.bfloat16))
    a = ATTN_LLAVA
    q, k, v, ln = attn_inputs(840, **a, dtype=torch.bfloat16,
                              lengths=[a["S"] - 16] * a["B"])
    q3 = q.reshape(a["B"], a["KV"] * a["G"], a["D"])
    return [
        ("conv1d K33 f32", lambda: autotune.autotune_conv1d(x1, w1)),
        ("whisper conv2 bf16", lambda: autotune.autotune_conv1d(
            x2, w2, stride=s["stride"], bias=b2, activation="gelu")),
        ("fig1 conv2d k31 f32", lambda: autotune.autotune_conv2d(x4, w4)),
        ("row 11 jamba train bf16", lambda: autotune.autotune_conv1d_depthwise(
            x11, w11, precision="fp", bias=b11, activation="silu")),
        ("attention llava bf16", lambda: autotune.autotune_attention_decode(
            q3, k, v, lengths=ln)),
    ]


def analysis_search(autotune, costmodel, tmp: Path, peaks_file: Path
                    ) -> list[dict]:
    """(c): each key searched exhaustively (``cost=None``) and ranked into
    scratch caches, ``_time_fn`` wrapped to keep every candidate's time;
    the within-key Spearman ρ of the prediction against the exhaustive
    arm's times; both winners re-timed in turns (ex, ranked, ranked, ex)."""
    real_search, real_time = autotune._search, autotune._time_fn
    state, rec = {}, {}

    def search(key, run, candidates, default, contract=None, cost=None):
        r = {"run": run, "cost": cost, "times": []}
        rec.setdefault((state["arm"], key), []).append(r)
        state["rec"] = r

        def run_kept(cfg):
            state["cfg"] = cfg
            return run(cfg)
        return real_search(key, run_kept, candidates, default, contract,
                           cost if state["arm"] == "ranked" else None)

    def time_fn(fn, **kw):
        t = real_time(fn, **kw)
        state["rec"]["times"].append((dict(state["cfg"]), t))
        return t

    saved = {n: os.environ.get(n) for n in (autotune.ENV_CACHE,
                                             costmodel.ENV_PEAKS)}
    os.environ[costmodel.ENV_PEAKS] = str(peaks_file)
    autotune._search, autotune._time_fn = search, time_fn
    rows = []
    try:
        for name, tune in analysis_keys(autotune):
            res = {}
            for arm in ("exhaustive", "ranked"):
                state["arm"] = arm
                os.environ[autotune.ENV_CACHE] = str(tmp / f"{arm}.json")
                autotune.invalidate()
                res[arm] = tune()
            ex, rk = res["exhaustive"], res["ranked"]
            last = rec[("exhaustive", ex.key)][-1]
            cands = [c for c, _ in last["times"]]
            preds = [last["cost"](c) for c in cands]
            rho = costmodel.spearman(preds, [t for _, t in last["times"]])
            win = {a: {f: v for f, v in r.best.items() if f not in PLAN_META}
                   for a, r in res.items()}
            run = last["run"]
            times = {"exhaustive": [], "ranked": []}
            for arm in ("exhaustive", "ranked", "ranked", "exhaustive"):
                times[arm].append(card_ms(lambda: run(win[arm]), batches=10))
            ms = {a: statistics.mean(t) for a, t in times.items()}
            n_searches = len(rec[("exhaustive", ex.key)])
            row = dict(key=ex.key, name=name, plans=[
                           dict(plan=c, us=t * 1e6, pred_us=pr)
                           for (c, t), pr in zip(last["times"], preds)],
                       timed={"exhaustive": ex.timed, "ranked": rk.timed},
                       pruned={"exhaustive": ex.pruned, "ranked": rk.pruned},
                       cost_skipped=rk.cost_skipped, ranked=rk.ranked,
                       winners=win, same_winner=win["exhaustive"] ==
                       win["ranked"], retimed_ms=ms, spearman=rho,
                       searches=n_searches)
            log(f"analysis search {name} ({ex.key}): timed exhaustive "
                f"{ex.timed}, ranked {rk.timed} (cost_skipped "
                f"{rk.cost_skipped}, pruned {rk.pruned}); winners "
                f"{win['exhaustive']} / {win['ranked']}; re-timed "
                f"{ms['exhaustive']:.4f} / {ms['ranked']:.4f} ms; within-key "
                f"rho {rho:.3f} over {len(cands)} plans")
            if not rk.ranked:
                raise AssertionError(f"{name}: the ranked arm did not rank")
            if (not row["same_winner"]
                    and ms["ranked"] > ANALYSIS_SLACK * ms["exhaustive"]):
                raise AssertionError(
                    f"{name}: the ranked winner {win['ranked']} takes "
                    f"{ms['ranked']:.4f} ms, over {ANALYSIS_SLACK} x the "
                    f"exhaustive winner's {ms['exhaustive']:.4f} ms")
            rows.append(row)
    finally:
        autotune._search, autotune._time_fn = real_search, real_time
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        autotune.invalidate()
    fewer = sum(r["timed"]["ranked"] < r["timed"]["exhaustive"] for r in rows)
    if fewer < ANALYSIS_FEWER:
        raise AssertionError(f"the ranked arm timed fewer plans at {fewer} of "
                             f"{len(rows)} keys (need {ANALYSIS_FEWER})")
    return rows


def analysis_bloat(bloat) -> list[dict]:
    """(d): each registered plain rung on the card, after a warm-up call:
    the largest block the allocator hands it during one call, over its
    natural size max(largest input, output), held to the bloat lint's
    static verdict (the rung traced at its own shape) for every rung:
    both measure the largest tensor one step makes. The call's peak
    allocation beyond its inputs and its output
    (``torch.cuda.max_memory_allocated``) is reported beside it: it sums
    the temporaries alive at once, which the lint does not."""
    from torch.cuda import memory as cmem

    alpha = bloat.BLOAT_ALPHA
    g = torch.Generator(device=DEV).manual_seed(850)
    rows = []
    for name, make in {**bloat.GATE_RUNGS, **bloat.KNOWN_BLOATED}.items():
        fn, shapes = make()
        static = bloat.check_fn(fn, shapes, family="bloat", key=name,
                                alpha=alpha) is not None
        xs, ws = BLOAT_CARD["conv2d" if name.startswith("conv2d")
                            else "conv1d"]
        x = torch.randn(xs, generator=g, device=DEV)
        w = torch.randn(ws, generator=g, device=DEV) / math.prod(ws[:-1]) ** 0.5
        with torch.no_grad():
            fn(x, w)  # warm-up: library handles and their workspaces
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cmem._record_memory_history(enabled="all", context=None,
                                    max_entries=100_000)
        try:
            with torch.no_grad():
                y = fn(x, w)
            torch.cuda.synchronize()
            dev = torch.cuda.current_device()
            trace = cmem._snapshot()["device_traces"][dev]
        finally:
            cmem._record_memory_history(enabled=None)
        peak = torch.cuda.max_memory_allocated() - before
        largest = max(e["size"] for e in trace if e["action"] == "alloc")
        natural = max(x.nbytes, w.nbytes, y.nbytes)
        ratio, live = largest / natural, (peak - y.nbytes) / natural
        log(f"analysis bloat {name} at x {xs} w {ws}: largest block "
            f"{largest} B, {ratio:.2f}x the natural {natural} B (alpha "
            f"{alpha:g}), static verdict "
            f"{'bloated' if static else 'clean'}; peak {peak} B, "
            f"{live:.2f}x beyond its output")
        rows.append(dict(rung=name, x=list(xs), w=list(ws),
                         largest_bytes=largest, peak_bytes=peak,
                         natural_bytes=natural, ratio=ratio, live_ratio=live,
                         static_bloated=static))
        if (ratio > alpha) != static:
            raise AssertionError(
                f"bloat {name}: the card's largest block is {ratio:.2f}x "
                f"the natural size (alpha {alpha:g}), the static verdict "
                f"{'bloated' if static else 'clean'}")
        if static != (name in bloat.KNOWN_BLOATED):
            raise AssertionError(f"bloat {name}: static verdict "
                                 f"{'bloated' if static else 'clean'}")
        del x, w, y
    torch.cuda.empty_cache()
    return rows


def phase_analysis(autotune, tune_cache: Path) -> dict:
    """52. The analysis gate on the card, after phase 47 (whose cache it
    reads, then removes): (a) the card's peaks (``costmodel.probe_peaks``)
    beside the data sheet's; (b) the device's shared-memory opt-in equals
    ``gemm_plan.SMEM_BLOCK``, the contracts find no violation over the
    full-width key space at it, every launcher's query entry gives each
    instance's bytes and threads exactly, and the over-budget row-11 plan
    (rows 64, stages 4, f32, K 4) is flagged by the contract and refused
    by its plan function; (c) the ranked and exhaustive searches at five
    keys (``analysis_search``); (d) every plain rung's largest block on
    the card against the bloat lint's static verdict; (e) ``python -m
    repro_torch.analysis --all`` on (a)'s peaks and 47's cache must exit
    0 with a schema-2 report, at least one gated family, each gated ρ at
    least 0.7 and every shipped chain safe."""
    from repro_torch.analysis import bloat, contracts, costmodel
    from repro_torch.kernels import build, gemm_plan

    t0 = time.perf_counter()
    tmp = tune_cache.parent
    try:
        # (a)
        peaks_file = tmp / "peaks.json"
        pk = costmodel.probe_peaks(path=peaks_file)
        shares = {
            "float32": pk["float32_tflops"] * 1e12 / H100_PEAK_OPS["float32"],
            "bfloat16": (pk["bfloat16_tflops"] * 1e12
                         / H100_PEAK_OPS["bfloat16"]),
            "hbm": pk["hbm_gbps"] * 1e9 / H100_HBM_BYTES_S}
        log(f"analysis peaks ({pk['nvidia_smi']}): f32 matmul "
            f"{pk['float32_tflops']:.2f} TFLOP/s ({shares['float32']:.3f} of "
            f"the data sheet's), bf16 {pk['bfloat16_tflops']:.1f} TFLOP/s "
            f"({shares['bfloat16']:.3f}), copy {pk['hbm_gbps']:.1f} GB/s "
            f"({shares['hbm']:.3f})")
        # (b)
        budget = contracts.device_smem_budget()
        if budget != gemm_plan.SMEM_BLOCK:
            raise AssertionError(f"the card's opt-in is {budget} B, "
                                 f"gemm_plan.SMEM_BLOCK {gemm_plan.SMEM_BLOCK}")
        sms = build.sm_count(torch.device(DEV, 0))
        vio, cstats = contracts.check_all(budget=budget, sms=sms)
        if vio:
            raise AssertionError(f"{len(vio)} contract violation(s): "
                                 f"{vio[0].line()}")
        launchers: dict = {}
        for _, _, cand, inst in contracts.instances(sms=sms):
            got = contracts.launcher_query(inst)
            if got != (inst.smem, inst.threads):
                raise AssertionError(
                    f"{inst.key} {cand}: the launcher's query gives {got}, "
                    f"the contract ({inst.smem}, {inst.threads})")
            d = launchers.setdefault(inst.query[1], {
                "instances": 0, "smem_min": got[0], "smem_max": got[0],
                "threads": []})
            d["instances"] += 1
            d["smem_min"] = min(d["smem_min"], got[0])
            d["smem_max"] = max(d["smem_max"], got[0])
            if got[1] not in d["threads"]:
                d["threads"].append(got[1])
        over = contracts.check_autotune_candidate(
            "conv1d_depthwise_bwd_dw", dict(DEPTHWISE_TRAIN, dtype="float32",
                                            sms=sms),
            dict(bwd_rows=64, bwd_stages=4))
        if over is None or over.kind != "smem_budget":
            raise AssertionError(f"the over-budget row-11 plan: {over}")
        try:
            gemm_plan.depthwise_dw_plan(2, 512, 16384, 4, 4, 1, sms, rows=64,
                                        stages=4)
        except gemm_plan.PlanError:
            pass
        else:
            raise AssertionError("depthwise_dw_plan took the over-budget plan")
        log(f"analysis contracts: opt-in {budget} B; {cstats['instances']} "
            f"instances over {len(cstats['families'])} families, 0 "
            f"violations, every query equal; over-budget row 11: "
            f"{over.detail}")
        for sym, d in sorted(launchers.items()):
            log(f"analysis query {sym}: {d['instances']} plans, "
                f"{d['smem_min']}-{d['smem_max']} B, threads {d['threads']}")
        # (c)
        search = analysis_search(autotune, costmodel, tmp, peaks_file)
        # (d)
        bloat_rows = analysis_bloat(bloat)
        # (e)
        report = tmp / "analysis.json"
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--all", "--peaks",
             str(peaks_file), "--autotune-cache", str(tune_cache), "--json",
             str(report)],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for line in cli.stdout.splitlines():
            log(line)
        if cli.returncode != 0:
            raise AssertionError(f"the analysis CLI exited {cli.returncode}: "
                                 f"{cli.stderr[-2000:]}")
        rep = json.loads(report.read_text())
        fams = rep["stats"]["costmodel"]["validate"]["families"]
        gated = {f: d["spearman"] for f, d in fams.items() if d["gated"]}
        chains = {c: d["status"] for c, d in
                  rep["stats"]["ranges"]["chains"].items()}
        if (rep["schema"] != 2 or not gated
                or min(gated.values()) < costmodel.SPEARMAN_GATE
                or set(chains.values()) != {"safe"}):
            raise AssertionError(f"the analysis report: schema "
                                 f"{rep['schema']}, gated {gated}, chains "
                                 f"{chains}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(peaks=dict(pk, shares=shares), smem_optin=budget,
                contracts=dict(cstats, launchers=launchers,
                               over_budget=over.detail),
                search=search, bloat=bloat_rows,
                cli=dict(families=fams, chains=chains,
                         elapsed_s=rep["elapsed_s"]),
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 48-50: rwkv6-1.6b, the edge CNN, the example ports
# ---------------------------------------------------------------------------

RWKV = "rwkv6-1.6b"
RWKV_PARAMS = 1_599_719_424
RWKV_TRAIN = dict(B=2, seq=512, steps=3)
# each bfloat16 block's time mix and channel mix (and the head) against
# the same function on a float32 copy of the weights, on the bfloat16 run's
# own input to it: relative error of the mix's output (the block's
# increment to the residual stream, not the stream) in the 2-norm
RWKV_BF16_REL = 0.03
# the first train step's loss (bfloat16) against the float32 copy's loss on
# the same batch: the mean CE over its labelled tokens (up to 1,024),
# relative
RWKV_LOSS_REL = 0.02
EDGE_BACKENDS = ("sliding", "im2col_gemm", "sliding_pallas")
EDGE = dict(steps=200, batch=64, test=256)
TRAIN_LM_STEPS = 30
# phase 50's launches: row 1 once (the quickstart's section 3); rows 4 and 7
# 213 times each (``card_ms``' 3 warm-up calls, 10 host-timed, 20 batches of
# 10); row 2 by serve_decode on qwen3-1.7b's smoke config: 2 requests x 23
# decode steps x 2 layers
EXAMPLE_LAUNCHES = dict(sliding_conv1d=1, conv2d=213, im2col_conv2d=213,
                        attention_decode=92)


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not
    a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_rwkv6(serve, models, configs, optim, steps_mod, train, iter_leaves,
                map_tree) -> dict:
    """48. rwkv6-1.6b at its published widths and depth (24 layers, d 2048,
    bf16, the reference's init rescaled to std 1/sqrt(input width)): one
    request of B 4, P 256 (two whole 128-position chunks), 32 tokens,
    greedy, with no kernel launched; two more requests give the same
    tokens; each block's two mixes and the head held to a float32 copy of
    the weights; then 3 train steps at B 2 x 512 through the train core
    (AdamW, float32 moments, remat per block and per WKV chunk), the first
    step's loss held to the float32 copy's on the same batch."""
    cfg = configs.get_config(RWKV)
    model = models.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for _, t in iter_leaves(params))
    if n_params != RWKV_PARAMS:
        raise AssertionError(f"{RWKV}: {n_params} params, expected "
                             f"{RWKV_PARAMS}")
    log(f"full width {RWKV}: {n_params} params ({n_bytes / 1e9:.3f} GB "
        f"{cfg.param_dtype}), {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, WKV {cfg.rwkv_wkv_mode} "
        f"chunk {cfg.rwkv_wkv_chunk}; init rescaled to std 1/sqrt(input "
        f"width) in {init_s:.2f}s")
    prompts = _decoder_prompts(cfg)
    gen = SERVE["gen"]
    res = _serve_request(serve, model, params, prompts, gen, only(),
                         f"{RWKV} full-width fp")
    cache_len = res["cache_len"]
    toks = [serve.generate(model, params, prompts, gen_len=gen,
                           cache_len=cache_len)[0] for _ in range(2)]
    if not torch.equal(toks[0], toks[1]):
        raise AssertionError(f"{RWKV}: two requests gave different tokens")
    B, seq, n = (RWKV_TRAIN[k] for k in ("B", "seq", "steps"))
    batches = train_batches(cfg, B, seq, n, 0, DEV, train)
    model32 = models.build_model(cfg.replace(param_dtype="float32",
                                             compute_dtype="float32"))
    params32 = map_tree(lambda t: t.float(), params)
    held = _rwkv_mixes_vs_f32(model, model32, params, params32, prompts)
    with torch.no_grad():
        loss32 = model32.loss(params32, batches[0]).item()
    del params32
    log(f"{RWKV}: two more requests gave the same tokens "
        f"{toks[0][0, :8].tolist()}; against a float32 copy on the same "
        f"input, relative error of each block's time mix "
        f"{held['time_mix_max']:.3e} at most (layer {held['time_mix_worst']})"
        f", channel mix {held['channel_mix_max']:.3e} at most (layer "
        f"{held['channel_mix_worst']}), the head {held['head_rel']:.3e} "
        f"(limit {RWKV_BF16_REL})")
    res.update(n_params=n_params, param_bytes=n_bytes, init_s=init_s,
               bf16_time_mix_rel=held["time_mix"],
               bf16_channel_mix_rel=held["channel_mix"],
               bf16_head_rel=held["head_rel"])
    torch.cuda.empty_cache()

    opt_cfg = optim.OptConfig(total_steps=n, warmup_steps=max(n // 20, 5),
                              state_dtype=cfg.opt_state_dtype)
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    step_fn = steps_mod.make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(losses[0] - loss32) / loss32
    if (not np.isfinite(losses).all() or launches != only()
            or not loss_rel <= RWKV_LOSS_REL):
        raise AssertionError(f"{RWKV} train: losses {losses} (float32 step "
                             f"0: {loss32}, limit {RWKV_LOSS_REL}), launches "
                             f"{launches}")
    tr = dict(losses=losses, loss_f32_step0=loss32, loss_rel_step0=loss_rel,
              step_ms_all=[t * 1e3 for t in times], step_ms=times[-1] * 1e3,
              tok_per_s=B * seq / times[-1], peak_mem_gb=peak,
              launches=launches)
    log(f"full-width {RWKV} train B={B} seq={seq}, {n} steps ({cfg.remat} "
        f"remat, {cfg.opt_state_dtype} moments): losses "
        f"{[round(x, 4) for x in losses]} (step 0 on the float32 copy "
        f"{loss32:.4f}, {loss_rel:.2e} apart), step ms "
        f"{[round(t * 1e3, 1) for t in times]}, {tr['tok_per_s']:.0f} "
        f"tokens/s at the last step, peak mem {peak:.2f} GB")
    del state, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(serve=res, train=tr)


def _rwkv_mixes_vs_f32(model, model32, params, params32, prompts) -> dict:
    """rwkv6's prefill in bfloat16, each block's time mix and channel mix
    (and the final norm and head) held to the same function on a float32
    copy of its weights, given the bfloat16 run's own input: relative error
    of the mix's output in the 2-norm within ``RWKV_BF16_REL``. The mixes'
    outputs are what a block adds to the residual stream, so the stream's
    own norm does not dilute their error. The blocks compose as
    ``RWKV6._layer`` does."""
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6
    from repro_torch.models.common import unstack

    def tm(m, lp, x):
        h = L.rms_norm(x, lp["ln1"], m.cfg.norm_eps)
        return rwkv6.time_mix(lp, h, m.cfg, m._state0(x),
                              wkv_mode=m.wkv_mode)[0]

    def cm(m, lp, x):
        h = L.rms_norm(x, lp["ln2"], m.cfg.norm_eps)
        return rwkv6.channel_mix(lp, h, m.cfg)

    def head(m, p, x):
        h = L.rms_norm(x, p["final_norm"], m.cfg.norm_eps)[:, -1:]
        return L.lm_logits(p["embed"], h, m.cfg)

    def rel_norm(got, want) -> float:
        return ((got.float() - want).norm() / want.norm()).item()

    rel = {"time_mix": [], "channel_mix": []}
    with torch.no_grad():
        x = L.embed_tokens(params["embed"], prompts, model.cfg)
        for lp, lp32 in zip(unstack(params["blocks"]),
                            unstack(params32["blocks"])):
            for name, mix in (("time_mix", tm), ("channel_mix", cm)):
                y = mix(model, lp, x)
                rel[name].append(rel_norm(y, mix(model32, lp32, x.float())))
                x = x + y
        head_rel = rel_norm(head(model, params, x),
                            head(model32, params32, x.float()))
    out = dict(rel, head_rel=head_rel)
    for name, r in rel.items():
        out[name + "_worst"] = int(np.argmax(r))
        out[name + "_max"] = max(r)
    if not max(rel["time_mix"] + rel["channel_mix"]
               + [head_rel]) <= RWKV_BF16_REL:
        raise AssertionError(f"{RWKV}: bf16 mixes against float32 {rel}, "
                             f"head {head_rel} (limit {RWKV_BF16_REL})")
    return out


def _edge_grads(edge, p, x, y, backend):
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = edge.loss_fn(leaves, x, y, backend)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def _edge_int8_kernels(edge, layers, sliding, qp, x) -> float:
    """The w8a8 chain's convs on ``sliding_pallas`` (row 14) against their
    plain versions, layer by layer on the plain path's inputs: c1 and c2
    int8 codes equal but at ties, c3 float32 within 1e-5 of max |y|."""
    h, err = x, 0.0
    for i, (key, site) in enumerate(edge.SITES):
        kw = dict(activation="relu", padding="SAME", backend="sliding_pallas",
                  precision="w8a8", site=site)
        got = layers.conv2d_bias_act(h, qp[key], None, **kw)
        with plain_kernels():
            want = layers.conv2d_bias_act(h, qp[key], None, **kw)
            q = qp[key]
            yf = layers.conv2d_bias_act(h, type(q)(q.q, q.scale, q.x_scale,
                                                   None), None, **kw)
        if i == 2:
            err = close(got, want, dict(rtol=0.0, atol=1e-5 * max(
                1.0, want.abs().max().item())), f"edge {key} w8a8")
            break
        codes_close(got, want, yf / q.out_scale, f"edge {key} w8a8 codes",
                    tie=1e-4, max_frac=1e-4)
        h = sliding.max_pool2d(want, (2, 2))
    return err


def phase_edge_cnn(layers, sliding) -> dict:
    """49. The edge CNN (``examples/edge_cnn_torch.py``): step 0's loss and
    every gradient on ``sliding_pallas`` (rows 4 and 12) against the plain
    versions and against ``sliding`` on the same weights and batch; then
    200 SGD steps each on ``sliding``, ``im2col_gemm`` and
    ``sliding_pallas`` from one seed, test accuracy above 0.9 on each,
    each step timed by CUDA events (host gaps included); on
    ``sliding_pallas`` the int8 chain (calibration, ``quantize_net``, the
    w8a8 evaluation): dequant sites ['edge/c3'], accuracy within 2% of
    float32, row 14 held to its plain version at the chain's shapes. The
    counters over the ``sliding_pallas`` run (training, evaluation,
    calibration and the w8a8 evaluation) must show rows 4, 12 and 14."""
    from repro_torch import quant

    edge = load_example("edge_cnn_torch")
    p0 = edge.init_params(torch.Generator(device=DEV).manual_seed(0))
    x0, y0 = edge.synthetic_task(np.random.default_rng(0), EDGE["batch"],
                                 device=DEV)
    loss_k, g_k = _edge_grads(edge, p0, x0, y0, "sliding_pallas")
    with plain_kernels():
        loss_p, g_p = _edge_grads(edge, p0, x0, y0, "sliding_pallas")
    loss_s, _ = _edge_grads(edge, p0, x0, y0, "sliding")
    errs = {k: close(g_k[k], g_p[k], TOL, f"edge grad {k}", scaled=True)
            for k in g_k}
    close(loss_k, loss_p, TOL, "edge step-0 loss, kernels vs plain")
    close(loss_k, loss_s, TOL, "edge step-0 loss, sliding_pallas vs sliding")
    log(f"edge CNN step 0 (B {EDGE['batch']}, 28x28x1): loss "
        f"sliding_pallas {loss_k.item():.6f}, plain {loss_p.item():.6f}, "
        f"sliding {loss_s.item():.6f}; grads kernels vs plain max |err| "
        f"{ {k: f'{e:.2e}' for k, e in errs.items()} }")
    out = {"step0": dict(loss_sliding_pallas=loss_k.item(),
                         loss_sliding=loss_s.item(), grad_max_abs_err=errs)}
    for backend in EDGE_BACKENDS:
        rng = np.random.default_rng(0)
        params = edge.init_params(torch.Generator(device=DEV).manual_seed(0))
        torch.cuda.synchronize()
        zero_launches()
        ev, losses = [], []
        t0 = time.perf_counter()
        for _ in range(EDGE["steps"]):
            x, y = edge.synthetic_task(rng, EDGE["batch"], device=DEV)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, loss = edge.sgd_step(params, x, y, backend)
            b.record()
            ev.append((a, b))
            losses.append(loss)
        xt, yt = edge.synthetic_task(rng, EDGE["test"], device=DEV)
        acc = edge.accuracy(params, xt, yt, backend)
        wall = time.perf_counter() - t0
        step_ms = statistics.median(a.elapsed_time(b) for a, b in ev)
        losses = torch.stack(losses).tolist()
        if not acc > 0.9:
            raise AssertionError(f"edge CNN on {backend}: test accuracy {acc}")
        r = dict(acc=acc, step_ms=step_ms, wall_s=wall,
                 loss_first=losses[0], loss_last=losses[-1])
        if backend == "sliding_pallas":
            calib_x, _ = edge.synthetic_task(rng, EDGE["batch"], device=DEV)
            qp = edge.quantize_net(params, calib_x, backend)
            with quant.counting_dequants() as deq:
                acc_q = edge.accuracy(qp, xt, yt, backend, precision="w8a8")
            launches = read_launches()
            want = only(conv2d=5 * EDGE["steps"] + 6,
                        conv2d_bwd_dw=3 * EDGE["steps"], conv2d_quant=3)
            if launches != want:
                raise AssertionError(f"edge CNN launches {launches}, "
                                     f"expected {want}")
            if deq != ["edge/c3"] or abs(acc - acc_q) > 0.02:
                raise AssertionError(f"edge CNN int8: dequant sites {deq}, "
                                     f"accuracy {acc_q} against {acc}")
            err_q = _edge_int8_kernels(edge, layers, sliding, qp, xt)
            r.update(acc_q=acc_q, dequant_sites=list(deq), launches=launches,
                     w8a8_max_abs_err=err_q)
            log(f"edge CNN int8 (w8a8) on sliding_pallas: test acc "
                f"{acc_q:.4f} (f32 {acc:.4f}), dequant sites {deq}; row 14 "
                f"vs plain at the chain's shapes: c3 max |err| {err_q:.2e}; "
                f"launches {launches}")

        def one_step():  # profile_busy runs under no_grad
            with torch.enable_grad():
                edge.sgd_step(params, x, y, backend)

        prof = profile_busy(one_step)  # after the counters were read
        r.update(busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"],
                 kernels_per_step=prof["kernels"], top=prof["top"])
        log(f"edge CNN on {backend}: {EDGE['steps']} steps of B "
            f"{EDGE['batch']}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"test acc {acc:.4f}; step {step_ms:.3f} ms (median, CUDA "
            f"events around the step, host gaps included); {wall:.2f}s; "
            f"profiled step: wall {prof['wall_ms']:.3f} ms, card busy "
            f"{prof['busy_ms']:.3f} ms, {prof['kernels']} kernels; top: "
            f"{prof['top']}")
        out[backend] = r
    return out


def phase_examples() -> dict:
    """50. The three other example ports through their ``main``: the
    quickstart on the card (its Fig. 1 point from ``card_ms``), serve_decode
    on qwen3-1.7b and rwkv6-1.6b (smoke configs, the determinism check),
    train_lm at 10m for ``TRAIN_LM_STEPS`` steps (the loss must fall). The
    counters over the three must read exactly ``EXAMPLE_LAUNCHES``. Then
    each kernel is held to its plain version at the shapes it ran: rows 4
    and 7 on the quickstart's Fig. 1 operands, row 2 by serve_decode's
    qwen3 tokens from a second run on the plain versions."""
    from repro_torch.kernels import ops

    serve_decode = load_example("serve_decode_torch")
    zero_launches()
    t0 = time.perf_counter()
    qs = load_example("quickstart_torch").main(["--device", "cuda"])
    sd = {arch: serve_decode.main(["--device", "cuda", "--arch", arch])
          for arch in ("qwen3-1.7b", RWKV)}
    with tempfile.TemporaryDirectory() as run_dir:
        lm = load_example("train_lm_torch").main(
            ["--device", "cuda", "--steps", str(TRAIN_LM_STEPS),
             "--run-dir", run_dir])
    launches = read_launches()
    seconds = time.perf_counter() - t0
    if launches != only(**EXAMPLE_LAUNCHES):
        raise AssertionError(f"examples launches {launches}, expected "
                             f"{EXAMPLE_LAUNCHES}")
    if not qs["kernel_vs_plain"] <= 1e-3:
        raise AssertionError(f"quickstart: row 1 against core.conv1d "
                             f"{qs['kernel_vs_plain']}")
    # k=17 sums of 4,624 products of unit normals (|y| up to ~300): atol
    # scaled by max |y|, as for gradients
    x, w = qs.pop("fig1_k17_operands")
    fig1_err = {}
    for backend in ("sliding", "im2col_gemm"):
        got = ops.conv2d(x, w, backend=backend)
        with plain_kernels():
            want = ops.conv2d(x, w, backend=backend)
        fig1_err[backend] = close(got, want, TOL, f"quickstart Fig. 1 k=17 "
                                  f"{backend}", scaled=True)
    with plain_kernels():
        plain_toks = serve_decode.main(["--device", "cuda", "--arch",
                                        "qwen3-1.7b"])["tokens"]
    if not torch.equal(sd["qwen3-1.7b"]["tokens"], plain_toks):
        raise AssertionError(
            f"serve_decode qwen3-1.7b: tokens {sd['qwen3-1.7b']['tokens']} "
            f"on the kernels, {plain_toks} on the plain versions")
    res = dict(quickstart=dict(qs, regimes={str(k): v for k, v in
                                            qs["regimes"].items()},
                               fig1_k17_max_abs_err=fig1_err),
               serve_decode_s={a: r["seconds"] for a, r in sd.items()},
               train_lm=dict(first10=lm["first10"],
                             final_loss=lm["final_loss"],
                             n_params=lm["n_params"]),
               launches=launches, seconds=seconds)
    log(f"examples: quickstart k=17 sliding {qs['fig1_k17_ms']['sliding']:.4f}"
        f" ms vs im2col+GEMM {qs['fig1_k17_ms']['im2col_gemm']:.4f} ms "
        f"({qs['clock']}), rows 4 and 7 vs plain on its operands max |err| "
        f"{ {b: f'{e:.2e}' for b, e in fig1_err.items()} }; serve_decode "
        f"first requests {res['serve_decode_s']}, qwen3's tokens equal on "
        f"the plain versions; train_lm 10m {TRAIN_LM_STEPS} steps loss "
        f"{lm['first10']:.3f} -> {lm['final_loss']:.3f}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return res


# -- 53: the mesh runtime ------------------------------------------------------------

# qwen3-moe-30b-a3b at full width, 4 of its 48 layers, float32 params and
# compute, on (data 2, model 2): tensor-parallel in attention and the
# vocabulary, each rank 64 of the 128 experts; the phase-45 prompts, two
# rows a data rank, one prefill and 8 greedy steps
MESH_MOE_CUT = dict(num_layers=4, param_dtype="float32",
                    compute_dtype="float32", attn_decode="fused")
MESH_MOE_GEN = 9
# its blocks a rank: 6.232 GB of the 12.459 GB whole (the expert-parallel
# slice alone held 7.63 GB a rank)
MESH_MOE_RANK_GB = 7.63
# whisper-medium at full width and depth, float32 (the step is held to the
# one-rank step at 1e-4, which bf16's rounding of a different batch split
# would exceed), phase 9's batch split two rows a rank on (data 2)
MESH_TRAIN = dict(B=4, seq=512)
# the pipeline on those two ranks: two stages of one d x d tanh layer each
MESH_PIPE = dict(d=1024, M=4, mb=64)
# qwen3-1.7b whole (28 layers, 1,720,574,976 params), float32: served on
# (model 2), the phase-45 prompts and 9 greedy tokens; one AdamW step of B
# 4 x 256 on (data 2, model 2) under FSDP_RULES
MESH_QWEN = "qwen3-1.7b"
MESH_QWEN_CUT = dict(param_dtype="float32", compute_dtype="float32",
                     attn_decode="fused")
MESH_QWEN_PARAMS = 1_720_574_976
MESH_QWEN_TRAIN = dict(B=4, seq=256)
# jamba-1.5-large one period without experts (8,999,034,880 params),
# float32, served on (model 2): row 3 at 8,192 of 16,384 channels a rank
MESH_JAMBA_CUT = dict(JAMBA_CUT, param_dtype="float32",
                      compute_dtype="float32", conv_backend="sliding_pallas",
                      attn_decode="fused")
# AdamW at an eps above the clipped gradients' scale: the first step's
# update is continuous in the gradient (at 1e-8 it is lr * sign(g), which a
# last-bit difference of a near-zero element flips), so the stepped params
# can be held to the one-rank step's
MESH_OPT = dict(total_steps=2, warmup_steps=1, eps=1e-3)
MESH_LOGIT_REL = 1e-5  # the psums reorder a product's sum over the ranks
MESH_TIE_REL = 2e-5  # a greedy pick that differs must be a near tie
MESH_GRAD_REL = 1e-4
# (e): the first mamba layer's states, whose inputs every rank holds bit for
# bit, within 1e-5; each later layer adds 3-4e-6 as the psums' reordered
# sums (x_proj, out_proj, the MLP's wd) reach it, 3.4e-05 at the seventh
# and in the logits (scripts/jamba_tp_noise.py), so those within 1e-4
MESH_STATE_REL = 1e-5
MESH_JAMBA_REL = 1e-4
MESH_EF_REL = 0.05  # the reference test's bound
MESH_PIPE_TOL = 1e-5
MESH_TIMEOUT_S = 420.0


def _recording(fn, out: list, states: list | None = None):
    """``fn`` whose returned logits (first of its outputs) are kept, the
    last position's, in float32 on the host; with ``states``, the mamba
    states of the cache it returns (a prefill's) too."""
    def rec(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append(res[0][:, -1].float().cpu())
        if states is not None:
            states.append({k: {n: t.float().cpu() for n, t in v.items()}
                           for k, v in res[1].items() if k.startswith("mamba")})
        return res
    return rec


def _mesh_serve(serve, model, params, prompts, gen, states=None):
    """One greedy request through ``serve.generate`` (after a 2-token
    warm-up) with the prefill's and every decode step's logits recorded
    (and the prefill's mamba states into ``states``): (tokens, logits
    list, stats, launches, peak GB)."""
    cfg = model.cfg
    B, P = prompts.shape
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    serve.generate(model, params, prompts, gen_len=2, cache_len=cache_len)
    logits: list = []
    model.prefill = _recording(model.prefill, logits, states)
    model.decode_step = _recording(model.decode_step, logits)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    stats: dict = {}
    toks, _ = serve.generate(model, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats)
    torch.cuda.synchronize()
    launches = read_launches()
    del model.prefill, model.decode_step
    return (toks.cpu().numpy(), [t.numpy() for t in logits], stats, launches,
            torch.cuda.max_memory_allocated() / 1e9)


def flat_states(states: dict) -> dict:
    """A prefill's mamba states ({layer: {conv, ssm}}) as ``layer/conv``,
    ``layer/ssm`` numpy arrays."""
    return {f"{k}/{n}": t.numpy() for k, v in states.items()
            for n, t in v.items()}


def state_block(whole: np.ndarray, key: str, m: int, got: np.ndarray):
    """Model rank ``m``'s channel block of a whole mamba state leaf
    (``.../conv``: channels last; ``.../ssm``: channels before the state
    dim), the shape of ``got``."""
    if key.endswith("conv"):
        c = got.shape[-1]
        return whole[..., m * c:(m + 1) * c]
    c = got.shape[-2]
    return whole[..., m * c:(m + 1) * c, :]


def state_errs(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(max |diff| over max |want|, ||diff|| over ||want||), in float64."""
    d = got.astype(np.float64) - want
    return (float(np.abs(d).max() / np.abs(want).max()),
            float(np.linalg.norm(d) / np.linalg.norm(want)))


def _params_gb(params, iter_leaves) -> float:
    return sum(t.numel() * t.element_size() for _, t in iter_leaves(params)) / 1e9


def _serve_rank(mesh, arch, over, rows, gen, keep_states=False):
    """A rank's request: its blocks of the one-rank draw (``init_params``
    with ``rt``), rescaled as phase 45 rescales, its rows; with
    ``keep_states`` the prefill's mamba states (``layer/conv``,
    ``layer/ssm``: this rank's channels) on the host."""
    import repro_torch
    from repro_torch import configs, models
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import Runtime, iter_leaves
    from repro_torch.launch import serve

    dev = repro_torch.resolve_device(DEV)
    rt = Runtime(mesh)
    model = models.build_model(configs.get_config(arch).replace(**over), rt)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    copies0 = dict(C.HOST_COPIES)
    t0 = time.perf_counter()
    states = [] if keep_states else None
    toks, logits, stats, launches, peak = _mesh_serve(
        serve, model, params, torch.as_tensor(rows, device=dev), gen, states)
    moe_w = params["blocks"]["moe"]["wg"] if arch == MOE else None
    out = dict(rank=mesh.rank, coords=dict(mesh.coords), tokens=toks,
               expert_block=None if moe_w is None else tuple(moe_w.shape),
               logits=logits, ttft_ms=stats["ttft_s"] * 1e3,
               decode_step_ms=statistics.median(stats["step_s"]) * 1e3,
               launches=launches, peak_mem_gb=peak, serve_s=time.perf_counter() - t0,
               params_gb=_params_gb(params, iter_leaves),
               host_copies={k: v - copies0.get(k, 0)
                            for k, v in C.HOST_COPIES.items()})
    if keep_states:
        out["states"] = flat_states(states[0])
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_moe_rank(mesh, prompts, over, gen):
    """A rank of (a): its data rank's two rows."""
    i = mesh.coords["data"]
    out = _serve_rank(mesh, MOE, over, prompts[2 * i:2 * i + 2], gen)
    return out


def _mesh_qwen_train_rank(mesh, over, batch_kw):
    """A rank of (d)'s step on (data 2, model 2) under FSDP_RULES. Rank 0
    first runs the one-rank step on the whole batch (the other ranks wait
    at a barrier) and keeps its gradient and stepped params in host
    memory; every rank then steps its blocks on its data rank's rows, and
    each synced gradient leaf (as the step syncs it) and stepped param is
    gathered whole, one leaf at a time, and held on rank 0."""
    import repro_torch
    from repro_torch import configs, models, optim
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (
        FSDP_RULES, Runtime, iter_leaves,
    )
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train

    dev = repro_torch.resolve_device(DEV)
    rt = Runtime(mesh, dict(FSDP_RULES))
    cfg = configs.get_config(MESH_QWEN).replace(**over)
    model = models.build_model(cfg, rt)
    full = train_batches(cfg, batch_kw["B"], batch_kw["seq"], 1, 0, dev,
                         train)[0]
    opt_cfg = optim.OptConfig(**MESH_OPT)
    out = dict(rank=mesh.rank)
    oracle = None
    t0 = time.perf_counter()
    if mesh.rank == 0:
        one = models.build_model(cfg)
        with torch.no_grad():
            whole = one.init(torch.Generator(device=dev).manual_seed(0))
            rescale_fan_in(whole, one.param_defs(), iter_leaves)
        loss1, g1 = steps_mod.loss_and_grads(one, whole, full)
        grads = {k: g.cpu() for k, g in iter_leaves(g1)}
        _, _, info = optim.apply_updates(whole, g1, optim.init_opt_state(
            whole, opt_cfg), opt_cfg)
        oracle = dict(loss=float(loss1), norm=float(info["grad_norm"]),
                      grads=grads,
                      stepped={k: p.cpu() for k, p in iter_leaves(whole)})
        del one, g1, whole
        gc.collect()
        torch.cuda.empty_cache()
        out.update(oracle_loss=oracle["loss"], oracle_norm=oracle["norm"])
    out["oracle_s"] = time.perf_counter() - t0
    C.barrier(mesh)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    out["params_gb"] = _params_gb(params, iter_leaves)
    i, half = mesh.coords["data"], batch_kw["B"] // 2
    batch = {k: v[i * half:(i + 1) * half] for k, v in full.items()}
    defs = dict(iter_leaves(model.param_defs()))

    def hold(tree, key):
        """The worst leaf of ``tree`` gathered whole against the oracle's
        ``key`` leaves (rank 0), as max |diff| over max |oracle|."""
        worst = 0.0
        for k, t in iter_leaves(tree):
            w = rt.gather(t, defs[k])
            if oracle is not None:
                ref = oracle[key][k].to(w.device)
                worst = max(worst, ((w - ref).abs().max()
                                    / ref.abs().max().clamp(min=1e-30)).item())
                del ref
            del w
        return worst

    real_sync = steps_mod.sync_grads

    def spy(grads, rt_, defs_=None):
        synced = real_sync(grads, rt_, defs_)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["grad_rel"] = hold(synced, "grads")
        out["hold_s"] = time.perf_counter() - t1
        return synced

    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    step = steps_mod.make_train_step(model, opt_cfg, rt=rt)
    steps_mod.sync_grads = spy
    copies0 = dict(C.HOST_COPIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0 - out["hold_s"]
    finally:
        steps_mod.sync_grads = real_sync
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["host_copies"] = {k: v - copies0.get(k, 0)
                          for k, v in C.HOST_COPIES.items()}
    out["loss"], out["norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    t0 = time.perf_counter()
    out["param_rel"] = hold(state["params"], "stepped")
    out["hold_s"] += time.perf_counter() - t0
    del state, oracle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_grid_rank(mesh, prompts, over, gen, qwen_over, qwen_batch):
    """A rank of (data 2, model 2): (a), then (d)'s FSDP step."""
    t0 = time.perf_counter()
    a = _mesh_moe_rank(mesh, prompts, over, gen)
    a["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = _mesh_qwen_train_rank(mesh, qwen_over, qwen_batch)
    d["s"] = time.perf_counter() - t0
    return dict(a=a, d_train=d)


def _mesh_model_rank(mesh, prompts_q, qwen_over, gen, prompts_j, jamba_over):
    """A rank of (model 2): (d)'s request, then (e)'s with the prefill's
    mamba states kept."""
    t0 = time.perf_counter()
    d = _serve_rank(mesh, MESH_QWEN, qwen_over, prompts_q, gen)
    d["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e = _serve_rank(mesh, JAMBA, jamba_over, prompts_j, gen, keep_states=True)
    e["s"] = time.perf_counter() - t0
    return dict(d_serve=d, e=e)


def rescale_whisper(params, defs, iter_leaves) -> None:
    """whisper's fan-in weights at std 1/sqrt(input width), in place: the
    encoder and decoder stacks as ``rescale_fan_in`` rescales a decoder's,
    and the frontend convs (K, Cin, Cout), which the reference's rule
    draws with std 1/sqrt(K), at 1/sqrt(K * Cin). From that init the
    frontend's outputs reach 900, and on an H100 the encoder turns the
    last bits of a batch-shaped matrix product into 1e-3 of its output, so
    a step on four rows and two steps on two rows each part by 1e-3 in
    loss (PERF.md §6). The leaves may be a rank's blocks: the scale is the
    whole leaf's (``defs``)."""
    rescale_fan_in(params, defs, iter_leaves, stacks=("encoder", "decoder"))
    want = dict(iter_leaves(defs))
    for name in ("conv1_w", "conv2_w"):
        w = params["frontend"][name]
        w.div_(want[f"frontend/{name}"].shape[1] ** 0.5)


def _mesh_train_rank(mesh, over, batch_kw, pipe):
    """A rank of (b) and (c) on (data 2): the replicated step, the same
    step under FSDP_RULES, the error-feedback all-reduce, the pipeline."""
    import repro_torch
    from repro_torch import configs, models, optim
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import (
        FSDP_RULES, Runtime, iter_leaves, map_tree,
    )
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import ef_allreduce_grads, init_error_feedback

    dev = repro_torch.resolve_device(DEV)
    rt = Runtime(mesh)
    rt_f = Runtime(mesh, dict(FSDP_RULES))
    cfg = configs.get_config("whisper-medium").replace(**over)
    model, one = models.build_model(cfg, rt), models.build_model(cfg)
    model_f = models.build_model(cfg, rt_f)
    defs_f = dict(iter_leaves(model_f.param_defs()))
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        rescale_whisper(params, model.param_defs(), iter_leaves)
        # FSDP's blocks of the same weights, before (b) steps them in place
        params_f = {}
        for k, t in iter_leaves(params):
            node = params_f
            *parents, name = k.split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[name] = rt_f.local(t, defs_f[k]).clone()
    full = train_batches(cfg, batch_kw["B"], batch_kw["seq"], 1, 0, dev,
                         train)[0]
    i, half = mesh.coords["data"], batch_kw["B"] // 2
    batch = {k: v[i * half:(i + 1) * half] for k, v in full.items()}
    out = dict(rank=mesh.rank)
    oracle = None
    if mesh.rank == 0:  # the one-rank step on the whole batch
        loss1, oracle = steps_mod.loss_and_grads(one, params, full)
        out["oracle_loss"] = float(loss1)
    # (b) the synced step; a spy keeps its local and synced gradients
    kept = {}
    real_sync = steps_mod.sync_grads

    def spy(grads, rt_, defs=None):
        kept["local"] = map_tree(torch.clone, grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synced = real_sync(grads, rt_, defs)
        torch.cuda.synchronize()
        kept["sync_s"] = time.perf_counter() - t0
        kept["synced"] = map_tree(torch.clone, synced)
        return synced

    opt_cfg = optim.OptConfig(total_steps=2, warmup_steps=1)
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    step = steps_mod.make_train_step(model, opt_cfg, rt=rt)
    steps_mod.sync_grads = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        out["loss"] = float(metrics["loss"])
        out["step_s"] = time.perf_counter() - t0
    finally:
        steps_mod.sync_grads = real_sync
    out["launches"] = read_launches()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["sync_s"] = kept["sync_s"]
    if oracle is not None:
        want = dict(iter_leaves(oracle))
        out["grad_rel"] = max(
            ((g - want[k]).abs().max() / want[k].abs().max()).item()
            for k, g in iter_leaves(kept["synced"]))
    sums = torch.stack([p.double().sum() for _, p in iter_leaves(state["params"])])
    hi, lo = C.pmax(sums, "data", mesh), -C.pmax(-sums, "data", mesh)
    out["param_checksum_diff"] = (hi - lo).abs().max().item()
    del state
    # (b) under FSDP_RULES: each rank holds its data block of every embed
    # dim, gathered layer by layer, and its gradient is reduce-scattered
    kept_f = {}

    def spy_f(grads, rt_, defs=None):
        synced = real_sync(grads, rt_, defs)
        kept_f["synced"] = map_tree(torch.clone, synced)
        return synced

    state_f = {"params": params_f,
               "opt": optim.init_opt_state(params_f, opt_cfg)}
    step_f = steps_mod.make_train_step(model_f, opt_cfg, rt=rt_f)
    steps_mod.sync_grads = spy_f
    copies0 = dict(C.HOST_COPIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        t0 = time.perf_counter()
        state_f, metrics_f = step_f(state_f, batch)
        torch.cuda.synchronize()
        out["fsdp_step_s"] = time.perf_counter() - t0
    finally:
        steps_mod.sync_grads = real_sync
    out["fsdp_launches"] = read_launches()
    out["fsdp_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["fsdp_host_copies"] = {k: v - copies0.get(k, 0)
                               for k, v in C.HOST_COPIES.items()}
    out["fsdp_loss"] = float(metrics_f["loss"])
    out["fsdp_params_gb"] = _params_gb(state_f["params"], iter_leaves)
    worst = 0.0
    for k, g in iter_leaves(kept_f["synced"]):
        w = rt_f.gather(g, defs_f[k])
        if oracle is not None:
            worst = max(worst, ((w - want[k]).abs().max()
                                / want[k].abs().max()).item())
        del w
    out["fsdp_grad_rel"] = worst
    del state_f, kept_f, oracle
    if mesh.rank == 0:
        del want
    # the same local gradients through the error-feedback all-reduce
    err = init_error_feedback(kept["local"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, err = ef_allreduce_grads(kept["local"], err, mesh, rt.dp_axes())
    torch.cuda.synchronize()
    out["ef_sync_s"] = time.perf_counter() - t0
    exact = dict(iter_leaves(kept["synced"]))
    out["ef_rel"] = max(((m - exact[k]).abs().max() / exact[k].abs().max()).item()
                        for k, m in iter_leaves(mean))
    out["ef_err_max"] = max(e.abs().max().item() for _, e in iter_leaves(err))
    leaves = [g for _, g in iter_leaves(kept["local"])]
    out["sync_bytes"] = sum(4 * g.numel() for g in leaves)
    out["ef_sync_bytes"] = sum(4 * g.numel() + 4 * (g.numel() // max(g.shape[-1], 1)
                                                    if g.dim() else 1)
                               for g in leaves)
    out["n_params"] = sum(g.numel() for g in leaves)
    del kept, mean, err, exact, leaves
    # (c) the pipeline: two stages of one tanh layer each
    stage_mesh = make_mesh((mesh.size,), ("stage",))
    gen = torch.Generator(device=dev).manual_seed(5)
    d = pipe["d"]
    ws = torch.randn(mesh.size, d, d, generator=gen, device=dev) / d ** 0.5
    bs = torch.randn(mesh.size, d, generator=gen, device=dev) * 0.1
    x = torch.randn(pipe["M"], pipe["mb"], d, generator=gen, device=dev)
    s = C.axis_index("stage", stage_mesh)
    copies0 = dict(C.HOST_COPIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]), (ws[s], bs[s]),
                       x, stage_mesh)
    torch.cuda.synchronize()
    out["pipe_s"] = time.perf_counter() - t0
    seq = x
    for k in range(mesh.size):
        seq = torch.tanh(seq @ ws[k] + bs[k])
    out["pipe_err"] = (y - seq).abs().max().item()
    out["pipe_host_copies"] = {k: v - copies0.get(k, 0)
                               for k, v in C.HOST_COPIES.items()}
    return out


def _hold_logits(ranks, oracle_of, what, rel=MESH_LOGIT_REL) -> dict:
    """Each rank's recorded logits against its one-rank oracle's (tokens,
    logits): within ``rel`` of the largest, up to the first greedy pick
    that differs, which must be a near tie."""
    worst, agree, picks, gaps = 0.0, 0, 0, []
    for r in ranks:
        want = oracle_of(r)
        for t, (got, ref) in enumerate(zip(r["logits"], want[1])):
            scale = float(np.abs(ref).max())
            worst = max(worst, float(np.abs(got - ref).max()) / scale)
            # a pick that differs feeds the next steps other tokens: the
            # logits are compared up to it, and it must be a near tie
            if not np.array_equal(r["tokens"][:, t], want[0][:, t]):
                top2 = np.sort(ref, axis=-1)[:, -2:]
                gap = float(((top2[:, 1] - top2[:, 0]) / scale).min())
                gaps.append(gap)
                if gap > MESH_TIE_REL:
                    raise AssertionError(
                        f"mesh {what} rank {r['rank']} step {t}: greedy "
                        f"tokens {r['tokens'][:, t]} vs one-rank "
                        f"{want[0][:, t]}, top-2 gap {gap:.3e} of max")
                break
        agree += int((r["tokens"] == want[0]).sum())
        picks += r["tokens"].size
    if worst > rel:
        raise AssertionError(f"mesh {what} logits max |diff| {worst:.3e} of max")
    return dict(logits_rel=worst, greedy_agreement=agree / picks,
                differing_pick_gaps=gaps)


def _log_ranks(what, ranks, keys=("peak_mem_gb", "ttft_ms", "decode_step_ms",
                                  "host_copies")) -> None:
    """One line a rank: its peak, TTFT, decode step and host copies."""
    for r in ranks:
        log(f"mesh {what} rank {r['rank']}: " + ", ".join(
            f"{k} {round(r[k], 2) if isinstance(r[k], float) else r[k]}"
            for k in keys if k in r))


def _serve_oracle(serve, models, configs, iter_leaves, arch, over, prompts,
                  gen, states=None):
    """The one-rank request on the same rescaled weights, its numbers on
    the host, the model freed: ((tokens, logits, stats, launches, peak),
    params)."""
    cfg = configs.get_config(arch).replace(**over)
    model = models.build_model(cfg)
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    res = _mesh_serve(serve, model, params, prompts, gen, states)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return res, n_params


def phase_mesh(serve, models, configs, iter_leaves) -> dict:
    """53: the mesh runtime, ranks sharing cuda:0 over gloo: (a) qwen3-moe
    served tensor- and expert-parallel on (data 2, model 2) against the
    one-rank model on each data rank's rows, then (d)'s qwen3-1.7b AdamW
    step under FSDP_RULES on the same ranks against the one-rank step;
    (d) qwen3-1.7b and (e) jamba-1.5-large's period served tensor-parallel
    on (model 2); (b) whisper-medium's synced train step on (data 2), and
    under FSDP_RULES, against the one-rank step on the whole batch, then
    the error-feedback all-reduce of the same gradients; (c) the GPipe
    schedule on the same two ranks against the sequential composition."""
    from repro_torch.launch.mesh import run_ranks

    res: dict = {}
    seconds: dict = {}
    # (a) the one-rank oracle for each data rank's rows, then freed
    t0 = time.perf_counter()
    over = dict(MESH_MOE_CUT)
    cfg = configs.get_config(MOE).replace(**over)
    prompts = _decoder_prompts(cfg)
    model = models.build_model(cfg)
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        rescale_fan_in(params, model.param_defs(), iter_leaves)
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    oracle = [_mesh_serve(serve, model, params, prompts[2 * i:2 * i + 2],
                          MESH_MOE_GEN) for i in range(2)]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    seconds["a_oracle"] = time.perf_counter() - t0
    log(f"mesh: {MOE} cut to {over} ({n_params} params) one-rank oracle "
        f"done; parent reserves {torch.cuda.memory_reserved() / 1e9:.3f} GB "
        f"before the ranks spawn")
    qwen_over = dict(MESH_QWEN_CUT)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        grid = run_ranks(_mesh_grid_rank, 2, 2, device=DEV, backend="gloo",
                         rdv_dir=rdv, args=(prompts.cpu().numpy(), over,
                                            MESH_MOE_GEN, qwen_over,
                                            MESH_QWEN_TRAIN),
                         timeout_s=MESH_TIMEOUT_S)
    seconds["grid_ranks"] = time.perf_counter() - t0
    ranks = [g["a"] for g in grid]
    steps = cfg.num_layers * (MESH_MOE_GEN - 1)
    for r in ranks:
        if r["launches"] != only(attention_decode=steps):
            raise AssertionError(f"mesh rank {r['rank']} launches "
                                 f"{r['launches']}, expected row 2 {steps}")
        if r["expert_block"][1] != cfg.num_experts // 2:
            raise AssertionError(f"rank {r['rank']} holds {r['expert_block']}")
        if not r["params_gb"] < MESH_MOE_RANK_GB:
            raise AssertionError(f"mesh (a) rank {r['rank']} holds "
                                 f"{r['params_gb']:.3f} GB of params")
    held = _hold_logits(ranks, lambda r: oracle[r["coords"]["data"]], "(a)")
    res["moe"] = dict(
        n_params=n_params, cut=over, **held,
        launches_per_rank=[r["launches"]["attention_decode"] for r in ranks],
        launches=read_total(r["launches"] for r in ranks),
        params_gb=[r["params_gb"] for r in ranks],
        peak_mem_gb=[r["peak_mem_gb"] for r in ranks],
        ttft_ms=[r["ttft_ms"] for r in ranks],
        decode_step_ms=[r["decode_step_ms"] for r in ranks],
        host_copies=[r["host_copies"] for r in ranks],
        s=[r["s"] for r in ranks],
        one_rank_ttft_ms=[o[2]["ttft_s"] * 1e3 for o in oracle],
        one_rank_decode_step_ms=[statistics.median(o[2]["step_s"]) * 1e3
                                 for o in oracle],
        one_rank_peak_mem_gb=[o[4] for o in oracle])
    m = res["moe"]
    log(f"mesh (a) {MOE} {over['num_layers']} layers f32 on (data 2, model "
        f"2), tensor-parallel attention and vocabulary, "
        f"{cfg.num_experts // 2} experts a rank, B 2 a data rank, P "
        f"{prompts.shape[1]}, {MESH_MOE_GEN - 1} decode steps: logits max "
        f"|diff| {m['logits_rel']:.3e} of max, greedy agreement "
        f"{m['greedy_agreement']:.3f} (gaps of differing picks "
        f"{m['differing_pick_gaps']}); row 2 launches a rank "
        f"{m['launches_per_rank']}; params GB a rank "
        f"{[round(x, 3) for x in m['params_gb']]} (< {MESH_MOE_RANK_GB}); "
        f"one rank TTFT ms {[round(x, 2) for x in m['one_rank_ttft_ms']]}, "
        f"decode step ms "
        f"{[round(x, 2) for x in m['one_rank_decode_step_ms']]}; sub-run s "
        f"{[round(x, 1) for x in m['s']]}")
    _log_ranks("(a)", ranks, ("params_gb", "peak_mem_gb", "ttft_ms",
                              "decode_step_ms", "host_copies"))
    # (d)'s step on the same ranks
    tr = [g["d_train"] for g in grid]
    r0 = tr[0]
    loss_rel = abs(r0["loss"] - r0["oracle_loss"]) / abs(r0["oracle_loss"])
    norm_rel = abs(r0["norm"] - r0["oracle_norm"]) / r0["oracle_norm"]
    if len({r["norm"] for r in tr}) != 1 or len({r["loss"] for r in tr}) != 1:
        raise AssertionError(f"mesh (d) step: losses {[r['loss'] for r in tr]}"
                             f", norms {[r['norm'] for r in tr]} differ")
    if not max(loss_rel, norm_rel, r0["grad_rel"],
               r0["param_rel"]) <= MESH_GRAD_REL:
        raise AssertionError(
            f"mesh (d) step: loss rel {loss_rel:.3e}, norm rel "
            f"{norm_rel:.3e}, worst gradient leaf {r0['grad_rel']:.3e}, "
            f"worst stepped param leaf {r0['param_rel']:.3e}")
    res["qwen_train"] = dict(
        loss=r0["loss"], oracle_loss=r0["oracle_loss"], loss_rel=loss_rel,
        norm=r0["norm"], oracle_norm=r0["oracle_norm"], norm_rel=norm_rel,
        grad_rel=r0["grad_rel"], param_rel=r0["param_rel"],
        params_gb=[r["params_gb"] for r in tr],
        peak_mem_gb=[r["peak_mem_gb"] for r in tr],
        step_s=[r["step_s"] for r in tr], hold_s=[r["hold_s"] for r in tr],
        oracle_s=r0["oracle_s"], host_copies=[r["host_copies"] for r in tr],
        s=[r["s"] for r in tr], **MESH_QWEN_TRAIN)
    q = res["qwen_train"]
    log(f"mesh (d) {MESH_QWEN} f32 AdamW step on (data 2, model 2) under "
        f"FSDP_RULES, B {MESH_QWEN_TRAIN['B']} x {MESH_QWEN_TRAIN['seq']}: "
        f"loss {q['loss']:.6f} vs one rank {q['oracle_loss']:.6f} (rel "
        f"{loss_rel:.3e}), clip norm rel {norm_rel:.3e}, worst gradient "
        f"leaf {q['grad_rel']:.3e}, worst stepped param leaf "
        f"{q['param_rel']:.3e}; params GB a rank "
        f"{[round(x, 3) for x in q['params_gb']]}; step s "
        f"{[round(x, 3) for x in q['step_s']]}; one-rank oracle on rank 0 "
        f"{q['oracle_s']:.1f} s; sub-run s {[round(x, 1) for x in q['s']]}")
    _log_ranks("(d) step", tr, ("params_gb", "peak_mem_gb", "step_s",
                                "host_copies"))
    # (d) and (e) on (model 2): one-rank oracles first, on the host
    t0 = time.perf_counter()
    qcfg = configs.get_config(MESH_QWEN).replace(**qwen_over)
    qprompts = _decoder_prompts(qcfg)
    q_oracle, nq = _serve_oracle(serve, models, configs, iter_leaves,
                                 MESH_QWEN, qwen_over, qprompts, MESH_MOE_GEN)
    if nq != MESH_QWEN_PARAMS:
        raise AssertionError(f"{MESH_QWEN}: {nq} params")
    jamba_over = dict(MESH_JAMBA_CUT)
    jcfg = configs.get_config(JAMBA).replace(**jamba_over)
    rng = np.random.default_rng(0)
    jprompts = torch.as_tensor(rng.integers(2, jcfg.vocab_size, size=(
        SERVE["B"], SERVE["P"])), dtype=torch.int32, device=DEV)
    j_states: list = []
    j_oracle, nj = _serve_oracle(serve, models, configs, iter_leaves, JAMBA,
                                 jamba_over, jprompts, MESH_MOE_GEN, j_states)
    if nj != JAMBA_PARAMS:
        raise AssertionError(f"{JAMBA}: {nj} params")
    j_ref = flat_states(j_states[0])
    seconds["model2_oracles"] = time.perf_counter() - t0
    log(f"mesh: {MESH_QWEN} ({nq} params) and {JAMBA} cut to "
        f"{jamba_over} ({nj} params) one-rank oracles done in "
        f"{seconds['model2_oracles']:.1f} s; parent reserves "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        mr = run_ranks(_mesh_model_rank, 1, 2, device=DEV, backend="gloo",
                       rdv_dir=rdv, args=(qprompts.cpu().numpy(), qwen_over,
                                          MESH_MOE_GEN, jprompts.cpu().numpy(),
                                          jamba_over),
                       timeout_s=MESH_TIMEOUT_S)
    seconds["model2_ranks"] = time.perf_counter() - t0
    dq = [r["d_serve"] for r in mr]
    want = only(attention_decode=qcfg.num_layers * (MESH_MOE_GEN - 1))
    for r in dq:
        if r["launches"] != want:
            raise AssertionError(f"mesh (d) rank {r['rank']} launches "
                                 f"{r['launches']}, expected {want}")
    res["qwen_serve"] = dict(
        n_params=nq, **_hold_logits(dq, lambda r: q_oracle, "(d)"),
        launches_per_rank=[r["launches"]["attention_decode"] for r in dq],
        launches=read_total(r["launches"] for r in dq),
        params_gb=[r["params_gb"] for r in dq],
        peak_mem_gb=[r["peak_mem_gb"] for r in dq],
        ttft_ms=[r["ttft_ms"] for r in dq],
        decode_step_ms=[r["decode_step_ms"] for r in dq],
        host_copies=[r["host_copies"] for r in dq], s=[r["s"] for r in dq],
        one_rank_ttft_ms=q_oracle[2]["ttft_s"] * 1e3,
        one_rank_decode_step_ms=statistics.median(q_oracle[2]["step_s"]) * 1e3,
        one_rank_peak_mem_gb=q_oracle[4])
    q = res["qwen_serve"]
    log(f"mesh (d) {MESH_QWEN} whole f32 on (model 2), {qcfg.num_heads // 2} "
        f"of {qcfg.num_heads} query heads and {qcfg.num_kv_heads // 2} of "
        f"{qcfg.num_kv_heads} KV heads a rank, B {SERVE['B']}, P {SERVE['P']}, "
        f"{MESH_MOE_GEN - 1} decode steps: logits max |diff| "
        f"{q['logits_rel']:.3e} of max, greedy agreement "
        f"{q['greedy_agreement']:.3f} (gaps {q['differing_pick_gaps']}); row "
        f"2 a rank {q['launches_per_rank']}; one rank TTFT "
        f"{q['one_rank_ttft_ms']:.2f} ms, decode step "
        f"{q['one_rank_decode_step_ms']:.2f} ms, peak "
        f"{q['one_rank_peak_mem_gb']:.2f} GB; sub-run s "
        f"{[round(x, 1) for x in q['s']]}")
    _log_ranks("(d) serve", dq, ("params_gb", "peak_mem_gb", "ttft_ms",
                                 "decode_step_ms", "host_copies"))
    je = [r["e"] for r in mr]
    n_mamba = jcfg.attn_every - 1
    want = only(conv1d_depthwise=n_mamba, attention_decode=MESH_MOE_GEN - 1)
    first = min(j_ref, key=lambda k: int(k.split("/")[0][5:]))
    first = first.split("/")[0]
    state_rel: dict = {}
    for r in je:
        if r["launches"] != want:
            raise AssertionError(f"mesh (e) rank {r['rank']} launches "
                                 f"{r['launches']}, expected {want}")
        m_ = r["coords"]["model"]
        for k, got in r["states"].items():
            ref = state_block(j_ref[k], k, m_, got)
            if got.shape != ref.shape:
                raise AssertionError(f"mesh (e) {k} {got.shape} vs {ref.shape}")
            state_rel[k] = max(state_rel.get(k, 0.0), state_errs(got, ref)[0])
    for k, e in state_rel.items():
        bound = MESH_STATE_REL if k.startswith(first + "/") else MESH_JAMBA_REL
        if e > bound:
            raise AssertionError(f"mesh (e) state block {k} max |diff| "
                                 f"{e:.3e} of max (bound {bound})")
    worst_state = max(state_rel.values())
    res["jamba_serve"] = dict(
        n_params=nj, cut=JAMBA_CUT, state_rel=state_rel,
        **_hold_logits(je, lambda r: j_oracle, "(e)", MESH_JAMBA_REL),
        launches=read_total(r["launches"] for r in je),
        params_gb=[r["params_gb"] for r in je],
        peak_mem_gb=[r["peak_mem_gb"] for r in je],
        ttft_ms=[r["ttft_ms"] for r in je],
        decode_step_ms=[r["decode_step_ms"] for r in je],
        host_copies=[r["host_copies"] for r in je], s=[r["s"] for r in je],
        one_rank_ttft_ms=j_oracle[2]["ttft_s"] * 1e3,
        one_rank_decode_step_ms=statistics.median(j_oracle[2]["step_s"]) * 1e3,
        one_rank_peak_mem_gb=j_oracle[4])
    j = res["jamba_serve"]
    log(f"mesh (e) {JAMBA} one period f32 on (model 2), "
        f"{jcfg.mamba_d_inner // 2} of {jcfg.mamba_d_inner} channels and "
        f"{jcfg.num_heads // 2} of {jcfg.num_heads} query heads a rank: "
        f"logits max |diff| "
        f"{j['logits_rel']:.3e} of max, greedy agreement "
        f"{j['greedy_agreement']:.3f} (gaps {j['differing_pick_gaps']}); "
        f"ssm and conv state blocks max |diff| of max: {first} "
        f"{max(v for k, v in state_rel.items() if k.startswith(first + '/')):.3e}"
        f", all {worst_state:.3e}; "
        f"launches a rank {je[0]['launches']}; one rank TTFT "
        f"{j['one_rank_ttft_ms']:.2f} ms, decode step "
        f"{j['one_rank_decode_step_ms']:.2f} ms, peak "
        f"{j['one_rank_peak_mem_gb']:.2f} GB; sub-run s "
        f"{[round(x, 1) for x in j['s']]}")
    _log_ranks("(e)", je, ("params_gb", "peak_mem_gb", "ttft_ms",
                           "decode_step_ms", "host_copies"))
    del q_oracle, j_oracle, j_states
    # (b), (c) on (data 2)
    gc.collect()
    torch.cuda.empty_cache()
    over = dict(conv_backend="sliding_pallas", param_dtype="float32",
                compute_dtype="float32")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        tr = run_ranks(_mesh_train_rank, 2, 1, device=DEV, backend="gloo",
                       rdv_dir=rdv, args=(over, MESH_TRAIN, MESH_PIPE),
                       timeout_s=MESH_TIMEOUT_S)
    seconds["data2_ranks"] = time.perf_counter() - t0
    r0 = tr[0]
    rows = only(sliding_conv1d=3, conv1d_bwd_dw=2)
    for r in tr:
        for key in ("launches", "fsdp_launches"):
            if r[key] != rows:
                raise AssertionError(f"mesh train rank {r['rank']} {key} "
                                     f"{r[key]}, expected rows 1, 10 at 3, 2")
        if r["param_checksum_diff"] != 0:
            raise AssertionError(f"params differ across ranks after the step: "
                                 f"{r['param_checksum_diff']}")
        if not (r["ef_rel"] <= MESH_EF_REL and r["ef_err_max"] > 0):
            raise AssertionError(f"EF rel {r['ef_rel']}, carried error "
                                 f"{r['ef_err_max']}")
        if r["pipe_err"] > MESH_PIPE_TOL:
            raise AssertionError(f"pipeline max |diff| {r['pipe_err']}")
        if not r["fsdp_params_gb"] < 0.6 * r["n_params"] * 4 / 1e9:
            raise AssertionError(f"FSDP rank {r['rank']} holds "
                                 f"{r['fsdp_params_gb']:.3f} GB")
    loss_rel = abs(r0["loss"] - r0["oracle_loss"]) / abs(r0["oracle_loss"])
    fsdp_loss_rel = abs(r0["fsdp_loss"] - r0["oracle_loss"]) / abs(
        r0["oracle_loss"])
    if not (loss_rel <= MESH_GRAD_REL and r0["grad_rel"] <= MESH_GRAD_REL):
        raise AssertionError(f"mesh train loss rel {loss_rel:.3e}, worst leaf "
                             f"gradient rel {r0['grad_rel']:.3e}")
    if not (fsdp_loss_rel <= MESH_GRAD_REL
            and r0["fsdp_grad_rel"] <= MESH_GRAD_REL):
        raise AssertionError(f"mesh FSDP train loss rel {fsdp_loss_rel:.3e}, "
                             f"worst leaf gradient rel "
                             f"{r0['fsdp_grad_rel']:.3e}")
    res["train"] = dict(
        loss=r0["loss"], oracle_loss=r0["oracle_loss"], loss_rel=loss_rel,
        grad_rel=r0["grad_rel"], n_params=r0["n_params"],
        launches=read_total(r["launches"] for r in tr),
        param_checksum_diff=max(r["param_checksum_diff"] for r in tr),
        step_s=[r["step_s"] for r in tr], sync_s=[r["sync_s"] for r in tr],
        ef_sync_s=[r["ef_sync_s"] for r in tr],
        sync_bytes=r0["sync_bytes"], ef_sync_bytes=r0["ef_sync_bytes"],
        ef_rel=max(r["ef_rel"] for r in tr),
        ef_err_max=max(r["ef_err_max"] for r in tr),
        peak_mem_gb=[r["peak_mem_gb"] for r in tr],
        fsdp=dict(loss=r0["fsdp_loss"], loss_rel=fsdp_loss_rel,
                  grad_rel=r0["fsdp_grad_rel"],
                  launches=read_total(r["fsdp_launches"] for r in tr),
                  params_gb=[r["fsdp_params_gb"] for r in tr],
                  peak_mem_gb=[r["fsdp_peak_mem_gb"] for r in tr],
                  step_s=[r["fsdp_step_s"] for r in tr],
                  host_copies=[r["fsdp_host_copies"] for r in tr]))
    res["pipeline"] = dict(err=max(r["pipe_err"] for r in tr),
                           s=[r["pipe_s"] for r in tr],
                           host_copies=[r["pipe_host_copies"] for r in tr],
                           **MESH_PIPE)
    t, p, f = res["train"], res["pipeline"], res["train"]["fsdp"]
    log(f"mesh (b) whisper-medium f32 ({t['n_params']} params) on (data 2), "
        f"B {MESH_TRAIN['B']} x {MESH_TRAIN['seq']} split 2 a rank: loss "
        f"{t['loss']:.6f} vs one rank {t['oracle_loss']:.6f} (rel "
        f"{loss_rel:.3e}), worst leaf gradient rel {t['grad_rel']:.3e}; "
        f"rows 1, 10 a rank 3, 2; param checksums equal ({t['param_checksum_diff']}); "
        f"step s {[round(x, 3) for x in t['step_s']]}, plain sync s "
        f"{[round(x, 3) for x in t['sync_s']]} ({t['sync_bytes']} B a rank), "
        f"EF sync s {[round(x, 3) for x in t['ef_sync_s']]} "
        f"({t['ef_sync_bytes']} B a rank: int32 codes + f32 scales), EF rel "
        f"{t['ef_rel']:.3e}, carried error max {t['ef_err_max']:.3e}; peak GB "
        f"{[round(x, 2) for x in t['peak_mem_gb']]}")
    log(f"mesh (b) under FSDP_RULES: loss {f['loss']:.6f} (rel "
        f"{fsdp_loss_rel:.3e}), worst gathered gradient leaf rel "
        f"{f['grad_rel']:.3e}; rows 1, 10 a rank 3, 2; params GB a rank "
        f"{[round(x, 3) for x in f['params_gb']]} of "
        f"{t['n_params'] * 4 / 1e9:.3f}; step s "
        f"{[round(x, 3) for x in f['step_s']]}")
    _log_ranks("(b) FSDP", [dict(rank=r["rank"], peak_mem_gb=r["fsdp_peak_mem_gb"],
                                 host_copies=r["fsdp_host_copies"]) for r in tr])
    log(f"mesh (c) pipeline 2 stages d {p['d']}, M {p['M']} x {p['mb']}: max "
        f"|diff| {p['err']:.3e} vs sequential, s {[round(x, 4) for x in p['s']]}, "
        f"host copies {p['host_copies']}")
    res["seconds"] = seconds
    log(f"mesh sub-runs s { {k: round(v, 1) for k, v in seconds.items()} }")
    return res


def read_total(counts) -> dict:
    """The launch counts of several ranks, summed per kernel."""
    out = only()
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return out


class Phases:
    """Each phase's seconds, printed as it ends and kept for the JSON."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def run(self, n, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        s = time.perf_counter() - t0
        self.seconds[f"{n} {name}"] = s
        log(f"phase {n} {name} {s:.1f}")
        return out


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    import repro_torch
    from repro_torch import configs, faults, health, models, obs, optim, quant
    from repro_torch.core import sliding
    from repro_torch.distributed.sharding import iter_leaves, map_tree
    from repro_torch.kernels import attention_decode as ad
    from repro_torch.kernels import autotune, build, ops
    from repro_torch.kernels import im2col_gemm as ig
    from repro_torch.kernels import sliding_conv1d as sc
    from repro_torch.kernels import sliding_conv2d as s2
    from repro_torch.kernels import sliding_conv_bwd as sb
    from repro_torch.kernels import sliding_conv_quant as sq
    from repro_torch.kernels import sliding_pool as sp
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve, train
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import layers, llava, mamba, moe, transformer

    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    ph = Phases()
    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = ph.run(2, "build", build.build_all)
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f}s")
    for name in sorted(libs):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # -- 3-6: serving -----------------------------------------------------------
    errs = ph.run(3, "kernels", phase_kernels, sc, ad)
    ph.run(4, "smoke_serve", phase_smoke_serve, serve, models, configs,
           map_tree)
    full = ph.run(5, "full_serve", phase_full_serve, serve, models, configs,
                  map_tree)
    # -- 7-10: training -----------------------------------------------------------
    errs["conv1d_bwd_dw"] = ph.run(7, "train_kernels", phase_train_kernels,
                                   sc, sb, ops)
    ph.run(8, "smoke_train", phase_smoke_train, models, configs, optim,
           steps_mod, train, map_tree)
    trained = ph.run(9, "full_train", phase_full_train, models, configs,
                     optim, steps_mod, train, iter_leaves)
    # -- 11-14: int8 serving ------------------------------------------------------
    errs["sliding_conv_quant"] = ph.run(11, "quant_kernels",
                                        phase_quant_kernels, sq)
    errs["attention_decode_int8"] = ph.run(12, "attention_int8",
                                           phase_attention_int8, ad)
    ph.run(13, "smoke_serve_int8", phase_smoke_serve_int8, serve, models,
           configs, map_tree, quant, sq, layers)
    full_int8 = ph.run(14, "full_serve_int8", phase_full_serve_int8, serve,
                       models, configs, quant)
    # -- 16-18: jamba serving -----------------------------------------------------
    errs.update(ph.run(16, "depthwise_kernels", phase_depthwise_kernels, sc,
                       sq, ad))
    ph.run(17, "smoke_serve_jamba", phase_smoke_serve_jamba, serve, models,
           configs, map_tree, sq)
    gc.collect()
    torch.cuda.empty_cache()  # whisper's full-width runs are done
    jamba = ph.run(18, "full_serve_jamba", phase_full_serve_jamba, serve,
                   models, configs)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 20-22: jamba training ------------------------------------------------------
    errs["conv1d_depthwise_bwd_dw"] = ph.run(
        20, "depthwise_train_kernels", phase_depthwise_train_kernels, sc, sb,
        ops)
    ph.run(21, "smoke_train_jamba", phase_smoke_train_jamba, models, configs,
           optim, steps_mod, train, map_tree, iter_leaves)
    jamba_train = ph.run(22, "full_train_jamba", phase_full_train_jamba,
                         models, configs, optim, steps_mod, train,
                         iter_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 24-26, 28-31: llava serving, fp and int8; the trained 2-D conv ----------------
    errs.update(ph.run(24, "conv2d_kernels", phase_conv2d_kernels, s2, ad))
    ph.run(25, "smoke_serve_llava", phase_smoke_serve_llava, serve, models,
           configs, map_tree, llava)
    errs.update(ph.run(28, "conv2d_quant_kernels", phase_conv2d_quant_kernels,
                       sq, ad))
    errs["conv2d_bwd_dw"] = ph.run(29, "conv2d_train_kernels",
                                   phase_conv2d_train_kernels, s2, sb, ops)
    gc.collect()
    torch.cuda.empty_cache()
    llava_serve = ph.run(26, "full_serve_llava", phase_full_serve_llava,
                         serve, models, configs, llava, iter_leaves, quant,
                         transformer)
    gc.collect()
    torch.cuda.empty_cache()
    ph.run(31, "smoke_serve_llava_int8", phase_smoke_serve_llava_int8, serve,
           models, configs, map_tree, llava, quant, transformer)
    llava_train_cli = ph.run(41, "llava_train_cli", phase_llava_train_cli,
                             train)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 42-43: the serve and train CLIs traced, on their run substrate ----------
    serve_cli_obs = ph.run(42, "serve_cli_obs", phase_serve_cli_obs, serve,
                           configs, obs, health, ops, smi)
    train_cli_obs = ph.run(43, "train_cli_obs", phase_train_cli_obs, train,
                           obs, health, ops, smi)
    # -- 51: the robustness layer's drills, on the same CLIs ---------------------
    chaos = ph.run(51, "chaos", phase_chaos, serve, train, steps_mod, configs,
                   faults, obs, health, ops, smi)
    patch_train = ph.run(30, "patch_embed_train", phase_patch_embed_train,
                         llava, transformer)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 44-46: the remaining decoders, the MoE at full width ------------------
    errs.update(ph.run(44, "attention_decoder_kernels",
                       phase_attention_decoder_kernels, ad))
    ph.run(44, "smoke_serve_decoders", phase_smoke_serve_decoders, serve,
           models, configs, map_tree)
    moe_serve = ph.run(45, "full_serve_moe", phase_full_serve_moe, serve,
                       models, configs, iter_leaves, moe)
    gc.collect()
    torch.cuda.empty_cache()
    decoders = ph.run(46, "full_serve_decoders", phase_full_serve_decoders,
                      serve, models, configs, iter_leaves)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 48-50: rwkv6-1.6b, the edge CNN and the other example ports ---------
    rwkv = ph.run(48, "rwkv6", phase_rwkv6, serve, models, configs, optim,
                  steps_mod, train, iter_leaves, map_tree)
    edge_cnn = ph.run(49, "edge_cnn", phase_edge_cnn, layers, sliding)
    examples = ph.run(50, "examples", phase_examples)
    # -- 33-34: the GEMM-convolution baselines, and their main path -------------
    errs.update(ph.run(33, "im2col_kernels", phase_im2col_kernels, ig, ops,
                       quant))
    ph.run(34, "smoke_serve_im2col", phase_smoke_serve_im2col, serve, models,
           configs, map_tree)
    baselines = ph.run(34, "baselines", phase_baselines, ops)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 36-38: pooling (rows 8, 9), the selective scan (row 16), their paths --
    errs.update(ph.run(36, "pool_kernels", phase_pool_kernels, sp))
    errs["ssm_scan"], scan_path = ph.run(37, "scan_kernels",
                                         phase_scan_kernels, ss)
    pool_path = ph.run(38, "pool_path", phase_pool_path, sp, ops)
    # -- 47: the tuning layer: tuned plans launched through ops ------------------
    tuned, tuning_launches, tune_cache = ph.run(
        47, "tuning", phase_tuning, autotune, ops, sc, s2, sq, sb, ad, sp)
    # -- 52: the analysis gate, on the cache 47 wrote ---------------------------
    analysis = ph.run(52, "analysis", phase_analysis, autotune, tune_cache)
    # -- 53: the mesh runtime, ranks sharing the card over gloo -----------------
    gc.collect()
    torch.cuda.empty_cache()
    mesh = ph.run(53, "mesh", phase_mesh, serve, models, configs, iter_leaves)

    def with_calibration(run):  # a quantized path: calibration + request
        return {k: run["calibration_launches"][k] + n
                for k, n in run["launches"].items()}

    by_path = {"serve": full["launches"], "train": trained["launches"],
               "serve_int8": with_calibration(full_int8),
               "serve_jamba": jamba["fp"]["launches"],
               "serve_jamba_int8": with_calibration(jamba["int8"]),
               "train_jamba": jamba_train["launches"],
               "serve_llava": llava_serve["launches"],
               "serve_llava_int8": with_calibration(llava_serve["int8"]),
               "train_conv2d": patch_train["launches"],
               "baselines": baselines["launches"],
               "pool": pool_path["launches"],
               "ssm_scan": scan_path["launches"],
               "tuning": tuning_launches,
               "serve_cli_obs": serve_cli_obs["launches"],
               "train_cli_obs": train_cli_obs["launches"],
               "chaos": chaos["launches"],
               "serve_qwen3_moe": moe_serve["fp"]["launches"],
               "serve_qwen3_moe_int8": moe_serve["int8"]["launches"],
               **{f"serve_{arch}": r["launches"]
                  for arch, r in decoders.items()},
               "serve_rwkv6": rwkv["serve"]["launches"],
               "train_rwkv6": rwkv["train"]["launches"],
               "edge_cnn": edge_cnn["sliding_pallas"]["launches"],
               "examples": examples["launches"],
               "mesh_qwen3_moe": mesh["moe"]["launches"],
               "mesh_train_whisper": mesh["train"]["launches"],
               "mesh_fsdp_whisper": mesh["train"]["fsdp"]["launches"],
               "mesh_tp_qwen3": mesh["qwen_serve"]["launches"],
               "mesh_tp_jamba": mesh["jamba_serve"]["launches"]}
    launches = {k: sum(p[k] for p in by_path.values()) for k in full["launches"]}
    kernels = ph.run(6, "times", phase_times, sc, ad, launches, errs)
    kernels.append(ph.run(10, "train_times", phase_train_times, sb, launches,
                          errs["conv1d_bwd_dw"]))
    # -- 15: int8 times -----------------------------------------------------------
    kernels += ph.run(15, "quant_times", phase_quant_times, sq, ad, launches,
                      errs)
    # -- 19: jamba times ----------------------------------------------------------
    dw_rows, attn_jamba = ph.run(19, "jamba_times", phase_jamba_times, sc, sq,
                                 ad, launches, errs)
    kernels += dw_rows
    # -- 23: jamba training times ----------------------------------------------------
    dw_train, fwd_z = ph.run(23, "depthwise_train_times",
                             phase_depthwise_train_times, sc, sb, launches,
                             errs["conv1d_depthwise_bwd_dw"])
    kernels.append(dw_train)
    # -- 27: llava times ----------------------------------------------------------------
    conv2d_row, attn_llava = ph.run(27, "conv2d_times", phase_conv2d_times, s2,
                                    ad, launches, errs)
    kernels.append(conv2d_row)
    # -- 32: int8 conv2d and 2-D dw times -------------------------------------------------
    conv2d_rows, attn_int8_llava = ph.run(
        32, "conv2d_quant_train_times", phase_conv2d_quant_train_times, sq,
        sb, ad, launches, errs)
    kernels += conv2d_rows
    # -- 35: the paper's comparison -----------------------------------------------
    kernels += ph.run(35, "im2col_times", phase_im2col_times, ig, sc, s2,
                      launches, errs)
    # -- 39: pooling and scan times -------------------------------------------------
    kernels += ph.run(39, "pool_times", phase_pool_times, sp, ss, mamba,
                      launches, errs)
    # -- 40: row 2 over a float32 cache ------------------------------------------------
    attn_f32 = ph.run(40, "attention_f32_times", phase_attention_f32_times, ad)
    attn_gemma = ph.run(40, "attention_gemma_times",
                        phase_attention_gemma_times, ad)
    for row in kernels:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        if row["name"] in attn_jamba:
            row["jamba_shape"] = dict(
                attn_jamba[row["name"]],
                max_abs_err=errs[row["name"] + "_jamba"])
        if row["name"] == "conv1d_depthwise":
            row["train_shape"] = fwd_z
        if row["name"] == "attention_decode":
            row["llava_shape"] = attn_llava
        if row["name"] == "attention_decode_int8":
            row["llava_shape"] = attn_int8_llava
        if row["name"] == "attention_decode":
            row["f32_cache"] = attn_f32
            row["gemma_shape"] = attn_gemma
            row["decoder_shapes_max_abs_err"] = {
                k: errs[f"attention_decode_{k}"] for k in ("qwen3_moe", "gqa4")}
        if row["name"] == "attention_decode_int8":
            row["decoder_shapes_max_abs_err"] = {
                "qwen3_moe": errs["attention_decode_int8_qwen3_moe"]}
    report_redesigned(kernels)
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels, "serve": full, "train": trained,
                      "serve_int8": full_int8, "serve_jamba": jamba,
                      "train_jamba": jamba_train, "serve_llava": llava_serve,
                      "train_conv2d": patch_train,
                      "train_llava_cli": llava_train_cli,
                      "serve_cli_obs": serve_cli_obs,
                      "train_cli_obs": train_cli_obs, "chaos": chaos,
                      "serve_qwen3_moe": moe_serve,
                      "serve_decoders": decoders,
                      "baselines": baselines,
                      "pool": pool_path, "ssm_scan": scan_path,
                      "tuned": tuned, "analysis": analysis,
                      "serve_rwkv6": rwkv["serve"],
                      "train_rwkv6": rwkv["train"], "edge_cnn": edge_cnn,
                      "examples": examples, "mesh": mesh,
                      "phase_s": ph.seconds}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
