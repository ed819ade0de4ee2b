#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ggml_experiments_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main path
gives it, then drives the main paths through the entry points a user calls,
at full width (the GRU at V=66, E=256, U=1024; MobileViT at the widths of
apple/mobilevit-small). Phases 2-5 run the committed trained
checkpoint ``checkpoints/gru_shakespeare.bin`` quantized to q8_0:

  1. device: name, power limit, kernel build seconds;
  2. ``qmatmul`` q8_0 kernel vs its plain version (M=1024 and the main
     path's M=64, f32 and bf16; two launches bit-equal), each cell's share
     of its bound and its speed against ``torch.matmul``;
  3. ``generate`` (scan path) at B=64, T=200, f32 and bf16;
  4. ``decode`` routed to the persistent kernel at B=8192, T=512, bf16, its
     tokens against the plain version's on the same inputs, two launches
     bit-equal, and the kernel teacher-forced against its plain version
     (there at bf16, and at f32 at B=1024, T=256); then each decomposition
     forced where ``decode_plan`` would not take it (slot-owned at B=512,
     unit-owned at B=4096, 64 steps), teacher-forced against the plain
     version, two launches bit-equal;
  5. ``DecodeEngine`` with the fused tick: ~1000 greedy requests, each equal
     to the offline decode; a sampling engine serving 100 requests; the tick
     kernel against its plain version on one identical tick input, and two
     launches of the greedy tick bit-equal;
  6. (printed last) one JSON line listing every kernel with its launches on
     its main-path run, its error against its plain version and its times,
     and for the persistent kernel's entries the plan that run took;
  7. the q4_0, q4_1, q5_0, q5_1 and q4_k ``qmatmul`` kernels on the same
     recurrent kernel (1024 x 3072) as phase 2, and ``generate`` at B=64,
     T=200 under each round-to-nearest format, its f32 tokens against the
     plain loop's;
  8. the calibrated ``checkpoints/gru_synth_q4km.gxt`` (q4_k cell, q8_0
     head) loaded onto the card: ``generate`` at B=64, T=200 (f32 tokens
     against the CPU run), ``decode`` at B=8192, T=512, bf16 through the
     persistent kernel's dense weight route with phase 4's checks, and an
     engine of 512 slots x 128 inner steps serving 300 greedy requests, plus
     phase 5's tick checks on that route;
  9. the persistent kernel's q4_0 weight route on ``gru_shakespeare.bin``:
     ``decode`` at B=2048, T=256, an engine and one 512 x 128 tick, with
     phase 4's and 5's checks;
 10. the ``quantize`` command writes a q5_1 ``.gxt`` that loads onto the
     card with every plane equal to the in-memory quantization; a running
     engine is snapshotted, restored, and finishes its requests equal to an
     uninterrupted engine and to the offline decode;
 11. the fused training pair (``csrc/gru_train.cu``) against its plain
     versions, bf16, with the recurrent kernel of ``gru_shakespeare.bin`` and
     the input projection of ``corpus_train.txt`` windows, at (B, T) = (1024, 100) and
     (64, 100) on the default ``train_plan``: forward ``ys`` / ``mhs``;
     backward (the recurrence, then the dWr GEMM) ``dmxs`` / ``dwr`` /
     ``dbrec`` / ``dh0`` from a seeded cotangent; the dWr kernel alone on
     equal operands; two launches on the same inputs bit-equal; each to
     ``torch.nn.GRU`` on cuDNN as the library's time; every other plan the
     kernels take there forced and held to the same checks; and the backward
     alone at (B, T) = (2048, 8) and (3000, 8), one launch of each kernel;
     then the f32 form of the pair (``csrc/gru_train_f32.cu``, 3xTF32) at
     the same two shapes on the same windows and weights: forward (each
     step's ``mh`` from the kernel's own ``h`` against the plain product,
     and the free-running ``ys``), backward and dWr as above, two launches
     bit-equal, each timed beside its 3xTF32 bound and cuDNN's f32 GRU (TF32
     off), on the default f32 plans and every other plan the f32 kernels
     take (each recurrence's own cuts (rows, units, R); each forward cut
     logged with its time and bound);
 12. training: ``train_from_text`` on ``checkpoints/corpus_train.txt``, bf16,
     B=1024, T=100, one epoch (7 steps): the loss is finite and falls, each
     step launches the forward, the backward recurrence and the dWr kernel
     once each and no plain version; the same run interrupted after 4 steps and resumed from its
     train-state file ends bit-equal; the trained weights go to a ``gru.bin``
     that ``generate`` reads back; then ``train-gru`` at its default batch of
     64 for one epoch of the corpus's first 60,000 characters, and at
     ``--batch-size 2048`` for one epoch of the whole corpus (3 steps, one
     launch of each kernel a step), whose exported weights must score a
     lower loss than the initial ones; and the same ``train_from_text`` run
     at f32 (``train-gru``'s default): one launch of each f32 kernel a step
     and no plain version, the loss falling, every step's loss within
     TRAIN_F32_LOSS_REL of the same run on the plain loop (the route before
     the f32 kernels, ``f32_train_route_off``), both median ms a step, three
     f32 steps split by ``torch.profiler``, and the f32 run interrupted after
     4 steps and resumed, bit-equal;
 13. the three vision kernels against their plain versions, at the shapes
     the main path gives them for B=128 images and on the full checkpoint's
     weights: the fused transformer layer (``csrc/transformer_layer.cu``) at
     (bp, L, C) = (512, 256, 144), (512, 64, 192), (512, 16, 240), each stage's
     first layer with its input projection, its middle layers and its last
     layer with the final LN and the conv_projection (BN, SiLU), whole and
     kernel by kernel (ln_qkv, attention, proj_ffn, each on its plain
     version's inputs, two launches bit-equal), beside
     ``nn.TransformerEncoderLayer`` and ``scaled_dot_product_attention``; flash
     attention (``csrc/flash_attention.cu``) at the same shapes in f32 and
     bf16 (two launches bit-equal), beside ``scaled_dot_product_attention``;
     the fused inverted
     residual (``csrc/inverted_residual.cu``) at (128, 64, 64, 64), E=256,
     with the residual, two launches bit-equal, beside the same block as
     three cuDNN convolutions (the library column); the route of the widths
     the strip kernel does not take (``csrc/inverted_residual_wide.cu``) at
     VIT_IR_WIDE_SHAPES (E = 384, a ragged C = 20, Cout = 264 in two
     passes), and the fused layer's wide row tiles (C past 288) at
     WIDE_LAYER_SHAPES, every flag on and none, each two launches bit-equal
     under its counters, beside its bound, its plain version and the
     library's yardstick (the cuDNN chain; ``nn.TransformerEncoderLayer``,
     with the input and output projections as ``F.linear`` where they are
     on); then these two kernels' main path, as no model of the repo has
     their widths: ``fused_inverted_residual`` and
     ``fused_transformer_layer`` once at each of those shapes, launches
     counted, each output bit-equal to its comparison's;
 14. MobileViT through the entry points on
     ``checkpoints/mobilevit_synth_full.ggml`` (256 px, hidden 144/192/240,
     2/4/3 layers, 44 labels): ``classify`` of 320 held-out images of the
     full-size task (``make_dataset``, task rev 4) in batches of 128 at f32
     unfused (``fused_layer=False``: flash, 9 launches a batch), bf16 (fused
     layer and each of its three kernels, 9 a batch), bf16 with
     ``fused_ir`` (and the inverted residual, once a batch for each block
     its gate takes: the stride-1 blocks and, on the card, the four
     stride-2 downsamplers) and f32 on the default route (the f32 fused
     layer's three kernels, 9 a batch, and the f32 fused blocks), top-1 against the labels and argmax agreement
     with the unfused f32 run; the card's f32 features of the first 32
     images on both f32 routes against the plain CPU run, within
     VIT_CPU_FEATURE_REL, their argmax the CPU's under the near-tie rule;
     the calibrated
     ``mobilevit_synth_full_q4km.gxt`` classifying the same images; the
     ``features`` command; ``extract_features`` at B=128 bf16 timed with CUDA
     events and one forward of each bf16 route split by ``torch.profiler``;
 15. the ``VisionEngine`` (ladder 8/32/128, u8 transport, bf16): 300 mixed
     classify/features requests in bursts, every 23rd canceled, each served
     result against the offline forward of the same image;
 16. GRU calibration: ``quantize --qtype q4_k_m --calibrate
     corpus_train.txt`` of ``checkpoints/gru_synth.bin`` on the card (384
     windows), its wall time split into the calibration forward with the
     Grams, the GPTQ recursion, the k-quant grid fits and the rest; its codes
     against the shipped ``gru_synth_q4km.gxt`` (made by the JAX package),
     counted; the shipped file's contract (agreement >= 0.995, relative
     delta-ppl < 0.001 on 16 held-out windows); ``eval --corpus`` timed; the
     Shakespeare ordering (q8_0 >= GPTQ q4_k_m > round-to-nearest q4_k,
     q4_k_m >= 0.95) with 128 calibration windows; phase 8's generate,
     decode and engine checks on the port-made file; GPTQ of the same H and
     W on the card and on the CPU, bit-equal;
 17. the MobileViT remainders: ``quantize --qtype q4_k_m --calibrate
     task:1234`` of ``mobilevit_synth_full.ggml`` on the card, timed by part,
     its codes against the shipped ``mobilevit_synth_full_q4km.gxt``;
     ``classify`` of phase 14's images with it at f32 (the f32 fused layer,
     or flash where it is off, and the f32 fused inverted residual) and
     bf16 (the
     fused layer): argmax agreement with the float model on the same route
     >= 319/320 with any flip at a near-tie, relative logit RMSE < 0.005 at
     f32; ``eval --qtype q4_k`` and ``q8_0`` of the ``weight.ggml``;
     ``extract_features`` at B=128, bf16 + ``fused_ir``, without activation
     storage and under f8_e5m2 (scopes early, all) and bf16 storage, timed,
     their feature noise against f32 ('early' < 0.35, 'early' < 'all' <
     0.45) and top-1; the space-to-depth stem and bf16 convolution kernels
     against the standard load, the stem's device time under
     ``torch.profiler``; ``train_model`` on ``mobilevit_synth.ggml``
     (``TINY_CLS_CONFIG``, its head drawn anew) for 20 steps at batch 100,
     the loss falling, ms per step;
 18-20. HTTP text and vision serving, the dispatch gates and ``bench``;
 21. multi-device serving: after the build the script spawns itself as
     ranks (``--rank``). Two ranks share cuda:0 over gloo (NCCL refuses two
     ranks on one device), so the figures are overhead and not scaling:
     (a) a 512 x 128 engine whose fused tick is slot-sharded (256 slots a
     rank, noise keyed on the shard's first slot), greedy requests equal to
     the offline decode, the same sampled prompts at one column of each
     shard drawing distinct streams, state digests equal, each rank's shard
     tick against its plain version with the same keys; (b) the scan tick on
     a (1, 2) mesh, gate kernels column-parallel through the qmatmul kernel
     (1024 x 1536 a rank), the head row-parallel, against ``generate``
     under the near-tie rule; (c) the data-parallel MobileViT forward, 64
     images a rank at bf16 and f32, against one process's; (d) a snapshot,
     rank 1's death, rank 0's next tick failing or stalling, and the
     snapshot restored here, finishing equal to an uninterrupted engine;
     (e) one rank over NCCL through the same engine path;
 22. training on a mesh, spawned as phase 21 spawns its ranks: phase 12's
     model (V=66, E=256, U=1024, ``init_params`` seed 0), corpus and global
     batch (B=1024, T=100, bf16). (a) ``train(..., mesh=)`` on a (2, 1)
     mesh for 4 steps, each rank's fused pair launched once a step of each
     kernel on its 512 rows, losses and the params' checksum bit-equal
     across the ranks, each step's loss and the params after the steps
     against one process's ``train`` on the same batches, then the same 4
     steps at f32 (``train-gru``'s default), each rank's f32 pair (the
     redesigned backward on its 512 rows) launched once a step of each
     kernel, against one process's f32 ``train``; (b) the same on a
     (1, 2) mesh for 3 steps, the recurrent kernel gathered for the kernels
     and each rank updating its column shards; (c) (a) interrupted after 2
     steps with a resume file a step and resumed, bit-equal to (a); (d)
     MobileViT placed by ``mobilevit_param_specs`` on (1, 2), 32 of phase
     14's images: f32 (the f32 layer route) and q8_0 features against one
     process's,
     bf16 (the fused layer on gathered weights, the fused inverted
     residual) argmax against one process's under the near-tie rule; (e)
     (a)'s 4 steps by one NCCL rank on a (1, 1) mesh, losses and params
     bit-equal to one process's. Each rank's step time (no barrier inside
     the timed window), the gradient all-reduce and the recurrent kernel's
     gather (timed apart, in an instrumented run) and the fused pair at
     B=512 beside its bound are logged; before it is timed, each rank holds
     the pair's three kernels at its B=512 (plan (16, 2)) against their
     plain versions on its first step's operands, with phase 11's limits;
 23. the f32 fused inverted residual (``csrc/inverted_residual_f32.cu``)
     through ``fused_inverted_residual(..., compute_dtype=float32)`` on the
     full checkpoint's folded weights at layer_2's shape (128, 64, 64, 64),
     E=256, with the residual, and layer_1's (128, 128, 128, 16 -> 64 ->
     32), one launch each on the main path; against its plain version
     (TF32 off), two launches bit-equal; the kernel (one call, and a CUDA
     graph's replay a call), the plain version and the cuDNN f32 chain
     timed, the tile logged;
 24. AOT artifacts through the CLI: ``aot-export --model gru`` of
     ``gru_shakespeare.bin`` at q8_0 with the CLI's defaults but the depth
     (batch 8, prompt 50, AOT_GRU_STEPS = 50 steps, not 200) and
     ``aot-run``, whose text and the artifact's tokens on params an eager
     call has used are equal to eager ``generate``'s, 50 qmatmul launches;
     ``aot-export --model mobilevit`` of ``mobilevit_synth_full.ggml``
     (256 px, batch 8) and ``aot-run``,
     the features against ``extract_features``, 9 launches of each f32 layer
     kernel through ``gxt::transformer_layer_f32`` (9 flash where the f32
     route is off) and 7 f32
     inverted-residual launches through ``gxt::inverted_residual_f32`` (the
     three stride-1 blocks on the f32 kernel, the four downsamplers on the
     stride-2 kernel); export and load seconds and the
     artifacts' bytes (no weights inside);
 25. the trace report (``tools/torch_trace_report.py`` in a process of its
     own) of an f32 MobileViT forward at B=128 and a bf16 GRU ``decode`` at
     (1024, 128): the port's kernels named by their counters with the
     launches the runs made; the native host runtime built on this host,
     its readers equal to the numpy ones;
 26. the stride-2 fused inverted residual (``csrc/inverted_residual_s2.cu``)
     through ``fused_inverted_residual(..., stride=2)`` at bf16 and f32 on
     the full checkpoint's folded weights of MobileViT-small's four
     downsamplers at B=128 (layer_2's first block, 128 x 128, 32 -> 128 ->
     64; the downsampling blocks of layers 3-5: 64 x 64, 64 -> 256 -> 96;
     32 x 32, 96 -> 384 -> 128; 16 x 16, 128 -> 512 -> 160), one launch each;
     against its plain version, two launches bit-equal; the kernel (one
     call, and a CUDA graph's replay a call), the plain version and the
     cuDNN stride-2 chain timed beside the bound, the tile logged; then
     ``extract_features`` of 128 of phase 14's images at each dtype, its
     stride-2 launches counted (four a forward where the route takes them);
 27. the port's serving tools, each once in a process of its own at a small
     setting: ``tools/torch_serving_breakdown.py`` (64 slots),
     ``tools/torch_vision_serving_soak.py`` (512 images) and
     ``tools/torch_capacity_probe.py`` (q8_0, the fused tick at 1024 slots),
     each ending in its JSON line;
 28. the f32 fused transformer layer (``csrc/transformer_layer_f32.cu``:
     ln_qkv, attention, proj_ffn at f32, every product 3xTF32) at phase
     13's shapes on the full checkpoint's weights, B=128: each stage's
     first, middle and last layer, whole and kernel by kernel on the plain
     versions' inputs, within LAYER_F32_REL of the largest value, two
     launches bit-equal; each kernel also on one and on two consumer
     warpgroups forced (two do not fit proj_ffn's block at C = 240: the
     layer is refused; the attention takes two only where its block has
     two 64-row tiles or more, L = 256) and at a ragged T = 3 x 16 rows; the
     kernels, the layer and the plain versions timed beside the 3xTF32
     bound, ``nn.TransformerEncoderLayer`` f32 (TF32 off) and
     ``scaled_dot_product_attention`` f32; then ``extract_features``
     at f32, B = 8, 32, 128, with the f32 route on and off in turns (its
     launches counted: the three kernels a layer and no flash, or flash a
     layer), the features of the two within VIT_CPU_FEATURE_REL.
 29. the examples and the three tools through their entry points, launch
     counts zeroed before each run and read after it: in process,
     ``examples/torch_generate_text.py`` (q8_0, bf16, 200 steps; its texts the
     port's own ``generate``), ``torch_serve_continuous.py`` (32 slots x 16
     inner steps on the fused tick; its texts the offline decode),
     ``torch_train_and_export.py`` (``shakespeare_train.txt``, EXAMPLE_EPOCHS
     epochs at f32 on the f32 train pair; the exported ``gru.bin`` generates),
     ``torch_extract_features.py`` (``mobilevit_synth_full.ggml``, q8_0, bf16:
     the fused layer and both inverted-residual kernels; shape (1, 8, 8,
     640)), ``torch_multichip.py`` (a (1, 1) mesh, a finite loss), then
     ``torch_extract_features.py`` as a command of its own; the golden check's
     ``features_from_named`` at 256 px on the card against the CPU, within
     VIT_CPU_FEATURE_REL; ``tools/torch_train_mobilevit_cls.py --eval-only``
     on the tiny and the full checkpoint, held to the margins of
     ``tests/test_trained_classifier.py``, its f32 argmax against the CPU's
     under the near-tie rule; the tool's ``train()`` for CLS_TRAIN's steps
     into a temporary file; ``checkpoints/`` byte for byte unchanged.
 30. MobileViT-small at 512 px, where layer_3's sequences are L = 1024
     tokens and a head's keys pass through shared memory in chunks: the
     bf16 layer attention (the streamed plan), the f32 layer attention
     (windows with a running max) and flash attention against their plain
     versions at L = 640 and 1024 on layer_3's widths, B = 128, two
     launches bit-equal, timed beside ``scaled_dot_product_attention`` and
     their bounds; the streamed plan at L = 256 bit-equal to the resident
     one, the two timed in turns; then ``classify`` of 256
     held-out 512 px images at bf16 and f32 on the default routes and at
     f32 with flash, the streamed launches
     counted; the bf16 argmax against f32 under the near-tie rule; the f32
     features of 4 images against the CPU's; ``extract_features`` at B =
     128 timed at both dtypes with a torch.profiler split (the trace tool
     in a process of its own); ``features`` and
     ``classify`` at ``--image-size 512``.
 31. the persistent kernel past its old limits (V <= 256, U a multiple of
     32), at the reference's E = 256 with weights made from a seed: at V =
     5000 ``decode()`` on each plan (slot-owned bf16 at B = 4096,
     unit-owned bf16 at 1024, unit-owned f32 at 256, 64 steps) and a 512 x
     128 engine greedy and sampled (0.8, top-k 20, top-p 0.9), each against
     its plain version under the near-tie rule and teacher-forced, launches
     counted; V = 257 slot-owned; U = 1000 unit-owned; U = 2048 on the scan
     path with no launch. Then ``train-gru`` and ``generate`` on a corpus of
     5,000 distinct characters made from a seed, that corpus's own
     vocabulary trained through ``train()`` and decoded on the kernel, and
     the bf16 vision shapes past their kernels' plans on the unfused chain
     against the CPU. Within 90 s.

Launch counts are zeroed just before each main-path run and read just after
it; comparison launches are not counted. Any failed check raises, so the
script exits non-zero before its last line, which is the JSON object
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's package beside it, it exits non-zero and prints no result.

Tolerances, and why:
  * qmatmul vs the plain product before its output cast, f32 and bf16, every
    format: the decoded weights are bit-equal, the products are exact in f32
    (bf16 operands) or f32-accurate (3xTF32), the sums are f32 in other
    orders, so 1e-5 relative. Split-K partial sums are added in a fixed
    order, so two launches on the same inputs are bit-equal.
  * Fused kernels, teacher-forced (no argmax feedback): at f32, 1e-4
    absolute on h after 256 steps (errors compound through the recurrence).
    At bf16, on the main path's shapes, h may also differ where the two
    sides' f32 sums round h to neighbouring bf16 values, and such flips
    spread through the recurrence: max error at most TF_BF16_H_MAX, mean
    error at most a set fraction of the mean distance between the plain
    version's f32 and bf16 runs, after the main path's steps and after 8
    (see the constants: set from H100 readings, so that a kernel that
    skipped the bf16 rounding fails).
  * The training pair against its plain versions: both round to bf16 at the
    same places, but sum in other orders and call other exp/tanh routines, so
    a value on a rounding boundary may land one bf16 step off and feed the
    following steps (forward) or the carry (backward). Forward: ``ys`` within
    TRAIN_YS_MAX and ``mhs`` within TRAIN_MHS_MAX (twice the H100 readings of
    0.045 and 0.125 after 100 steps of the trained recurrent kernel), and the
    mean ``ys`` error within the fractions the fused decode is held to
    (TF_BF16_MEAN_FRAC_*) of the plain version's own distance between rounding
    to bf16 and not rounding, over all steps and over the first 8. Backward,
    on equal inputs: each gradient's max |diff| over max |plain| within
    TRAIN_GRAD_REL (readings 0.002-0.006), and two launches bit-equal. The
    dWr GEMM alone against its plain version on equal operands: the same
    bf16 products, f32 sums over T*B terms in another order (the kernel runs
    of 16384 tensor-core additions added in f32, the plain version products
    of B terms added in f32): within TRAIN_DWR_REL of the largest entry;
    both sides' distance to the same sum in f64 is logged beside it.
  * The f32 training pair against its plain versions (TF32 off): 3xTF32
    products (about f32 accuracy), f32 sums in other orders, the gates by
    other exp/tanh routines. Each step's ``mh`` from the same ``h`` within
    TRAIN_F32_MH_REL of the largest; the free-running ``ys``, where the steps
    carry each other's last bits on, within TRAIN_F32_YS_MAX absolute; the
    backward on equal inputs within TRAIN_F32_GRAD_REL of each gradient's
    largest value (the carry compounds over T); dWr alone within
    TRAIN_F32_DWR_REL (runs of 4096 tensor-core additions added in f32);
    phase 12's losses within TRAIN_F32_LOSS_REL of the plain loop's, step by
    step (the weights drift apart by those last bits through Adam).
  * The vision kernels at bf16: both sides round to bf16 at the same places
    but sum in other orders and call other exp routines, so a value on a
    rounding boundary may land one bf16 step off and carry on through the
    layer. Max error within VIT_BF16_MAX of the output's largest value, mean
    error within VIT_BF16_MEAN_FRAC of the plain version's own mean distance
    between rounding to bf16 and not rounding (H100 readings and the mutants
    that skip one rounding are in PERF.md). Flash attention at f32 (3xTF32
    products, online softmax): 1e-5 relative; two launches bit-equal. The card's f32 features against the CPU: VIT_CPU_FEATURE_REL
    relative (cuDNN's and the CPU's f32 convolutions sum in other orders over
    some fifty layers). A bf16 argmax may differ from the f32 run's, and the
    engine's from the offline forward's (other batch sizes, other cuDNN
    algorithms), only where the reference's top-2 logit gap is below
    VIT_NEAR_TIE.
  * The f32 fused layer's kernels against their plain versions
    (LAYER_F32_REL): 3xTF32 products, f32 sums in other orders, the
    softmax's exponentials by ``expf`` against PyTorch's.
  * The kernels that stream a head's keys (phase 30) are held to the limits
    of their resident forms: the bf16 layer attention to VIT_BF16_MAX
    "layer" (its max and p are the plain version's bits by construction,
    tests/test_torch_long_sequences.py; only the f32 sums' order differs,
    and the share of bit-equal values is logged), the f32 one to
    LAYER_F32_REL, flash to VIT_F32_REL and VIT_BF16_MAX "flash". Chained
    over 1024 keys the tensor cores' f32 sums drift past 1e-5 of the
    largest value, so the streamed f32 kernels add a fresh sum of each
    window (32 keys in flash) into their totals in f32.
  * The f32 fused inverted residual against its plain version, at stride 1
    and 2: 3xTF32 products (f32-accurate), f32 sums in other orders, SiLUs
    within an ulp or two of each other: IR_F32_REL of the plain output's
    largest value. At bf16 the stride-2 kernel is held to the limits of the
    stride-1 one (VIT_BF16_MAX / VIT_BF16_MEAN_FRAC "ir"). The features
    artifact against ``extract_features``: the same kernels and cuDNN calls
    in the same order, AOT_FEATURE_REL of the largest feature.
  * Training on a mesh (phase 22) against one process: see MT_LOSS_REL,
    MT_PARAM_MAX and MT_PARAM_MEAN; the ranks of a run against each other, the resumed run
    against the uninterrupted one, and one NCCL rank against one process:
    bit-equal. TP MobileViT against one process: f32 and q8_0 features
    within VIT_CPU_FEATURE_REL of the largest, bf16 argmax under the
    near-tie rule.
  * A free-running greedy or sampled sequence may fork where the two best
    scores of a step lie closer than the summation-order error: the first
    divergence of every row must sit at such a near-tie of the plain
    version (score gap < 1e-3 at f32, < 0.1 at bf16, where h is rounded to
    8 mantissa bits before every product).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "gru_shakespeare.bin")
CKPT_Q4KM = os.path.join(REPO, "checkpoints", "gru_synth_q4km.gxt")
CORPUS = os.path.join(REPO, "checkpoints", "shakespeare.txt")
CORPUS_TRAIN = os.path.join(REPO, "checkpoints", "corpus_train.txt")

# the H100's peaks (HBM rate, bf16 / f32 / 3xTF32 operation rates, MUFU
# exponentials), the inverted residual's bound and its cuDNN chain (the
# library column of kernel 8), the f32 layer route's switch for a
# measurement, from the port's one source of them; a CUDA graph's time a call
try:
    from ggml_experiments_tpu_torch.utils.observability import H100 as CHIP
    from ggml_experiments_tpu_torch.utils.observability import cudnn_inverted_residual
    from ggml_experiments_tpu_torch.utils.observability import f32_layer_route_off
    from ggml_experiments_tpu_torch.utils.observability import f32_train_route_off
    from ggml_experiments_tpu_torch.utils.observability import (
        inverted_residual_bound as ir_bound,
    )
    from ggml_experiments_tpu_torch.utils.observability import transformer_layer_bound
    from ggml_experiments_tpu_torch.utils.benchmarking import graph_ms
except ImportError:     # no port beside the script: main() says so and exits 2
    CHIP = cudnn_inverted_residual = ir_bound = transformer_layer_bound = graph_ms = None
    f32_layer_route_off = f32_train_route_off = None
NEAR_TIE = {"float32": 1e-3, "bfloat16": 0.1}
# the shapes the main paths are driven at
GENERATE_SHAPE = (64, 200)           # (B, T) of the scan path
DECODE_SHAPE = (8192, 512)           # decode() through the persistent kernel
DECODE_SHAPE_Q4_0 = (2048, 256)
TF_F32_SHAPE = (1024, 256)           # teacher-forced f32 decode
ENGINE_SHAPE = (512, 128)            # (slots, inner steps)
REQUESTS, REQUESTS_SAMPLED, REQUESTS_ROUTE = 1000, 100, 300
QMATMUL_MS = (1024, 64)              # M of the qmatmul checks; the last is the main path's
# teacher-forced bf16 h against the plain version (readings on an H100 at
# the shapes below: max 0.014-0.022 after 128-512 steps; mean error 0.51 of
# the plain f32-vs-bf16 mean there, 0.09-0.10 after 8 steps; the kernel run
# at f32 instead reads a ratio of 1.0)
TF_BF16_H_MAX = 0.05
TF_BF16_SHORT = 8
TF_BF16_MEAN_FRAC_LONG, TF_BF16_MEAN_FRAC_SHORT = 0.75, 0.25
# training: (B, T) of the kernel checks; the first is the main path's
TRAIN_SHAPES = ((1024, 100), (64, 100))
TRAIN_RESUME_AFTER = 4               # steps before the interruption
TRAIN_CLI_CHARS = 60000              # corpus prefix of the default-batch CLI run
TRAIN_LARGE_SHAPES = ((2048, 8), (3000, 8))   # backward past the parent kernel's one launch
TRAIN_BIG_BATCH = 2048               # train-gru's batch past the parent kernel's one launch
FORCED_PLANS = ((("slot", 4), 512), (("unit",), 4096))   # (plan, B), 64 steps
# the training pair against its plain versions (limits: see the docstring)
TRAIN_YS_MAX, TRAIN_MHS_MAX = 0.1, 0.25
TRAIN_GRAD_REL = {"dmxs": 2e-2, "dh0": 2e-2, "dwr": 1e-2, "dbrec": 1e-2}
TRAIN_DWR_REL = 1e-4   # the dWr GEMM against its plain version on equal operands
TRAIN_KERNELS = ("fused_gru_train_fwd", "fused_gru_train_bwd", "fused_gru_train_dwr")
# the f32 pair (csrc/gru_train_f32.cu, 3xTF32) against its plain versions
# (TF32 off): each step's mh from the same h (teacher-forced) within
# TRAIN_F32_MH_REL of the largest, the free-running ys within TRAIN_F32_YS_MAX
# absolute, the backward on equal inputs within TRAIN_F32_GRAD_REL of each
# gradient's largest value, the dWr GEMM alone on equal operands within
# TRAIN_F32_DWR_REL; phase 12's f32 losses within TRAIN_F32_LOSS_REL of the
# plain loop's (see the docstring)
TRAIN_F32_KERNELS = tuple(f"{k}_f32" for k in TRAIN_KERNELS)
TRAIN_F32_MH_REL, TRAIN_F32_YS_MAX = 1e-5, 1e-4
TRAIN_F32_GRAD_REL = 1e-4
TRAIN_F32_DWR_REL = 1e-5
TRAIN_F32_LOSS_REL = 1e-4


# the vision path (phases 13-15): apple/mobilevit-small widths, trained head
VIT_CKPT = os.path.join(REPO, "checkpoints", "mobilevit_synth_full.ggml")
VIT_Q4KM = os.path.join(REPO, "checkpoints", "mobilevit_synth_full_q4km.gxt")
VIT_BATCH, VIT_IMAGES, VIT_CPU_IMAGES = 128, 320, 32
VIT_IR_SHAPE = (128, 64, 64, 64, 256, 64)     # (B, H, W, C, E, Cout) of layer_2's blocks
# shapes the strip kernel does not take, on csrc/inverted_residual_wide.cu
# (E past 256; C and Cout not multiples of 8; Cout past 256, two passes)
VIT_IR_WIDE_SHAPES = ((128, 64, 64, 64, 384, 64), (128, 64, 64, 20, 80, 24),
                      (128, 32, 32, 64, 384, 264))
VIT_ENGINE_BURSTS = (5, 8, 30, 128, 3, 100, 17, 2, 7)   # 300 requests
VIT_CANCEL_EVERY = 23
# bf16 kernels against their plain versions on the main path's shapes: max
# error within a fraction of the output's largest value, mean error within a
# fraction of the plain version's own mean distance between rounding to bf16
# and not rounding (set from H100 readings so that a kernel that skips one
# bf16 rounding fails: see the docstring)
VIT_BF16_MAX = {"layer": 0.05, "flash": 2 ** -6, "ir": 2 ** -6}
VIT_BF16_MEAN_FRAC = {"layer": 0.15, "flash": 0.1, "ir": 0.01}
# (bp, L, C, H, F) of the wide row tiles' check in phase 13 (C past 288)
WIDE_LAYER_SHAPES = ((128, 16, 320, 5, 640), (16, 48, 384, 6, 768))
WIDE_LAYER_KERNELS = ("transformer_ln_qkv_wide", "transformer_proj_ffn_wide")
VIT_F32_REL = 1e-5                 # flash at f32 against its plain version
VIT_CPU_FEATURE_REL = 1e-4         # card f32 features against the CPU plain run
VIT_NEAR_TIE = 0.1                 # bf16 logit gap under which an argmax may flip
VIT_ENGINE_FEATURE_MAX = 0.02      # engine vs offline features, x the largest feature
# calibration (phases 16, 17)
GRU_SYNTH = os.path.join(REPO, "checkpoints", "gru_synth.bin")
CORPUS_HELDOUT = os.path.join(REPO, "checkpoints", "corpus_heldout.txt")
SHAKE_TRAIN = os.path.join(REPO, "checkpoints", "shakespeare_train.txt")
SHAKE_HELD = os.path.join(REPO, "checkpoints", "shakespeare_heldout.txt")
VIT_TINY = os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml")
GRU_HELDOUT_SEQS = 16          # the JAX contract test's held-out draw (seed 0)
SHAKE_CAL_SEQS = 128           # the JAX Shakespeare test's calibration draw (seed 7)
KM_GRU_AGREE, KM_GRU_DPPL = 0.995, 0.001       # the shipped q4_k_m GRU file's contract
KM_VIT_AGREE, KM_VIT_REL = 319 / 320, 0.005    # the shipped q4_k_m vision file's contract
STORE_RUNS = (("f8_e5m2", "early"), ("f8_e5m2", "all"), ("bfloat16", "early"))
STORE_REL = {"early": 0.35, "all": 0.45}       # the JAX act-storage contracts
TRAIN_VIT_STEPS, TRAIN_VIT_BATCH, TRAIN_VIT_IMAGES = 20, 100, 1000
# HTTP serving (phases 18-19)
HTTP_ENGINE_SHAPE = (512, 128)       # (slots, inner steps): the fused tick
HTTP_REQUESTS, HTTP_CLIENTS = 64, 8
HTTP_CANCELS, HTTP_CANCEL_NEW = 4, 4096    # streams canceled by DELETE, their length
HTTP_IMAGES = 128
# multi-device serving (phase 21): two ranks share the card over gloo
MD_BACKEND = "cpu:gloo,cuda:gloo"
MD_ENGINE_SHAPE = (512, 128)         # (slots, inner steps): 256 slots a rank
MD_SAMPLED_PAIRS, MD_BACKLOG = 20, 64  # sampled prompts repeated in both shards; queued
MD_TP_SHAPE, MD_TP_REQUESTS = (64, 16), 64
MD_VIT_IMAGES = 128
MD_DIE_SLOTS, MD_DIE_REQUESTS = 128, 300
MD_NCCL_REQUESTS = 64
MD_TIMEOUT_S = {"serve": 300, "die": 20, "nccl": 300,   # a collective's time limit
                "train": 300, "train_nccl": 300}
MD_DEATH_WAIT_S = 25                 # how long the survivor's tick may take
MD_SPAWN_TIMEOUT_S = 600
MD_RANK_ARGV = [sys.executable, os.path.abspath(__file__)]   # a rank: this script, --rank
# training on a mesh (phase 22): phase 12's model, corpus and global batch
MT_STEPS = {"dp": 4, "tp": 3}        # train steps of (a) and (b)
MT_F32_STEPS = 4                     # (a) again at f32: the f32 pair on each rank's rows
MT_RESUME_AFTER = 2                  # (c): steps before the interruption
MT_TIMED_STEPS = 5                   # steps of a rank's timed window
MT_VIT_IMAGES = 32                   # (d): phase 14's first images
MT_LR = 1e-3                         # TrainConfig's learning rate
# two ranks against one process, bf16: the step's sums run in other orders
# (dWr and dbrec added over two 512-row halves, the library products over
# other row splits). Sound readings on the H100 (DP, 4 steps): loss 4.4e-07
# relative, params max |diff| 4.5e-4, mean 3.5e-7; the limits stand a few
# times above them; PERF.md gives the readings of planted faults that they
# reject. Adam hides a gradient scaled by a constant (a doubled
# sum): the CPU tests hold the gradients themselves to the JAX package's.
MT_LOSS_REL = 1e-5
MT_PARAM_MAX = 2e-3
MT_PARAM_MEAN = 3e-6
# phases 23-25: the f32 fused block at layer_2's and layer_1's shapes
# (B, H, W, C, E, Cout, residual), the artifacts, the trace report
IR_F32_SHAPES = {"layer_2": (128, 64, 64, 64, 256, 64, True),
                 "layer_1": (128, 128, 128, 16, 64, 32, False)}
IR_F32_REL = 1e-5        # f32 kernel vs plain: 3xTF32 products, f32 sums in other orders
AOT_FEATURE_REL = 1e-5   # the features artifact against extract_features, x the largest
AOT_MAX_BYTES = 1 << 20  # an artifact holds the program and no weights
AOT_GRU_STEPS = 50       # the GRU artifact's depth (the CLI's 200: 103 s of export on an H100)
TRACE_DECODE_SHAPE = (1024, 128)
# phase 26: the stride-2 fused block at MobileViT-small's four downsamplers,
# (B, H, W, C, E, Cout) of each as the model gives it a batch of VIT_BATCH
IR_S2_SHAPES = {"layer_2": (128, 128, 128, 32, 128, 64), "layer_3": (128, 64, 64, 64, 256, 96),
                "layer_4": (128, 32, 32, 96, 384, 128), "layer_5": (128, 16, 16, 128, 512, 160)}
# phase 27: each of the port's serving tools once, at a small setting
TOOLS_TIMEOUT_S = 300
# phase 28: the f32 fused layer (csrc/transformer_layer_f32.cu) against its
# plain version: 3xTF32 products (f32-accurate), f32 sums and the softmax's
# exponentials in other orders and routines: this fraction of the largest value
LAYER_F32_REL = 1e-5
LAYER_F32_BATCHES = (8, 32, 128)     # extract_features at f32, the route on and off
F32_LAYER_KERNELS = ("transformer_ln_qkv_f32", "transformer_attention_f32",
                     "transformer_proj_ffn_f32")
# phase 29: the examples and the three tools, each through its entry point
EXAMPLE_PROMPTS = ("ROMEO: ", "JULIET: ")
EXAMPLE_EPOCHS = 2                   # torch_train_and_export: 5 steps of 64 an epoch
CLS_CPU_IMAGES = {False: 500, True: 32}   # held-out images whose f32 argmax the CPU checks
CLS_TRAIN = dict(n_train=400, steps=30, batch=50)   # the classifier tool's train(), tiny
# phase 30: MobileViT-small at 512 px (layer_3 at L = 1024)
LONG_KERNEL_L = (640, 1024)          # the streamed kernels against their plain versions
LONG_IMAGES, LONG_CPU_IMAGES = 256, 4
# phase 31: the persistent kernel at vocabularies past 256 and units off 32
WIDE_VOCAB = 5000                    # distinct characters of the phase's corpus
WIDE_CORPUS_CHARS = 20000            # its length: three batches of 64 windows of 101
# decode() at V = 5000 on each plan: name suffix -> (B, T, dtype, decomposition)
WIDE_DECODE = {"": (4096, 64, "bfloat16", "slot"), "_unit": (1024, 64, "bfloat16", "unit"),
               "_f32": (256, 64, "float32", "unit")}
WIDE_TF_STEPS = 16                   # teacher-forced steps of each cell's h check
WIDE_PHASE_BUDGET_S = 90


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, n=20, warmup=3):
    """Median milliseconds of ``fn`` over ``n`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, dtype):
    """Least time (ms) for the work: bytes over HBM rate vs ops over peak."""
    return CHIP.bound_ms(nbytes, ops, dtype)


def first_divergence_near_ties(got, want, gaps, tol, what):
    """Rows of ``got``/``want`` (B, T) may fork only where the plain
    version's decision at the step before the first differing token had a
    score gap below ``tol``. Returns (token agreement, forked rows)."""
    import torch

    diff = got != want
    forked = torch.nonzero(diff.any(dim=1)).flatten().tolist()
    for r in forked:
        j = int(torch.nonzero(diff[r])[0])
        check(j > 0, f"{what}: row {r} differs at its first token")
        gap = float(gaps[r, j - 1])
        check(gap < tol, f"{what}: row {r} forks at step {j} where the plain "
                         f"version's score gap is {gap:.3g} >= {tol}")
    return float((~diff).float().mean()), len(forked)


def tf_h_check(kernel, plain, steps, what):
    """Teacher-forced runs (every step feeds the prompt) of ``kernel(cd, t)``
    -> (toks, h) against ``plain(cd, t)`` -> (toks, h, ...) at bf16, for the
    main path's ``steps`` and for TF_BF16_SHORT steps. The tokens are the
    prompt and must be equal. h must lie within TF_BF16_H_MAX, and its mean
    error within a fraction (TF_BF16_MEAN_FRAC_*) of the mean distance
    between the plain version's own f32 and bf16 runs, which is where a
    kernel that skipped the bf16 rounding lands. Returns {t: (max err, mean
    err, mean f32-vs-bf16 distance)}."""
    import torch

    out = {}
    for t, frac in ((steps, TF_BF16_MEAN_FRAC_LONG), (TF_BF16_SHORT, TF_BF16_MEAN_FRAC_SHORT)):
        toks_k, h_k = kernel(torch.bfloat16, t)
        toks_p, h_p = plain(torch.bfloat16, t)[:2]
        check(torch.equal(toks_k.int(), toks_p), f"{what} bf16 T={t}: tokens differ")
        d = (h_k - h_p).abs()
        err, mean = float(d.max()), float(d.mean())
        del h_k, d
        gap = float((plain(torch.float32, t)[1] - h_p).abs().mean())
        check(err <= TF_BF16_H_MAX and mean <= frac * gap,
              f"{what} bf16 T={t}: h max abs err {err:.3g} (limit {TF_BF16_H_MAX}), mean "
              f"{mean:.3g} (limit {frac} x {gap:.3g}, the plain version's f32-vs-bf16 mean)")
        out[t] = (err, mean, gap)
    return out


def tf_summary(res):
    return ", ".join(f"T={t}: h max abs err {e:.3g}, mean {m:.3g} (plain f32 vs bf16: "
                     f"{g:.3g})" for t, (e, m, g) in sorted(res.items(), reverse=True))


def corpus_prompts(tok, rng, n, lo, hi):
    """``n`` prompts of ``lo``..``hi`` characters cut from the corpus."""
    import numpy as np

    with open(CORPUS) as f:
        text = f.read()
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        at = int(rng.integers(0, len(text) - ln))
        out.append(np.asarray(tok.encode(text[at:at + ln]), np.int32))
    return out


def pad_batch(prompts, width):
    import numpy as np

    ids = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :p.size] = p
    return ids, np.asarray([p.size for p in prompts], np.int32)


def cdname(cd):
    return str(cd).split(".")[1]


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def qmatmul_phase(tag, qt, dev):
    """One format's qmatmul kernel against the plain product before its
    output cast, at M=1024 and the main path's M=64, f32 and bf16, with its
    times, the plain version's, ``torch.matmul`` on the dequantized plane
    and the bound from the format's own plane bytes. Returns the readings by
    (M, dtype name)."""
    import torch

    from ggml_experiments_tpu_torch.quant.qmatmul import qmatmul_cuda, qmatmul_reference
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize

    k, n = qt.shape
    out = {}
    for m in QMATMUL_MS:
        x = torch.randn((m, k), generator=torch.Generator(device=dev).manual_seed(m),
                        device=dev)
        for cd in (torch.float32, torch.bfloat16):
            cdn = cdname(cd)
            got = qmatmul_cuda(x, qt, cd)
            again = qmatmul_cuda(x, qt, cd)
            # the plain product before its output cast: bf16 operands (whose
            # products are exact in f32), f32 sums; the kernel returns f32
            want = torch.matmul(x.to(cd).float(), dequantize(qt).to(cd).float())
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            check(rel <= 1e-5, f"qmatmul {qt.qtype} M={m} {cdn}: max rel err {rel:.3g}")
            check(torch.equal(got, again), f"qmatmul {qt.qtype} M={m} {cdn}: two launches on "
                                           f"the same inputs differ")
            ms = cuda_ms(lambda: qmatmul_cuda(x, qt, cd))
            plain_ms = cuda_ms(lambda: qmatmul_reference(x, qt, cd))
            w = dequantize(qt).to(cd)
            xc = x.to(cd)
            lib_ms = cuda_ms(lambda: torch.matmul(xc, w))
            nbytes = x.numel() * 4 + qt.nbytes + m * n * 4
            # the f32 route's products run as 3xTF32 on the tensor cores
            b_ms, b_by = bound(nbytes, 2 * m * k * n, "tf32x3" if cd == torch.float32 else cdn)
            out[(m, cdn)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by)
            log(f"[{tag}] {qt.qtype} M={m} K={k} N={n} {cdn}: max abs err {err:.3g} (rel "
                f"{rel:.3g}), two launches bit-equal | kernel {ms:.4f} ms = "
                f"{100 * b_ms / ms:.1f}% of bound, {lib_ms / ms:.2f}x torch.matmul's speed | "
                f"plain {plain_ms:.4f} ms | torch.matmul on the dequantized plane {lib_ms:.4f} "
                f"ms | bound {b_ms:.4f} ms ({b_by})")
    return out


def qmatmul_entry(readings, launches):
    """The kernels-line entry of one qmatmul format: the main path's shape is
    generate at B=64, f32 and bf16; the top-level times are f32's, the bf16
    cell's are under "bfloat16", the error the larger of the two."""
    m = QMATMUL_MS[-1]
    bf = readings[(m, "bfloat16")]
    return dict(readings[(m, "float32")], launches=launches,
                max_abs_err=max(readings[(m, c)]["max_abs_err"]
                                for c in ("float32", "bfloat16")),
                bfloat16={key: bf[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")})


def decode_phase(tag, params, B, T, f32_shape, rng, tok):
    """``decode()`` routed to the persistent kernel at (B, T), bf16: launch
    count, time against the plain version and the bound, tokens against the
    plain version under the near-tie rule; then the kernel teacher-forced
    against its plain version, at bf16 on that shape and at f32 on
    ``f32_shape``. Returns the kernels-line entry."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    dev = params.device
    f32, bf16 = torch.float32, torch.bfloat16
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 32), 32)
    port.reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gru_textgen.decode(params, ids, lens, T)             # routes to the kernel
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    plan = fused.LAST_PLAN.get("fused_gru_decode")
    check(launches["fused_gru_decode"] > 0, f"{tag}: decode took the scan path: {launches}")
    wf = fused._prep_weights(params)
    v, e, u = wf.v, wf.e, wf.u
    check(toks.shape == (B, T) and int(toks.max()) < v, f"{tag}: decode output shape/range")
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    dec_ms = cuda_ms(lambda: fused.fused_gru_decode(params, ids_t, lens_t, T), n=3, warmup=1)
    # two launches on the same inputs give the same bits
    first = fused.fused_gru_decode(params, ids_t, lens_t, T, return_state=True)
    second = fused.fused_gru_decode(params, ids_t, lens_t, T, return_state=True)
    check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
          f"{tag}: two decode launches on the same inputs differ")
    del first, second
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.full((B,), T, dtype=torch.int32, device=dev)
    prompt_pad = torch.nn.functional.pad(ids_t, (0, T - ids_t.shape[1]))
    h0 = torch.zeros(B, u, device=dev)
    dec_plain_ms = cuda_ms(lambda: fused.gru_loop_reference(
        wf, prompt_pad, lens_t, tb, zb, zb, h0, T, bf16), n=1, warmup=0)
    # the main path's tokens against the plain version on the same inputs
    toks_p, _, _, _, gaps = fused.gru_loop_reference(wf, prompt_pad, lens_t, tb, zb, zb, h0,
                                                     T, bf16, margins=True)
    agree, forked = first_divergence_near_ties(toks, toks_p, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: decode() B={B} T={T} bf16")
    del toks_p, gaps
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    ops = 2 * v * e * 3 * u + 2 * B * T * (3 * u * u + u * v)
    nbytes = weight_bytes + ids.nbytes + lens.nbytes + B * T * 4
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"[{tag}] decode() B={B} T={T} bf16, {wf.mode} weight route: {dec_s:.3f} s first call, "
        f"kernel {dec_ms:.2f} ms = {dec_ms * 1e3 / T:.1f} us/step = "
        f"{B * T / dec_ms * 1e3:,.0f} tok/s | plain {dec_plain_ms:.1f} ms | bound {b_ms:.2f} ms "
        f"({b_by}) | launches {launches['fused_gru_decode']} | plan {plan} | two launches "
        f"bit-equal | tokens vs the plain version: agreement {agree:.6f}, {forked} rows fork "
        f"(all at near-ties)")

    # teacher-forced at the main path's shape and dtype: no argmax feedback,
    # so h must agree; at bf16 it may differ only where the two sides' f32
    # sums round h to neighbouring bf16 values
    tf_ids = torch.from_numpy(rng.integers(0, v, (B, T)).astype(np.int32)).to(dev)

    def steps_len(t):
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    dec_tf = tf_h_check(
        lambda cd, t: fused.fused_gru_decode(params, tf_ids[:, :t], steps_len(t), t,
                                             compute_dtype=cd, return_state=True),
        lambda cd, t: fused.gru_loop_reference(wf, tf_ids[:, :t], steps_len(t), steps_len(t),
                                               zb, zb, h0, t, cd),
        T, f"{tag}: teacher-forced decode B={B}")
    del tf_ids, h0

    # teacher-forced at f32 (the kernel's FMA path)
    Bt, Tt = f32_shape
    tf_ids = torch.from_numpy(rng.integers(0, v, (Bt, Tt)).astype(np.int32)).to(dev)
    tf_len = torch.full((Bt,), Tt, dtype=torch.int32, device=dev)
    zt = torch.zeros(Bt, dtype=torch.int32, device=dev)
    toks_k, h_k = fused.fused_gru_decode(params, tf_ids, tf_len, Tt, compute_dtype=f32,
                                         return_state=True)
    toks_p, h_p, _, _ = fused.gru_loop_reference(wf, tf_ids, tf_len, tf_len, zt, zt,
                                                 torch.zeros(Bt, u, device=dev), Tt, f32)
    h_err = float((h_k - h_p).abs().max())
    check(torch.equal(toks_k, toks_p), f"{tag}: teacher-forced decode tokens differ")
    check(h_err <= 1e-4, f"{tag}: teacher-forced decode h error {h_err:.3g} > 1e-4")
    log(f"[{tag}] teacher-forced B={B} bf16, tokens equal: {tf_summary(dec_tf)} | "
        f"teacher-forced B={Bt} T={Tt} f32: tokens equal, h max abs err {h_err:.3g}")
    return dict(launches=launches["fused_gru_decode"], max_abs_err=dec_tf[T][0], ms=dec_ms,
                plain_ms=dec_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                plan=str(plan))


def forced_plan_phase(tag, params, rng):
    """Each decomposition of the persistent kernel forced through
    ``config=`` at a batch where ``decode_plan`` takes the other one
    (FORCED_PLANS), teacher-forced against the plain version at bf16 (as
    phase 4 holds the main path), two launches bit-equal."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    dev = params.device
    wf = fused._prep_weights(params)
    T = 64
    for plan, B in FORCED_PLANS:
        check(fused.decode_plan(B, wf.u, wf.v) != fused.DecodePlan(*plan),
              f"{tag}: {plan} is already the default at B={B}")
        ids = torch.from_numpy(rng.integers(0, wf.v, (B, T)).astype(np.int32)).to(dev)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        h0 = torch.zeros(B, wf.u, device=dev)

        def lens(t):
            return torch.full((B,), t, dtype=torch.int32, device=dev)

        def kernel(cd, t):
            toks, h, _, _ = fused.gru_loop_cuda("fused_gru_decode", wf, ids[:, :t], lens(t),
                                                lens(t), z, z, h0, t, cd, config=plan)
            return toks, h

        first, second = kernel(torch.bfloat16, T), kernel(torch.bfloat16, T)
        check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
              f"{tag}: two launches of {plan} at B={B} differ")
        check(fused.LAST_PLAN["fused_gru_decode"] == fused.DecodePlan(*plan),
              f"{tag}: the launch took {fused.LAST_PLAN['fused_gru_decode']}, not {plan}")
        res = tf_h_check(kernel, lambda cd, t: fused.gru_loop_reference(
            wf, ids[:, :t], lens(t), lens(t), z, z, h0, t, cd), T,
            f"{tag}: forced {plan} B={B}")
        ms = cuda_ms(lambda: kernel(torch.bfloat16, T), n=3, warmup=1)
        log(f"[{tag}] forced plan {fused.DecodePlan(*plan)} at B={B} (default "
            f"{fused.decode_plan(B, wf.u, wf.v)}), teacher-forced bf16, tokens equal: "
            f"{tf_summary(res)} | two launches bit-equal | {ms:.2f} ms = "
            f"{ms * 1e3 / T:.1f} us/step")


def engine_phase(tag, params, n_requests, n_slots, inner, rng, tok):
    """A greedy engine on the fused tick serving ``n_requests``, each equal to
    the offline decode. Returns the tick launches of that run."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    prompts = corpus_prompts(tok, rng, n_requests, 1, 64)
    new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=torch.bfloat16, use_fused_tick=True)
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, nt) for p, nt in zip(prompts, new_toks)]
    eng.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    plan = fused.LAST_PLAN.get("fused_slot_tick")
    check(launches["fused_slot_tick"] > 0, f"{tag}: engine took the scan tick: {launches}")
    ids, lens = pad_batch(prompts, 64)
    offline = fused.fused_gru_decode(params, ids, lens, 64 + 256,
                                     compute_dtype=torch.bfloat16).cpu()
    for i, (r, p, nt) in enumerate(zip(reqs, prompts, new_toks)):
        res = r.result(timeout=0)
        check(len(res) == p.size + nt, f"{tag}: request {i}: {len(res)} tokens, want "
                                       f"{p.size + nt}")
        check(np.array_equal(res, offline[i, :p.size + nt].numpy()),
              f"{tag}: request {i}: continuous batching differs from the offline decode")
    log(f"[{tag}] {len(reqs)} greedy requests, n_slots={n_slots} inner={inner} bf16, "
        f"{fused._prep_weights(params).mode} weight route: all equal to the offline decode | "
        f"{eng_s:.3f} s, {eng.stats.tokens_generated:,} tokens delivered ({sum(new_toks):,} "
        f"generated) = {eng.stats.tokens_per_s:,.0f} tokens/s | tick launches "
        f"{launches['fused_slot_tick']}, plan {plan} | breakdown "
        f"{json.dumps(eng.stats.breakdown())}")
    return launches["fused_slot_tick"], plan


def tick_phase(tag, params, n_slots, inner, main_run, rng, tok):
    """One identical tick input through the kernel and its plain version:
    sampled (temperature 0.8, top-k 20, top-p 0.9) at f32 and bf16 under the
    near-tie rule, teacher-forced at f32 and bf16, and the greedy bf16 tick's
    time. Returns the kernels-line entry."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving.engine import init_state

    dev = params.device
    f32, bf16 = torch.float32, torch.bfloat16
    wf = fused._prep_weights(params)
    v, e, u = wf.v, wf.e, wf.u
    st = init_state(params, n_slots, 64)
    tids, tlens = pad_batch(corpus_prompts(tok, rng, n_slots, 1, 64), 64)
    st.prompt = torch.from_numpy(tids).to(dev)
    st.plen = torch.from_numpy(tlens).to(dev)
    st.total = st.plen + inner
    st.temp = torch.full((n_slots,), 0.8, device=dev)
    tick_kw = dict(enable_sampling=True, seed=12345, top_k=20, top_p=0.9)
    res = {}
    for cd in (f32, bf16):
        cdn = cdname(cd)
        s_k, t_k = fused.fused_slot_tick(params, st, inner, compute_dtype=cd, **tick_kw)
        t_p, h_p, prev_p, pos_p, gaps = fused.gru_loop_reference(
            wf, st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner, cd,
            temp=st.temp, seed=12345, top_k=20, top_p=0.9, margins=True)
        check(torch.equal(s_k.pos, pos_p), f"{tag}: tick {cdn}: cursors differ")
        agree, forked = first_divergence_near_ties(t_k.int(), t_p, gaps, NEAR_TIE[cdn],
                                                   f"{tag}: sampled tick {cdn}")
        res[cdn] = (agree, forked)
    greedy_st = init_state(params, n_slots, 64)
    greedy_st.prompt, greedy_st.plen, greedy_st.total = st.prompt, st.plen, st.total
    tick_ms = cuda_ms(lambda: fused.fused_slot_tick(params, greedy_st, inner,
                                                    compute_dtype=bf16), n=10)
    # two launches on the same inputs give the same bits
    first = fused.fused_slot_tick(params, greedy_st, inner, compute_dtype=bf16)
    second = fused.fused_slot_tick(params, greedy_st, inner, compute_dtype=bf16)
    check(torch.equal(first[1], second[1]) and all(
        torch.equal(getattr(first[0], f), getattr(second[0], f)) for f in ("h", "prev", "pos")),
        f"{tag}: two tick launches on the same inputs differ")
    del first, second
    tick_plain_ms = cuda_ms(lambda: fused.gru_loop_reference(
        wf, greedy_st.prompt, greedy_st.plen, greedy_st.total, greedy_st.prev,
        greedy_st.pos, greedy_st.h, inner, bf16), n=1, warmup=1)
    # teacher-forced tick (the prompt covers the whole tick): h must agree
    tf_st = init_state(params, n_slots, inner)
    tf_st.prompt = torch.from_numpy(rng.integers(0, v, (n_slots, inner)).astype(np.int32)).to(dev)
    tf_st.plen = torch.full((n_slots,), inner, dtype=torch.int32, device=dev)
    tf_st.total = tf_st.plen.clone()
    s_k, t_k = fused.fused_slot_tick(params, tf_st, inner, compute_dtype=f32)
    t_p, h_p, *_ = fused.gru_loop_reference(wf, tf_st.prompt, tf_st.plen, tf_st.total,
                                            tf_st.prev, tf_st.pos, tf_st.h, inner, f32)
    tick_err = float((s_k.h - h_p).abs().max())
    check(torch.equal(t_k.int(), t_p) and tick_err <= 1e-4,
          f"{tag}: teacher-forced tick: tokens equal {torch.equal(t_k.int(), t_p)}, h err "
          f"{tick_err:.3g}")

    def tf_tick(cd, t):
        s, toks_t = fused.fused_slot_tick(params, tf_st, t, compute_dtype=cd)
        return toks_t, s.h

    tick_tf = tf_h_check(tf_tick, lambda cd, t: fused.gru_loop_reference(
        wf, tf_st.prompt, tf_st.plen, tf_st.total, tf_st.prev, tf_st.pos, tf_st.h, t, cd),
        inner, f"{tag}: teacher-forced tick B={n_slots}")
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    ops = 2 * v * e * 3 * u + 2 * n_slots * inner * (3 * u * u + u * v)
    # in: prompt, plen/total/prev/pos, h; out: prev/pos, h, uint8 tokens
    nbytes = (weight_bytes + tids.nbytes + n_slots * (4 * 4 + 4 * u)
              + n_slots * (4 * 2 + 4 * u) + n_slots * inner)
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"[{tag}] one tick B={n_slots} inner={inner}, {wf.mode} weight route, sampled (0.8, "
        f"top-k 20, top-p 0.9): f32 token agreement {res['float32'][0]:.6f} "
        f"({res['float32'][1]} rows fork, at near-ties) | bf16 agreement "
        f"{res['bfloat16'][0]:.6f} ({res['bfloat16'][1]} rows fork, at near-ties) | "
        f"teacher-forced tick, tokens equal: bf16 {tf_summary(tick_tf)}; f32 T={inner}: h max "
        f"abs err {tick_err:.3g} | greedy bf16 tick kernel {tick_ms:.3f} ms, plain "
        f"{tick_plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), two launches bit-equal")
    launches, plan = main_run
    return dict(launches=launches, max_abs_err=tick_tf[inner][0], ms=tick_ms,
                plain_ms=tick_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                plan=str(plan))


def calibrated_gru_phase(tag, name, params_km, km_cpu, ids, lens, rng, tok, n_slots, inner):
    """A calibrated q4_k_m GRU (q4_k cell, q8_0 head) on the card: ``generate``
    at GENERATE_SHAPE, f32 and bf16 (the f32 tokens against the CPU run under
    the near-tie rule), ``decode`` at DECODE_SHAPE through the persistent
    kernel's dense weight route, and an engine serving REQUESTS_ROUTE
    requests with the tick checks. Returns (generate's launches, the decode
    entry, the tick entry)."""
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    f32, bf16 = torch.float32, torch.bfloat16
    B, T = GENERATE_SHAPE
    route = fused._prep_weights(params_km).mode
    check((params_km.cell.recurrent_kernel.qtype, params_km.dense_kernel.qtype, route)
          == ("q4_k", "q8_0", "dense"), f"{tag}: {name} loaded as {route}")
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    out32 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=f32)
    out16 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=bf16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    check(launches["qmatmul_q4_k"] > 0, f"{tag}: generate launched no qmatmul_q4_k: {launches}")
    check(all(o.shape == (B, T) and int(o.min()) >= 0 and int(o.max()) < 66
              for o in (out32, out16)), f"{tag}: generate output shape/range")
    ref32 = gru_textgen.generate(km_cpu, ids, lens, T, compute_dtype=f32)
    z = torch.zeros(B, dtype=torch.int32)
    tf = torch.full((B,), T, dtype=torch.int32)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(km_cpu), ref32, tf, tf, z, z,
                                        torch.zeros(B, 1024), T, f32, margins=True)
    agree, forked = first_divergence_near_ties(out32.cpu(), ref32, gaps, NEAR_TIE["float32"],
                                               f"{tag}: generate f32 cuda vs cpu")
    log(f"[{tag}] generate B={B} T={T} from {name} f32+bf16 in {gen_s:.2f} s | "
        f"qmatmul_q4_k launches {launches['qmatmul_q4_k']} | f32 tokens vs the CPU run: "
        f"agreement {agree:.6f}, {forked} rows fork (all at near-ties) | sample: "
        f"{tok.decode(out16[0].tolist())[:60]!r}")
    dec = decode_phase(tag, params_km, *DECODE_SHAPE, TF_F32_SHAPE, rng, tok)
    tick_run = engine_phase(tag, params_km, REQUESTS_ROUTE, n_slots, inner, rng, tok)
    return launches, dec, tick_phase(tag, params_km, n_slots, inner, tick_run, rng, tok)


def cudnn_gru_ms(B, T, u, dev, dtypes=None):
    """The library yardstick of the training pair: ``torch.nn.GRU(256, u)``
    on cuDNN (the same reset-after cell, gates in another order; it also
    computes the input projection), forward and ``torch.autograd.grad`` of
    its output, bf16 (fp16 where cuDNN refuses bf16), or the first of
    ``dtypes`` it takes (f32: TF32 is off). (fwd ms, bwd ms, dtype)."""
    import torch

    err = None
    for dt in dtypes or (torch.bfloat16, torch.float16):
        try:
            gru = torch.nn.GRU(256, u).to(dev, dt)
            gru.flatten_parameters()
            g = torch.Generator(device=dev).manual_seed(B)
            x = torch.randn((T, B, 256), generator=g, device=dev).to(dt).requires_grad_()
            h0 = (torch.randn((1, B, u), generator=g, device=dev) * 0.3).to(dt).requires_grad_()
            dy = (torch.randn((T, B, u), generator=g, device=dev) * 0.01).to(dt)
            leaves = [x, h0, *gru.parameters()]
            fwd = cuda_ms(lambda: gru(x, h0), n=5, warmup=1)
            out, _ = gru(x, h0)
            bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), n=5,
                          warmup=1)
            return fwd, bwd, str(dt)[6:]
        except RuntimeError as ex:
            err = ex
    raise SmokeFailure(f"torch.nn.GRU on cuDNN refused {dtypes or 'bf16 and fp16'}: {err}")


def train_bf16_gaps(mxs, h0, wr, brec, pys):
    """The yardstick of tf_h_check for the train forward: the plain version's
    own mean distance between rounding to bf16 (``pys``) and not rounding, on
    the same operands, over all T and over the first TF_BF16_SHORT steps."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    fys, _ = ft.gru_train_fwd_plain(mxs.float(), h0.float(), wr.float(), brec)
    d_f = (fys - pys.float()).abs()
    return float(d_f.mean()), float(d_f[:TF_BF16_SHORT].mean())


def train_fwd_check(tag, what, ys, mhs, pys, pmhs, gaps):
    """The train forward's (ys, mhs) against the plain version's (pys, pmhs):
    max errors within TRAIN_YS_MAX / TRAIN_MHS_MAX, mean errors within
    fractions of ``gaps`` (:func:`train_bf16_gaps`). Returns (ys max, ys mean,
    short mean, mhs max, mhs mean)."""
    gap, s_gap = gaps
    d_ys = (ys.float() - pys.float()).abs()
    ys_max, ys_mean = float(d_ys.max()), float(d_ys.mean())
    s_mean = float(d_ys[:TF_BF16_SHORT].mean())
    d_mh = (mhs.float() - pmhs.float()).abs()
    mh_max, mh_mean = float(d_mh.max()), float(d_mh.mean())
    check(ys_max <= TRAIN_YS_MAX and mh_max <= TRAIN_MHS_MAX
          and ys_mean <= TF_BF16_MEAN_FRAC_LONG * gap
          and s_mean <= TF_BF16_MEAN_FRAC_SHORT * s_gap,
          f"{tag}: {what}: ys max abs err {ys_max:.3g} (limit {TRAIN_YS_MAX}), mhs max "
          f"{mh_max:.3g} (limit {TRAIN_MHS_MAX}), ys mean {ys_mean:.3g} (limit "
          f"{TF_BF16_MEAN_FRAC_LONG} x {gap:.3g}), over the first {TF_BF16_SHORT} steps "
          f"{s_mean:.3g} (limit {TF_BF16_MEAN_FRAC_SHORT} x {s_gap:.3g})")
    return ys_max, ys_mean, s_mean, mh_max, mh_mean


def train_bwd_check(tag, what, got, again, want):
    """The train backward's (dmxs, dwr, dbrec, dh0), launched twice, against
    the plain version's: finite, bit-equal across the launches, and max
    |diff| / max |plain| within TRAIN_GRAD_REL. Returns those ratios."""
    import torch

    rel = {}
    for name, a, a2, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again, want):
        check(a.shape == w.shape and bool(torch.isfinite(a.float()).all()),
              f"{tag}: {what}: {name} shape or values")
        check(torch.equal(a, a2), f"{tag}: {what}: two launches on the same inputs give "
                                  f"different {name}")
        rel[name] = float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
        check(rel[name] <= TRAIN_GRAD_REL[name],
              f"{tag}: {what}: {name} max |diff| / max |plain| = {rel[name]:.3g} > "
              f"{TRAIN_GRAD_REL[name]}")
    return rel


def train_kernel_phase(tag, fparams, dev, tok):
    """The fused training kernels against their plain versions at
    TRAIN_SHAPES, bf16, U=1024: the trained recurrent kernel and bias, the
    input projection of corpus windows, a seeded h0 and cotangent; each plan
    the default does not take forced at those shapes; then the backward
    alone at TRAIN_LARGE_SHAPES, one launch of each kernel. Returns {(B, T):
    {"fwd": readings, "bwd": readings, "dwr": readings}}."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.ops.gru import input_projection
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples

    bf16 = torch.bfloat16
    cell = fparams.cell
    u = cell.units
    wr = cell.recurrent_kernel.to(bf16).contiguous()
    brec = cell.bias[1].float().contiguous()
    text = load_corpus(CORPUS_TRAIN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def operands(B, T):
        ex = make_examples(text, tok, DataConfig(seq_length=T))
        ids = ex[np.random.default_rng(B).permutation(len(ex))[:B], :T]
        check(ids.shape == (B, T), f"{tag}: the corpus gives {ids.shape} windows, want {(B, T)}")
        xs = fparams.embeddings[torch.from_numpy(ids.T.copy()).long().to(dev)]   # (T, B, E)
        mxs = input_projection(cell, xs, compute_dtype=bf16).contiguous()
        g = torch.Generator(device=dev).manual_seed(B)
        h0 = (torch.randn((B, u), generator=g, device=dev) * 0.3).to(bf16)
        dys = (torch.randn((T, B, u), generator=g, device=dev) * 0.01).to(bf16)
        return mxs, h0, dys

    out = {}
    for B, T in TRAIN_SHAPES:
        mxs, h0, dys = operands(B, T)
        plan = ft.train_plan(B, u, sms)
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        torch.cuda.synchronize()
        check(ft.LAST_PLAN["fused_gru_train_fwd"] == plan, f"{tag}: forward B={B} ran "
                                                           f"{ft.LAST_PLAN} for {plan}")
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        gaps = train_bf16_gaps(mxs, h0, wr, brec, pys)

        def fwd_check(ys, mhs, what):
            return train_fwd_check(tag, what, ys, mhs, pys, pmhs, gaps)

        ys_max, ys_mean, s_mean, mh_max, mh_mean = fwd_check(ys, mhs, f"forward B={B} T={T}")
        fwd_ms = cuda_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1)
        fwd_plain_ms = cuda_ms(lambda: ft.gru_train_fwd_plain(mxs, h0, wr, brec), n=2, warmup=1)
        nbytes = tensor_bytes(mxs, h0, wr, brec, ys, mhs)
        fb_ms, fb_by = bound(nbytes, 2 * T * B * u * 3 * u, "bfloat16")
        lib_fwd, lib_bwd, lib_dt = cudnn_gru_ms(B, T, u, dev)
        log(f"[{tag}] forward B={B} T={T} U={u} bf16, plan {tuple(plan)}: ys max abs err "
            f"{ys_max:.3g}, mean {ys_mean:.3g} (plain f32 vs bf16: {gaps[0]:.3g}), first "
            f"{TF_BF16_SHORT} steps mean {s_mean:.3g} (plain f32 vs bf16: {gaps[1]:.3g}) | mhs max "
            f"{mh_max:.3g}, mean {mh_mean:.3g} | kernel {fwd_ms:.3f} ms = "
            f"{fwd_ms * 1e3 / T:.1f} us/step | plain {fwd_plain_ms:.2f} ms | bound "
            f"{fb_ms:.3f} ms ({fb_by}) | library: torch.nn.GRU(256, {u}) on cuDNN ({lib_dt}) "
            f"{lib_fwd:.3f} ms")

        # backward from the plain forward's residuals, so both sides get equal inputs
        before = dict(ft.LAUNCHES)
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        check(all(ft.LAUNCHES[k] - before[k] == 1 for k in ("fused_gru_train_bwd",
                                                            "fused_gru_train_dwr")),
              f"{tag}: backward B={B} launched {before} -> {ft.LAUNCHES}")
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        rel = train_bwd_check(tag, f"backward B={B} T={T}", got, again, want)
        dmx_abs = float((got[0].float() - want[0].float()).abs().max())
        del again
        # the two kernels of the backward apart, on the plain recurrence's operands
        dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr)
        dwr_k = ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)
        dwr_p = ft.gru_train_dwr_plain(h0, pys, dmxs, plane)
        dwr_abs = float((dwr_k - dwr_p).abs().max())
        dwr_rel = dwr_abs / float(dwr_p.abs().max())
        # both sides against the same sum in f64: how far each f32 order strays
        dwr_64 = ft.gru_train_dwr_plain(h0.double(), pys.double(), dmxs.double(), plane.double())
        k64, p64 = (float((x.double() - dwr_64).abs().max()) / float(dwr_64.abs().max())
                    for x in (dwr_k, dwr_p))
        del dwr_64
        check(dwr_rel <= TRAIN_DWR_REL and torch.equal(
                  dwr_k, ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)),
              f"{tag}: dWr B={B} T={T}: max |diff| / max |plain| = {dwr_rel:.3g} (limit "
              f"{TRAIN_DWR_REL}), or two launches differ")
        rec_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        rec_plain_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr),
                               n=2, warmup=1)
        dwr_ms = cuda_ms(lambda: ft.gru_train_dwr_cuda(h0, pys, dmxs, plane), n=5, warmup=1)
        dwr_plain_ms = cuda_ms(lambda: ft.gru_train_dwr_plain(h0, pys, dmxs, plane), n=2,
                               warmup=1)
        bwd_ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        # the library's GEMM for dWr: [h0; ys[:-1]]^T . dmh in one bf16 call
        hp_all = torch.cat([h0[None], pys[:-1]]).reshape(T * B, u)
        dmh_all = torch.cat([dmxs[..., :2 * u], plane], dim=2).reshape(T * B, 3 * u)
        dwr_lib_ms = cuda_ms(lambda: torch.matmul(hp_all.t(), dmh_all), n=5, warmup=1)
        del hp_all, dmh_all
        ops = 2 * T * B * u * 3 * u
        rb_ms, rb_by = bound(tensor_bytes(mxs, pmhs, pys, dys, h0, wr, got[0], plane, got[2],
                                          got[3]), ops, "bfloat16")
        db_ms, db_by = bound(tensor_bytes(h0, pys, dmxs, plane, dwr_k), ops, "bfloat16")
        log(f"[{tag}] backward B={B} T={T} U={u} bf16, plan {tuple(plan)}: max |diff| / max "
            f"|plain|: " + ", ".join(f"{n} {rel[n]:.3g}" for n in rel)
            + f" | two launches bit-equal | recurrence + dWr {bwd_ms:.3f} ms | recurrence "
              f"{rec_ms:.3f} ms = {rec_ms * 1e3 / T:.1f} us/step, plain {rec_plain_ms:.2f} ms, "
              f"bound {rb_ms:.3f} ms ({rb_by}) | dWr {dwr_ms:.3f} ms (max |diff| / max |plain| "
              f"{dwr_rel:.3g} on equal operands; against the f64 sum: kernel {k64:.3g}, plain "
              f"{p64:.3g}; two launches bit-equal), plain "
              f"{dwr_plain_ms:.2f} ms, bound {db_ms:.3f} ms ({db_by}), torch.matmul "
              f"{dwr_lib_ms:.3f} ms | library: torch.nn.GRU backward on cuDNN ({lib_dt}) "
              f"{lib_bwd:.3f} ms")

        # every other plan, forced
        for other in ft.train_plans(B, u, sms):
            if other == plan:
                continue
            ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            ys3, _ = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            g2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            a2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            torch.cuda.synchronize()
            check(torch.equal(ys2, ys3), f"{tag}: forward B={B}, plan {tuple(other)}: two "
                                         f"launches differ")
            o_max = fwd_check(ys2, mhs2, f"forward B={B} T={T}, plan {tuple(other)}")[0]
            o_rel = train_bwd_check(tag, f"backward B={B} T={T}, plan {tuple(other)}", g2, a2, want)
            log(f"[{tag}] plan {tuple(other)} forced at B={B} T={T}: forward ys max abs err "
                f"{o_max:.3g}, backward max rel " + ", ".join(f"{n} {v:.3g}"
                                                              for n, v in o_rel.items())
                + " | two launches bit-equal")
            del ys2, mhs2, ys3, g2, a2
        out[(B, T)] = {
            "fwd": dict(max_abs_err=ys_max, ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fb_ms,
                        bound_by=fb_by, library_ms=lib_fwd, plan=tuple(plan)),
            "bwd": dict(max_abs_err=dmx_abs, ms=rec_ms, plain_ms=rec_plain_ms, bound_ms=rb_ms,
                        bound_by=rb_by, library_ms=lib_bwd, plan=tuple(plan)),
            "dwr": dict(max_abs_err=dwr_abs, ms=dwr_ms, plain_ms=dwr_plain_ms, bound_ms=db_ms,
                        bound_by=db_by, library_ms=dwr_lib_ms),
            "bwd_total_ms": bwd_ms}
        del got, want, ys, mhs, pys, pmhs, mxs, dys, dmxs, plane, dwr_k, dwr_p

    # the backward at batches the old kernel took only in row tiles: one
    # launch of each kernel on the default plan
    for B, T in TRAIN_LARGE_SHAPES:
        mxs, h0, dys = operands(B, T)
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        plan = ft.train_plan(B, u, sms)
        before = dict(ft.LAUNCHES)
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        check(all(ft.LAUNCHES[k] - before[k] == 1 for k in ("fused_gru_train_bwd",
                                                            "fused_gru_train_dwr"))
              and ft.LAST_PLAN["fused_gru_train_bwd"] == plan,
              f"{tag}: backward B={B} launched {before} -> {ft.LAUNCHES} on "
              f"{ft.LAST_PLAN.get('fused_gru_train_bwd')} for {plan}")
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        rel = train_bwd_check(tag, f"backward B={B} T={T}", got, again, want)
        ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=3, warmup=1)
        log(f"[{tag}] backward B={B} T={T} U={u} bf16, plan {tuple(plan)} (one launch of each "
            f"kernel): max |diff| / max |plain|: " + ", ".join(f"{k} {v:.3g}"
                                                              for k, v in rel.items())
            + f" | two runs bit-equal | {ms:.3f} ms")
        del got, again, want, pys, pmhs, mxs, dys
    return out


def train_f32_kernel_phase(tag, fparams, dev, tok):
    """The f32 training pair (``csrc/gru_train_f32.cu``) against its plain
    versions at TRAIN_SHAPES, U=1024, on the trained recurrent kernel and
    bias and the input projection of corpus windows, a seeded h0 and
    cotangent, on the default f32 plan and every other plan the f32 kernels
    take. Returns {(B, T): {"fwd": readings, "bwd": readings, "dwr":
    readings, "bwd_total_ms": ms}}."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.ops.gru import input_projection
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples

    f32 = torch.float32
    cell = fparams.cell
    u = cell.units
    wr = cell.recurrent_kernel.to(f32).contiguous()
    brec = cell.bias[1].float().contiguous()
    text = load_corpus(CORPUS_TRAIN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("dmxs", "dwr", "dbrec", "dh0")

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())

    def fwd_check(ys, mhs, h0, pys, what):
        """Teacher-forced mh (the plain product on the kernel's own h) and the
        free-running ys against the plain forward: (mh rel, ys max abs)."""
        hp = torch.cat([h0[None], ys[:-1]])
        mh_rel = rel(mhs, torch.matmul(hp, wr) + brec)
        ys_max = float((ys - pys).abs().max())
        del hp
        check(mhs.dtype == ys.dtype == f32 and bool(torch.isfinite(ys).all())
              and mh_rel <= TRAIN_F32_MH_REL and ys_max <= TRAIN_F32_YS_MAX,
              f"{tag}: {what}: teacher-forced mh max |diff| / max |plain| {mh_rel:.3g} (limit "
              f"{TRAIN_F32_MH_REL}), ys max abs err {ys_max:.3g} (limit {TRAIN_F32_YS_MAX})")
        return mh_rel, ys_max

    def bwd_check(got, again, want, what):
        out = {}
        for name, a, a2, w in zip(names, got, again, want):
            check(a.shape == w.shape and a.dtype == w.dtype == f32
                  and bool(torch.isfinite(a).all()), f"{tag}: {what}: {name} shape or values")
            check(torch.equal(a, a2), f"{tag}: {what}: two launches on the same inputs give "
                                      f"different {name}")
            out[name] = rel(a, w)
            check(out[name] <= TRAIN_F32_GRAD_REL, f"{tag}: {what}: {name} max |diff| / max "
                                                   f"|plain| = {out[name]:.3g} > "
                                                   f"{TRAIN_F32_GRAD_REL}")
        return out

    out = {}
    for B, T in TRAIN_SHAPES:
        ex = make_examples(text, tok, DataConfig(seq_length=T))
        ids = ex[np.random.default_rng(B).permutation(len(ex))[:B], :T]
        xs = fparams.embeddings[torch.from_numpy(ids.T.copy()).long().to(dev)]
        mxs = input_projection(cell, xs, compute_dtype=f32).contiguous()
        g = torch.Generator(device=dev).manual_seed(B)
        h0 = torch.randn((B, u), generator=g, device=dev) * 0.3
        dys = torch.randn((T, B, u), generator=g, device=dev) * 0.01
        del xs
        plan = ft.train_plan(B, u, sms, dtype=f32)
        bplan = ft.train_plan(B, u, sms, dtype=f32, part="bwd")
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        torch.cuda.synchronize()
        check(ft.LAST_PLAN["fused_gru_train_fwd_f32"] == plan
              and torch.equal(ys, ys2) and torch.equal(mhs, mhs2),
              f"{tag}: f32 forward B={B} ran {ft.LAST_PLAN} for {plan}, or two launches differ")
        del ys2, mhs2
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        mh_rel, ys_max = fwd_check(ys, mhs, h0, pys, f"f32 forward B={B} T={T}")
        fwd_ms = cuda_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1)
        fwd_plain_ms = cuda_ms(lambda: ft.gru_train_fwd_plain(mxs, h0, wr, brec), n=2, warmup=1)
        ops = 2 * T * B * u * 3 * u
        fb_ms, fb_by = bound(tensor_bytes(mxs, h0, wr, brec, ys, mhs), ops, "tf32x3")
        lib_fwd, lib_bwd, lib_dt = cudnn_gru_ms(B, T, u, dev, (f32,))
        log(f"[{tag}] f32 forward B={B} T={T} U={u}, cut {tuple(plan)} (rows, units, row tiles): "
            f"teacher-forced mh max "
            f"|diff| / max |plain| {mh_rel:.3g}, free-running ys max abs err {ys_max:.3g} | two "
            f"launches bit-equal | kernel {fwd_ms:.3f} ms = {fwd_ms * 1e3 / T:.1f} us/step | "
            f"plain {fwd_plain_ms:.2f} ms | bound {fb_ms:.3f} ms ({fb_by}, 3xTF32) | library: "
            f"torch.nn.GRU(256, {u}) on cuDNN ({lib_dt}, TF32 off) {lib_fwd:.3f} ms")

        # backward from the plain forward's residuals, so both sides get equal inputs
        before = dict(ft.LAUNCHES)
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        check(all(ft.LAUNCHES[k] - before[k] == (k in TRAIN_F32_KERNELS[1:])
                  for k in ft.LAUNCHES) and ft.LAST_PLAN["fused_gru_train_bwd_f32"] == bplan,
              f"{tag}: f32 backward B={B} launched {before} -> {ft.LAUNCHES}, plan "
              f"{ft.LAST_PLAN.get('fused_gru_train_bwd_f32')} for {bplan}")
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        grel = bwd_check(got, again, want, f"f32 backward B={B} T={T}")
        dmx_abs = float((got[0] - want[0]).abs().max())
        del again
        dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr)
        dwr_k = ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)
        dwr_p = ft.gru_train_dwr_plain(h0, pys, dmxs, plane)
        dwr_abs = float((dwr_k - dwr_p).abs().max())
        dwr_rel = rel(dwr_k, dwr_p)
        dwr_64 = ft.gru_train_dwr_plain(h0.double(), pys.double(), dmxs.double(), plane.double())
        k64, p64 = rel(dwr_k, dwr_64), rel(dwr_p, dwr_64)
        del dwr_64
        check(dwr_rel <= TRAIN_F32_DWR_REL and torch.equal(
                  dwr_k, ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)),
              f"{tag}: f32 dWr B={B} T={T}: max |diff| / max |plain| = {dwr_rel:.3g} (limit "
              f"{TRAIN_F32_DWR_REL}), or two launches differ")
        rec_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        rec_plain_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr),
                               n=2, warmup=1)
        dwr_ms = cuda_ms(lambda: ft.gru_train_dwr_cuda(h0, pys, dmxs, plane), n=5, warmup=1)
        dwr_plain_ms = cuda_ms(lambda: ft.gru_train_dwr_plain(h0, pys, dmxs, plane), n=2,
                               warmup=1)
        bwd_ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        hp_all = torch.cat([h0[None], pys[:-1]]).reshape(T * B, u)
        dmh_all = torch.cat([dmxs[..., :2 * u], plane], dim=2).reshape(T * B, 3 * u)
        dwr_lib_ms = cuda_ms(lambda: torch.matmul(hp_all.t(), dmh_all), n=5, warmup=1)
        del hp_all, dmh_all
        rb_ms, rb_by = bound(tensor_bytes(mxs, pmhs, pys, dys, h0, wr, got[0], plane, got[2],
                                          got[3]), ops, "tf32x3")
        db_ms, db_by = bound(tensor_bytes(h0, pys, dmxs, plane, dwr_k), ops, "tf32x3")
        log(f"[{tag}] f32 backward B={B} T={T} U={u}, plan {tuple(bplan)} (rows, units, row "
            f"tiles), dWr in {ft.LAST_PLAN['fused_gru_train_dwr_f32']} K partitions: max |diff| / max "
            f"|plain|: " + ", ".join(f"{n} {grel[n]:.3g}" for n in grel)
            + f" | two launches bit-equal | recurrence + dWr {bwd_ms:.3f} ms | recurrence "
              f"{rec_ms:.3f} ms = {rec_ms * 1e3 / T:.1f} us/step, plain {rec_plain_ms:.2f} ms, "
              f"bound {rb_ms:.3f} ms ({rb_by}) | dWr {dwr_ms:.3f} ms (max |diff| / max |plain| "
              f"{dwr_rel:.3g} on equal operands; against the f64 sum: kernel {k64:.3g}, plain "
              f"{p64:.3g}; two launches bit-equal), plain {dwr_plain_ms:.2f} ms, bound "
              f"{db_ms:.3f} ms ({db_by}), torch.matmul f32 {dwr_lib_ms:.3f} ms | library: "
              f"torch.nn.GRU backward on cuDNN ({lib_dt}, TF32 off) {lib_bwd:.3f} ms")

        # every other f32 plan, forced: the forward's cuts, then the backward's
        for other in ft.train_plans(B, u, sms, dtype=f32):
            if other == plan:
                continue
            ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            ys3, _ = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            torch.cuda.synchronize()
            check(torch.equal(ys2, ys3) and ft.LAST_PLAN["fused_gru_train_fwd_f32"] == other,
                  f"{tag}: f32 forward B={B}, plan {tuple(other)}: two launches differ")
            o_mh, o_ys = fwd_check(ys2, mhs2, h0, pys, f"f32 forward B={B} T={T}, plan "
                                                       f"{tuple(other)}")
            o_fwd = cuda_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other), n=3,
                            warmup=1)
            log(f"[{tag}] f32 forward cut {tuple(other)} forced at B={B} T={T}: mh {o_mh:.3g}, "
                f"ys {o_ys:.3g} | two launches bit-equal | {o_fwd:.3f} ms, bound {fb_ms:.3f} ms "
                f"({fb_by})")
            del ys2, mhs2, ys3
        for other in ft.train_plans(B, u, sms, dtype=f32, part="bwd"):
            if other == bplan:
                continue
            g2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            a2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            torch.cuda.synchronize()
            check(ft.LAST_PLAN["fused_gru_train_bwd_f32"] == other,
                  f"{tag}: f32 backward B={B} ran {ft.LAST_PLAN} for {tuple(other)}")
            o_rel = bwd_check(g2, a2, want, f"f32 backward B={B} T={T}, plan {tuple(other)}")
            o_rec = cuda_ms(lambda: ft.gru_train_bwd_rec_cuda(mxs, pmhs, pys, dys, h0, wr,
                                                              config=other), n=3, warmup=1)
            log(f"[{tag}] f32 backward plan {tuple(other)} forced at B={B} T={T}: max rel "
                + ", ".join(f"{n} {v:.3g}" for n, v in o_rel.items())
                + f" | two launches bit-equal | recurrence {o_rec:.3f} ms")
            del g2, a2
        out[(B, T)] = {
            "fwd": dict(max_abs_err=ys_max, ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fb_ms,
                        bound_by=fb_by, library_ms=lib_fwd, plan=tuple(plan)),
            "bwd": dict(max_abs_err=dmx_abs, ms=rec_ms, plain_ms=rec_plain_ms, bound_ms=rb_ms,
                        bound_by=rb_by, library_ms=lib_bwd, plan=tuple(bplan)),
            "dwr": dict(max_abs_err=dwr_abs, ms=dwr_ms, plain_ms=dwr_plain_ms, bound_ms=db_ms,
                        bound_by=db_by, library_ms=dwr_lib_ms,
                        plan=ft.LAST_PLAN["fused_gru_train_dwr_f32"]),
            "bwd_total_ms": bwd_ms}
        del got, want, ys, mhs, pys, pmhs, mxs, dys, dmxs, plane, dwr_k, dwr_p
        torch.cuda.empty_cache()
    return out


def params_equal(a, b):
    import torch

    from ggml_experiments_tpu_torch.training.gru_trainer import param_leaves

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(param_leaves(a), param_leaves(b)))


def profiled_step_shares(step, n):
    """``n`` calls of ``step()`` under ``torch.profiler``: device ms a step by
    kernel group, and the device's idle share of the window's wall clock.
    Returns None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ggml_experiments_tpu_torch.utils.trace_report import kernel_name

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {"fused_gru_train_bwd": "backward kernel", "fused_gru_train_dwr": "dWr kernel",
               "fused_gru_train_fwd": "forward kernel"}
    kernels.update({f"{k}_f32": v for k, v in kernels.items()})
    groups = {**{g: 0.0 for g in kernels.values()}, "library products": 0.0,
              "other device work": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue    # an operator's row repeats its kernels' time
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / n
        group = kernels.get(kernel_name(e.key))
        if group:
            groups[group] += ms
        elif any(w in e.key for w in ("gemm", "nvjet", "cutlass", "cublas")):
            groups["library products"] += ms
        else:
            groups["other device work"] += ms
    busy = sum(groups.values())
    if busy <= 0.0:
        return None
    return dict(groups, wall_ms=wall_ms, busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall_ms))


def train_phase(tag, dev, tok, kernel_ms):
    """The training main path at full width, bf16 (see the module docstring,
    12). ``kernel_ms`` is (forward, backward recurrence + dWr) kernel time
    at the main shape, for the step's breakdown. Returns the kernels'
    launches on the main run and {step_ms, final_loss, adam_ms} of it."""
    import contextlib
    import io

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params, save_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.training import TrainConfig, train, train_from_text
    from ggml_experiments_tpu_torch.training.data import (
        DataConfig,
        batches,
        load_corpus,
        make_examples,
    )
    from ggml_experiments_tpu_torch.training.gru_trainer import (
        adam_init,
        adam_update,
        loss_fn,
        make_train_step,
        param_leaves,
    )

    bf16 = torch.bfloat16
    B, T = TRAIN_SHAPES[0]
    text = load_corpus(CORPUS_TRAIN)
    data = DataConfig(seq_length=T, batch_size=B)
    tc = TrainConfig(epochs=1, log_every=1, compute_dtype=bf16)
    n_steps = len(make_examples(text, tok, data)) // B
    check(n_steps >= TRAIN_RESUME_AFTER + 2, f"{tag}: the corpus gives only {n_steps} batches")

    port.reset_kernel_launches()
    for k in ft.PLAIN_CALLS:
        ft.PLAIN_CALLS[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, history, _ = train_from_text(text, model_config=GRUConfig(), train_config=tc,
                                         data_config=data, seed=0)
    torch.cuda.synchronize()
    launches = port.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    check(params.device.type == "cuda" and params.cell.recurrent_kernel.shape == (1024, 3072),
          f"{tag}: trained params are not the full-width model on the card")
    check(len(history) == n_steps and all(np.isfinite(losses)),
          f"{tag}: {len(history)} steps logged of {n_steps}, losses {losses}")
    check(losses[-1] < losses[0] - 0.15, f"{tag}: the loss did not fall: {losses}")
    check(all(launches[k] == n_steps for k in TRAIN_KERNELS) and not any(ft.PLAIN_CALLS.values()),
          f"{tag}: {n_steps} steps launched {launches}, plain-version runs {ft.PLAIN_CALLS}")
    # steady-state step time: the history's clock stops after each step's loss
    # was read back; the first step also loads the kernels
    steps_s = np.diff([h["elapsed_s"] for h in history])
    step_ms = float(np.median(steps_s)) * 1e3
    # Adam alone, on a scratch copy of the model with seeded gradients
    scratch = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(1), device=dev)
    leaves = [t.requires_grad_(True) for _, t in param_leaves(scratch)]
    grads = [torch.randn_like(t) for t in leaves]
    adam = adam_init(scratch)[0]
    adam_ms = cuda_ms(lambda: adam_update(scratch, grads, adam, 1e-3), n=5, warmup=1)
    # three more steps on the scratch model under the profiler
    step_fn = make_train_step(1e-3, compute_dtype=bf16)
    inp, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(iter(batches(
        make_examples(text, tok, data), data, seed=0))))
    before = port.kernel_launches()
    prof = profiled_step_shares(lambda: step_fn(scratch, (adam,), inp, tgt), 3)
    after = port.kernel_launches()
    check(all(after[k] - before[k] == 3 for k in TRAIN_KERNELS),
          f"{tag}: the profiled steps launched {before} -> {after}")
    del grads, adam, scratch, inp, tgt
    rest_ms = step_ms - sum(kernel_ms) - adam_ms
    log(f"[{tag}] train_from_text corpus_train.txt bf16 B={B} T={T} E=256 U=1024: {n_steps} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} | launches fwd "
        f"{launches['fused_gru_train_fwd']} bwd {launches['fused_gru_train_bwd']} dWr "
        f"{launches['fused_gru_train_dwr']}, plain-version runs 0 | {step_ms:.2f} ms/step "
        f"(median of {len(steps_s)}, loss read back each step) = "
        f"{B * T / step_ms * 1e3:,.0f} tokens/s | of a step: forward kernel {kernel_ms[0]:.2f} "
        f"ms, backward kernels {kernel_ms[1]:.2f} ms, Adam {adam_ms:.2f} ms, the rest (input "
        f"projection, vocab head, their gradients, loss, host) {rest_ms:.2f} ms | peak device "
        f"memory {peak_gb:.2f} GB")
    if prof is None:
        log(f"[{tag}] torch.profiler recorded no device time: the step is not split further")
    else:
        log(f"[{tag}] 3 steps under torch.profiler: {prof['wall_ms']:.2f} ms/step wall, device "
            f"busy {prof['busy_ms']:.2f} ms/step (idle share {prof['idle_share']:.3f}): "
            + ", ".join(f"{k} {prof[k]:.2f} ms" for k in ("backward kernel", "dWr kernel",
                                                          "forward kernel", "library products",
                                                          "other device work")))

    # the same run through train(), whole and interrupted + resumed
    def fresh():
        init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
        return init, list(batches(make_examples(text, tok, data), data, seed=0, epochs=1))

    with tempfile.TemporaryDirectory() as tmp:
        init, stream = fresh()
        whole, _ = train(init, stream, tc)
        check(params_equal(whole, params), f"{tag}: train() and train_from_text() differ on the "
                                           f"same seed: the step is not reproducible")
        ck = os.path.join(tmp, "resume.gxt")
        tcr = TrainConfig(epochs=1, log_every=1, compute_dtype=bf16, resume_path=ck,
                          save_every=TRAIN_RESUME_AFTER - 1)
        train(init, stream[:TRAIN_RESUME_AFTER], tcr)
        size = os.path.getsize(ck)
        resumed, hist = train(init, stream, tcr)
        check(hist[0]["step"] == TRAIN_RESUME_AFTER, f"{tag}: resumed at step {hist[0]['step']}")
        check(params_equal(resumed, params), f"{tag}: the resumed run's parameters differ from "
                                             f"the uninterrupted run's")
        log(f"[{tag}] interrupted after {TRAIN_RESUME_AFTER} steps, resumed from its train-state "
            f"file ({size:,} bytes, saved after step {TRAIN_RESUME_AFTER - 1}) at step "
            f"{hist[0]['step']}: all {len(leaves)} parameter tensors bit-equal to the "
            f"uninterrupted run, and train() bit-equal to train_from_text()")
        del whole, resumed, init, stream

        # export and read back
        out = os.path.join(tmp, "gru.bin")
        save_gru_params(out, params)
        back = load_gru_params(out, qtype="q8_0", device=dev)
        ids, lens = tok.encode_batch(["ROMEO:", "the ", "What"])
        toks = gru_textgen.generate(back, ids, lens, 100)
        check(toks.shape == (3, 100) and int(toks.min()) >= 0 and int(toks.max()) < 66,
              f"{tag}: generate from the exported gru.bin: shape/range")
        log(f"[{tag}] exported gru.bin ({os.path.getsize(out):,} bytes) -> generate (q8_0) "
            f"after {n_steps} steps of training: {tok.decode(toks[0].tolist())[:60]!r}")
        del back

        # the command at its default batch size
        small = os.path.join(tmp, "corpus.txt")
        with open(small, "w") as f:
            f.write(text[:TRAIN_CLI_CHARS])
        cli_out = os.path.join(tmp, "cli_gru.bin")
        before = port.kernel_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train-gru", "--corpus", small, "--epochs", "1", "--compute",
                           "bfloat16", "--log-every", "1", "--output", cli_out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        after = port.kernel_launches()
        summary = json.loads(buf.getvalue().splitlines()[-1])
        cli_steps = (TRAIN_CLI_CHARS // 101) // 64
        check(rc == 0 and summary["steps"] == cli_steps - 1
              and np.isfinite(summary["final_loss"]) and os.path.exists(cli_out),
              f"{tag}: train-gru: rc {rc}, summary {summary}")
        check(all(after[k] - before[k] == cli_steps for k in TRAIN_KERNELS)
              and not any(ft.PLAIN_CALLS.values()),
              f"{tag}: train-gru launched {before} -> {after}")
        log(f"[{tag}] train-gru at its defaults (B=64, T=100, E=256, U=1024) bf16, "
            f"{cli_steps} steps on the corpus's first {TRAIN_CLI_CHARS:,} characters: "
            f"{json.dumps(summary)} in {cli_s:.2f} s | one forward, one backward and one dWr "
            f"launch a step, plan {tuple(ft.train_plan(64, 1024))}")

        # the command at a batch past one backward launch's shared memory
        big_out = os.path.join(tmp, "big_gru.bin")
        big = DataConfig(seq_length=T, batch_size=TRAIN_BIG_BATCH)
        big_steps = len(make_examples(text, tok, big)) // TRAIN_BIG_BATCH
        plan = ft.train_plan(TRAIN_BIG_BATCH, 1024)
        before = port.kernel_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train-gru", "--corpus", CORPUS_TRAIN, "--epochs", "1", "--compute",
                           "bfloat16", "--batch-size", str(TRAIN_BIG_BATCH), "--log-every", "1",
                           "--output", big_out])
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t0
        after = port.kernel_launches()
        summary = json.loads(buf.getvalue().splitlines()[-1])
        check(rc == 0 and summary["steps"] == big_steps - 1 and np.isfinite(summary["final_loss"])
              and os.path.exists(big_out), f"{tag}: train-gru B={TRAIN_BIG_BATCH}: rc {rc}, "
                                           f"summary {summary}")
        check(all(after[k] - before[k] == big_steps for k in TRAIN_KERNELS)
              and not any(ft.PLAIN_CALLS.values()),
              f"{tag}: train-gru B={TRAIN_BIG_BATCH} launched {before} -> {after}")
        # its loss falls: the exported weights against the initial ones (the
        # command's seed 0) on the corpus's first windows
        inp, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(iter(
            batches(make_examples(text, tok, DataConfig(seq_length=T, batch_size=256)),
                    DataConfig(seq_length=T, batch_size=256), seed=1))))
        init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
        trained = load_gru_params(big_out, device=dev)
        with torch.no_grad():
            loss0, loss1 = (float(loss_fn(p, inp, tgt)) for p in (init, trained))
        check(loss1 < loss0, f"{tag}: train-gru B={TRAIN_BIG_BATCH}: loss {loss0:.4f} before, "
                             f"{loss1:.4f} after")
        log(f"[{tag}] train-gru --batch-size {TRAIN_BIG_BATCH} bf16, {big_steps} steps on "
            f"corpus_train.txt: {json.dumps(summary)} in {big_s:.2f} s | launches fwd "
            f"{after['fused_gru_train_fwd'] - before['fused_gru_train_fwd']}, bwd "
            f"{after['fused_gru_train_bwd'] - before['fused_gru_train_bwd']}, dWr "
            f"{after['fused_gru_train_dwr'] - before['fused_gru_train_dwr']} (one each a step, "
            f"plan {tuple(plan)}) | loss on 256 corpus windows: {loss0:.4f} initial -> {loss1:.4f} "
            f"exported")
        del init, trained
    return launches, dict(step_ms=step_ms, final_loss=losses[-1], adam_ms=adam_ms)


def train_f32_phase(tag, dev, tok, kernel32_ms, bf16_run):
    """Phase 12 at f32, ``train-gru``'s default (see the module docstring,
    12). ``kernel32_ms`` is the f32 (forward, backward recurrence + dWr)
    kernel time at the main shape, ``bf16_run`` what :func:`train_phase`
    returned of the bf16 run. Returns the kernels' launches on the f32 main
    run."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.training import TrainConfig, train, train_from_text
    from ggml_experiments_tpu_torch.training.data import (
        DataConfig,
        batches,
        load_corpus,
        make_examples,
    )
    from ggml_experiments_tpu_torch.training.gru_trainer import (
        adam_init,
        make_train_step,
        param_leaves,
    )

    B, T = TRAIN_SHAPES[0]
    text = load_corpus(CORPUS_TRAIN)
    data = DataConfig(seq_length=T, batch_size=B)
    n_steps = len(make_examples(text, tok, data)) // B
    step_ms, adam_ms = bf16_run["step_ms"], bf16_run["adam_ms"]
    # f32 (train-gru's default): the f32 kernels, one launch of each a step,
    # no plain version; the same run on the plain loop (the route before the
    # f32 kernels) as the reference of every step's loss
    f32 = torch.float32
    tc32 = TrainConfig(epochs=1, log_every=1, compute_dtype=f32)
    before, plain_before = port.kernel_launches(), dict(ft.PLAIN_CALLS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params32, hist32, _ = train_from_text(text, model_config=GRUConfig(), train_config=tc32,
                                          data_config=data, seed=0)
    torch.cuda.synchronize()
    peak32_gb = torch.cuda.max_memory_allocated() / 1e9
    after = port.kernel_launches()
    launches32 = {k: after[k] - before[k] for k in after}
    losses32 = [h["loss"] for h in hist32]
    check(len(hist32) == n_steps and all(np.isfinite(losses32))
          and losses32[-1] < losses32[0] - 0.15,
          f"{tag}: f32 training: {len(hist32)} steps, losses {losses32}")
    check(all(launches32[k] == n_steps for k in TRAIN_F32_KERNELS)
          and not any(launches32[k] for k in TRAIN_KERNELS) and ft.PLAIN_CALLS == plain_before,
          f"{tag}: f32 training, {n_steps} steps, launched {launches32}, plain-version runs "
          f"{plain_before} -> {ft.PLAIN_CALLS}")
    step32_ms = float(np.median(np.diff([h["elapsed_s"] for h in hist32]))) * 1e3
    with f32_train_route_off():
        before = port.kernel_launches()
        _, href, _ = train_from_text(text, model_config=GRUConfig(), train_config=tc32,
                                     data_config=data, seed=0)
        torch.cuda.synchronize()
        after = port.kernel_launches()
    lref = [h["loss"] for h in href]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses32, lref))
    check(after == before and len(lref) == n_steps and loss_rel <= TRAIN_F32_LOSS_REL,
          f"{tag}: f32 on the kernels against the plain loop: losses {losses32} / {lref}, max "
          f"relative {loss_rel:.3g} (limit {TRAIN_F32_LOSS_REL}); the plain-loop run launched "
          f"{before} -> {after}")
    stepref_ms = float(np.median(np.diff([h["elapsed_s"] for h in href]))) * 1e3
    del href
    # three more f32 steps on a scratch model under the profiler
    scratch = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(1), device=dev)
    for _, t in param_leaves(scratch):
        t.requires_grad_(True)
    adam = adam_init(scratch)[0]
    step_fn = make_train_step(1e-3, compute_dtype=f32)
    inp, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(iter(batches(
        make_examples(text, tok, data), data, seed=0))))
    before = port.kernel_launches()
    prof32 = profiled_step_shares(lambda: step_fn(scratch, (adam,), inp, tgt), 3)
    after = port.kernel_launches()
    check(all(after[k] - before[k] == 3 for k in TRAIN_F32_KERNELS),
          f"{tag}: the profiled f32 steps launched {before} -> {after}")
    del adam, scratch, inp, tgt
    rest32_ms = step32_ms - sum(kernel32_ms) - adam_ms
    log(f"[{tag}] train_from_text corpus_train.txt f32 B={B} T={T} E=256 U=1024: {n_steps} steps, "
        f"loss {losses32[0]:.4f} -> {losses32[-1]:.4f} (bf16: {bf16_run['final_loss']:.4f}) | "
        f"launches fwd "
        f"{launches32['fused_gru_train_fwd_f32']} bwd {launches32['fused_gru_train_bwd_f32']} "
        f"dWr {launches32['fused_gru_train_dwr_f32']} (f32 kernels), plain-version runs 0 | "
        f"{step32_ms:.2f} ms/step (median of {len(hist32) - 1}) = "
        f"{B * T / step32_ms * 1e3:,.0f} tokens/s, {step32_ms / step_ms:.2f}x the bf16 step's "
        f"{step_ms:.2f} ms | of a step: forward kernel {kernel32_ms[0]:.2f} ms, backward kernels "
        f"{kernel32_ms[1]:.2f} ms, Adam {adam_ms:.2f} ms, the rest {rest32_ms:.2f} ms | peak "
        f"device memory {peak32_gb:.2f} GB | the same run on the plain loop: {stepref_ms:.2f} "
        f"ms/step ({stepref_ms / step32_ms:.2f}x), losses {lref[0]:.4f} -> {lref[-1]:.4f}, every "
        f"step's within {loss_rel:.3g} relative")
    if prof32 is None:
        log(f"[{tag}] torch.profiler recorded no device time: the f32 step is not split further")
    else:
        log(f"[{tag}] 3 f32 steps under torch.profiler: {prof32['wall_ms']:.2f} ms/step wall, "
            f"device busy {prof32['busy_ms']:.2f} ms/step (idle share "
            f"{prof32['idle_share']:.3f}): "
            + ", ".join(f"{k} {prof32[k]:.2f} ms" for k in ("backward kernel", "dWr kernel",
                                                            "forward kernel", "library products",
                                                            "other device work")))
    # an f32 run interrupted after TRAIN_RESUME_AFTER steps and resumed
    with tempfile.TemporaryDirectory() as tmp:
        init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
        stream = list(batches(make_examples(text, tok, data), data, seed=0, epochs=1))
        ck = os.path.join(tmp, "resume32.gxt")
        tcr = TrainConfig(epochs=1, log_every=1, compute_dtype=f32, resume_path=ck,
                          save_every=TRAIN_RESUME_AFTER - 1)
        train(init, stream[:TRAIN_RESUME_AFTER], tcr)
        resumed, hist = train(init, stream, tcr)
        check(hist[0]["step"] == TRAIN_RESUME_AFTER and params_equal(resumed, params32),
              f"{tag}: the f32 run resumed at step {hist[0]['step']} differs from the "
              f"uninterrupted run")
        log(f"[{tag}] f32 run interrupted after {TRAIN_RESUME_AFTER} steps and resumed at step "
            f"{hist[0]['step']}: every parameter tensor bit-equal to the uninterrupted f32 run")
        del init, stream, resumed
    del params32, hist32

    return launches32



LAYER_KERNELS = ("transformer_ln_qkv", "transformer_attention", "transformer_proj_ffn")


def f32_attention_launches(n_layers):
    """What an f32 MobileViT forward of ``n_layers`` transformer layers (each
    of L a multiple of 8) launches for them on the card's default route: the
    three f32 layer kernels a layer."""
    return {k: n_layers for k in F32_LAYER_KERNELS}


def vision_kernel_phase(tag, params, dev):
    """Phase 13: each vision kernel against its plain version on the card at
    the shapes the main path gives it for B=128 images, with the kernel's,
    the plain version's and the library call's times and the bound. The
    fused layer is held whole and kernel by kernel (ln_qkv, attention,
    proj_ffn, each on its plain version's inputs, launched twice: bit-equal).
    Its library call is ``nn.TransformerEncoderLayer(C, H, F, SiLU,
    norm_first)`` in bf16 and eval mode, which has no input or output
    projection; the attention kernel's is ``scaled_dot_product_attention``
    (scale 1: q arrives scaled). Returns {name: kernels-line readings}: a
    forward's worth of launches summed (2 + 4 + 3 layers), errors the largest
    over the shapes."""
    import torch
    import torch.nn.functional as F

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_t=[0.0, 0.0],
                   library_ms=None)
           for k in ("fused_transformer_layer", "flash_mha") + LAYER_KERNELS}
    for k in ("flash_mha", "fused_transformer_layer", "transformer_attention"):
        tot[k]["library_ms"] = 0.0

    def add(name, count, err, ms, plain_ms, nbytes, flops, lib_ms=None):
        t = tot[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += count * ms
        t["plain_ms"] += count * plain_ms
        t["bound_t"][0] += count * nbytes / CHIP.hbm_bytes_per_s * 1e3
        t["bound_t"][1] += count * flops / CHIP.peak_ops["bfloat16"] * 1e3
        if lib_ms is not None:
            t["library_ms"] += count * lib_ms

    def bf16_check(what, key, got, want, want32):
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        scale = float(want.float().abs().max())
        gap = float((want32.float() - want.float()).abs().mean())
        check(bool(torch.isfinite(got.float()).all()) and err <= VIT_BF16_MAX[key] * scale
              and mean <= VIT_BF16_MEAN_FRAC[key] * gap,
              f"{what}: max abs err {err:.3g} (limit {VIT_BF16_MAX[key]} x {scale:.3g}), mean "
              f"{mean:.3g} (limit {VIT_BF16_MEAN_FRAC[key]} x {gap:.3g}, the plain version's "
              f"f32-vs-bf16 mean)")
        return err, mean, gap, scale

    # (block, the side of its feature map at 256 px)
    for blk, side in ((params.layer_3, 32), (params.layer_4, 16), (params.layer_5, 8)):
        n = len(blk.transformer)
        cin = blk.conv_1x1.kernel.shape[-2]
        c = blk.conv_1x1.kernel.shape[-1]
        l = (side // blk.patch_size) ** 2
        bp = VIT_BATCH * blk.patch_size ** 2
        pk = blk.conv_projection.kernel
        # kernel 6: the first layer (input_proj), the middle ones, the last
        # (final LN + conv_projection with BN and SiLU), as the block runs them
        variants = [("first", 1, dict(input_proj=blk.conv_1x1.kernel.reshape(cin, c))),
                    ("middle", n - 2, {}),
                    ("last", 1, dict(final_ln=(blk.ln_gamma, blk.ln_beta), final_ln_eps=blk.eps,
                                     output_proj=(pk.reshape(c, -1), blk.conv_projection.bn.scale,
                                                  blk.conv_projection.bn.bias,
                                                  blk.conv_projection.activation)))]
        h = blk.transformer[0].attention.num_heads
        f = blk.transformer[0].intermediate_kernel.shape[-1]
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True, device=dev,
                                               dtype=bf16).eval()
        xl = torch.randn((bp, l, c), generator=g, device=dev).to(bf16)
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: lib(xl), n=10)
        del lib, xl
        for name, count, kw in variants:
            if count <= 0:
                continue
            i = {"first": 0, "middle": 1, "last": n - 1}[name]
            layer = blk.transformer[i]
            ops = ftl.layer_operands(layer, c, bf16, **kw)
            ops32 = ftl.layer_operands(layer, c, f32, **kw)
            width = cin if "input_proj" in kw else c
            x = torch.randn((bp, l, width), generator=g, device=dev).to(bf16)
            got = ftl.fused_layer_cuda(x, ops)
            torch.cuda.synchronize()
            want = ftl.fused_transformer_layer_plain(x, ops)
            err, mean, gap, scale = bf16_check(
                f"{tag}: fused layer {name} (bp, L, C) = ({bp}, {l}, {c})", "layer", got, want,
                ftl.fused_transformer_layer_plain(x.float(), ops32))
            del want
            ms = cuda_ms(lambda: ftl.fused_layer_cuda(x, ops), n=10)
            plain_ms = cuda_ms(lambda: ftl.fused_transformer_layer_plain(x, ops), n=2, warmup=1)
            cout = got.shape[-1]
            wbytes = {k: t.numel() * t.element_size() for k, t in (
                ("win", ops.win), ("qkv", ops.wq), ("wo", ops.wo), ("ffn", ops.wi),
                ("wout", ops.wout)) if t is not None}
            t_rows = bp * l
            flops = bp * (4 * l * l * c + 8 * l * c * c + 4 * l * c * f
                          + (2 * l * width * c if "input_proj" in kw else 0)
                          + (2 * l * c * cout if "output_proj" in kw else 0))
            nbytes = t_rows * (width + cout) * 2 + wbytes.get("win", 0) + 3 * wbytes["qkv"] + (
                wbytes["wo"] + 2 * wbytes["ffn"] + wbytes.get("wout", 0))
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            add("fused_transformer_layer", count, err, ms, plain_ms, nbytes, flops, lib_ms)
            log(f"[{tag}] fused layer {name} x{count}, (bp, L, Cin, C, Cout) = ({bp}, {l}, "
                f"{width}, {c}, {cout}) bf16: max abs err {err:.3g} (largest value {scale:.3g}), "
                f"mean {mean:.3g} (plain f32 vs "
                f"bf16: {gap:.3g}) | kernel {ms:.4f} ms | plain {plain_ms:.3f} ms | bound "
                f"{b_ms:.4f} ms ({b_by}) | nn.TransformerEncoderLayer (no projections) "
                f"{lib_ms:.4f} ms")
            del got, x

            # the three kernels, each on its plain version's inputs. Their bounds
            # count what the layer needs: q, k and v at the head width dh (the
            # kernels' array pads heads to dhp with zero columns), and x.Win once,
            # in ln_qkv (proj_ffn computes it again: the split's own cost)
            dh = c // h
            dhp = ftl.head_pad(dh)
            x2 = torch.randn((t_rows, width), generator=g, device=dev).to(bf16)
            want_qkv = ftl.ln_qkv_plain(x2, ops)
            want_ctx = ftl.attention_plain(want_qkv, l, ops)
            heads = [want_qkv.reshape(bp, l, 3, h, dhp)[:, :, j, :, :dh].transpose(1, 2)
                     .contiguous() for j in range(3)]
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), n=10)
            del heads
            qkv_bytes = t_rows * 3 * c * 2
            cases = (
                ("transformer_ln_qkv", lambda: ftl.ln_qkv_cuda(x2, ops, l),
                 lambda: ftl.ln_qkv_plain(x2, ops),
                 lambda: ftl.ln_qkv_plain(x2.float(), ops32),
                 t_rows * width * 2 + qkv_bytes + wbytes.get("win", 0) + 3 * wbytes["qkv"],
                 2 * t_rows * (3 * c * c + (width * c if "input_proj" in kw else 0)), None),
                ("transformer_attention", lambda: ftl.attention_cuda(want_qkv, l, ops),
                 lambda: ftl.attention_plain(want_qkv, l, ops),
                 lambda: ftl.attention_plain(want_qkv.float(), l, ops32),
                 qkv_bytes + t_rows * c * 2, 4 * t_rows * l * c, sdpa_ms),
                ("transformer_proj_ffn", lambda: ftl.proj_ffn_cuda(x2, want_ctx, ops, l),
                 lambda: ftl.proj_ffn_plain(x2, want_ctx, ops),
                 lambda: ftl.proj_ffn_plain(x2.float(), want_ctx.float(), ops32),
                 t_rows * (width + c + cout) * 2 + wbytes.get("win", 0) + wbytes["wo"]
                 + 2 * wbytes["ffn"] + wbytes.get("wout", 0),
                 2 * t_rows * (c * c + 2 * c * f + (c * cout if "output_proj" in kw else 0)),
                 None))
            parts = []
            for kname, kernel, plain, plain32, kbytes, kflops, klib in cases:
                kgot, again = kernel(), kernel()
                torch.cuda.synchronize()
                check(torch.equal(kgot, again), f"{tag}: {kname} {name} (bp, L, C) = ({bp}, {l}, "
                                                f"{c}): two launches on the same inputs differ")
                kerr, kmean, kgap, _ = bf16_check(
                    f"{tag}: {kname} {name} (bp, L, C) = ({bp}, {l}, {c})", "layer", kgot,
                    plain(), plain32())
                del kgot, again
                kms = cuda_ms(kernel, n=10)
                kplain = cuda_ms(plain, n=2, warmup=1)
                add(kname, count, kerr, kms, kplain, kbytes, kflops, klib)
                kb_ms, kb_by = bound(kbytes, kflops, "bfloat16")
                parts.append(f"{kname[12:]} {kms:.4f} ms (bound {kb_ms:.4f}, {kb_by}; err "
                             f"{kerr:.3g}, mean {kmean:.3g} of {kgap:.3g})")
            log(f"[{tag}]   its kernels on their plain versions' inputs, each launched twice "
                f"(bit-equal): " + " | ".join(parts) + f" | scaled_dot_product_attention "
                f"{sdpa_ms:.4f} ms")
            del x2, want_qkv, want_ctx
        # kernel 7 at the same (bp, L, C): f32 (the main path) and bf16
        qkv = [torch.randn((bp, l, c), generator=g, device=dev) for _ in range(3)]
        got = fa.flash_mha_cuda(*qkv, h)
        again = fa.flash_mha_cuda(*qkv, h)
        torch.cuda.synchronize()
        want = fa.flash_mha_plain(*qkv, h)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= VIT_F32_REL, f"{tag}: flash f32 (bp, L, C) = ({bp}, {l}, {c}): max rel err "
                                  f"{rel:.3g} > {VIT_F32_REL}")
        q16 = [t.to(bf16) for t in qkv]
        g16 = fa.flash_mha_cuda(*q16, h)
        again16 = fa.flash_mha_cuda(*q16, h)
        torch.cuda.synchronize()
        check(torch.equal(got, again) and torch.equal(g16, again16),
              f"{tag}: flash (bp, L, C) = ({bp}, {l}, {c}): two launches on the same inputs "
              f"differ")
        del again, again16
        w16 = fa.flash_mha_plain(*q16, h)
        err16, mean16, gap16, _ = bf16_check(f"{tag}: flash bf16 (bp, L, C) = ({bp}, {l}, {c})",
                                          "flash", g16, w16,
                                          fa.flash_mha_plain(*(t.float() for t in q16), h))
        ms = cuda_ms(lambda: fa.flash_mha_cuda(*qkv, h), n=10)
        ms16 = cuda_ms(lambda: fa.flash_mha_cuda(*q16, h), n=10)
        plain_ms = cuda_ms(lambda: fa.flash_mha_plain(*qkv, h), n=2, warmup=1)
        heads = [t.reshape(bp, l, h, c // h).transpose(1, 2).contiguous() for t in qkv]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads), n=10)
        flops = 4 * bp * l * l * c
        nbytes = 4 * bp * l * c * 4
        # the f32 route's products run as 3xTF32 on the tensor cores
        b_ms, b_by = bound(nbytes, flops, "tf32x3")
        t = tot["flash_mha"]
        t["max_abs_err"] = max(t["max_abs_err"], float((got - want).abs().max()))
        t["ms"] += n * ms
        t["plain_ms"] += n * plain_ms
        t["library_ms"] += n * lib_ms
        t["bound_t"][0] += n * nbytes / CHIP.hbm_bytes_per_s * 1e3
        t["bound_t"][1] += n * flops / CHIP.peak_ops["tf32x3"] * 1e3
        log(f"[{tag}] flash (bp, L, C, H) = ({bp}, {l}, {c}, {h}) x{n}: f32 max rel err "
            f"{rel:.3g}, two launches bit-equal (f32 and bf16), kernel {ms:.4f} ms = "
            f"{100 * b_ms / ms:.1f}% of bound, {lib_ms / ms:.2f}x "
            f"scaled_dot_product_attention's speed, plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | bf16 "
            f"max abs err {err16:.3g}, mean {mean16:.3g} (plain f32 vs bf16: {gap16:.3g}), "
            f"kernel {ms16:.4f} ms")
        del got, want, qkv, q16, g16, w16, heads
    # the wide row tiles (C past 288: no layer of MobileViT-small has one),
    # in a stack's last form (every flag) and its middle form (none): the
    # layer under its counters (the wide ones too), then ln_qkv and
    # proj_ffn each on its plain version's inputs, two launches bit-equal;
    # the library's yardstick nn.TransformerEncoderLayer (with the input and
    # output projections as F.linear in the last form)
    wide = {k: {} for k in WIDE_LAYER_KERNELS}
    entry_layers = []   # (ops, x, got) for the entry point's run below
    for (bp, l, c, h, f), last in ((shape, last) for shape in WIDE_LAYER_SHAPES
                                   for last in (True, False)):
        def r(*shape, off=0.0):
            return torch.randn(shape, generator=g, device=dev) * 0.2 + off

        form = "last" if last else "middle"
        cin, cout = (c // 2, c // 2 + 8) if last else (c, c)
        ops = ftl.LayerOperands(
            wq=r(c, c).to(bf16), wk=r(c, c).to(bf16), wv=r(c, c).to(bf16), wo=r(c, c).to(bf16),
            wi=r(c, f).to(bf16), wo2=r(f, c).to(bf16), ln1=(r(c, off=1.0), r(c)), bq=r(c),
            bk=r(c), bv=r(c), bo=r(c), ln2=(r(c, off=1.0), r(c)), bi=r(f), bo2=r(c),
            num_heads=h, eps=1e-5, **(dict(
                final_ln=(r(c, off=1.0), r(c)), win=r(cin, c).to(bf16), wout=r(c, cout).to(bf16),
                out_affine=(r(cout, off=1.0), r(cout)), out_act=True) if last else {}))
        x = torch.randn((bp, l, cin), generator=g, device=dev).to(bf16)
        what = f"wide layer (bp, L, C) = ({bp}, {l}, {c}), {form} form"
        counted = ("fused_transformer_layer",) + LAYER_KERNELS + WIDE_LAYER_KERNELS
        before = {k: ftl.LAUNCHES[k] for k in counted}
        got, again = ftl.fused_layer_cuda(x, ops), ftl.fused_layer_cuda(x, ops)
        torch.cuda.synchronize()
        prep = ops.cache[x.device]
        x2 = x.reshape(bp * l, cin)
        split = ftl._launch_args(ops, x2, l, cin)[1]
        check(all(ftl.LAUNCHES[k] == before[k] + 2 for k in counted)
              and torch.equal(got, again),
              f"{tag}: {what}: the wide kernels not launched twice "
              f"({ {k: ftl.LAUNCHES[k] - before[k] for k in counted} }), or two launches differ")
        err, mean, gap, scale = bf16_check(
            f"{tag}: {what}", "layer", got, ftl.fused_transformer_layer_plain(x, ops),
            ftl.fused_transformer_layer_plain(x.float(), ops))
        del again
        ms = cuda_ms(lambda: ftl.fused_layer_cuda(x, ops), n=10)
        plain_ms = cuda_ms(lambda: ftl.fused_transformer_layer_plain(x, ops), n=2, warmup=1)
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True, device=dev,
                                               dtype=bf16).eval()
        with torch.no_grad():
            if last:
                win_t, wout_t = ops.win.t().contiguous(), ops.wout.t().contiguous()
                lib_ms = cuda_ms(lambda: F.linear(lib(F.linear(x, win_t)), wout_t), n=10)
            else:
                lib_ms = cuda_ms(lambda: lib(x), n=10)
        del lib
        bounds = transformer_layer_bound(bp, l, cin, c, f, cout, "bfloat16", in_proj=last,
                                         out_proj=last)
        b_ms, b_by = bound(*bounds["layer"], "bfloat16")
        layer = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by="bytes" if b_by == "bytes" else "operations", library_ms=lib_ms)
        want_qkv = ftl.ln_qkv_plain(x2, ops)
        want_ctx = ftl.attention_plain(want_qkv, l, ops)
        parts = []
        for kname, kernel, plain, plain32, bkey in (
                ("transformer_ln_qkv_wide", lambda: ftl.ln_qkv_cuda(x2, ops, l),
                 lambda: ftl.ln_qkv_plain(x2, ops), lambda: ftl.ln_qkv_plain(x2.float(), ops),
                 "ln_qkv"),
                ("transformer_proj_ffn_wide", lambda: ftl.proj_ffn_cuda(x2, want_ctx, ops, l),
                 lambda: ftl.proj_ffn_plain(x2, want_ctx, ops),
                 lambda: ftl.proj_ffn_plain(x2.float(), want_ctx.float(), ops), "proj_ffn")):
            n0 = ftl.LAUNCHES[kname]
            kgot, kagain = kernel(), kernel()
            torch.cuda.synchronize()
            check(ftl.LAUNCHES[kname] == n0 + 2 and torch.equal(kgot, kagain),
                  f"{tag}: {kname} (bp, L, C) = ({bp}, {l}, {c}), {form} form: not launched "
                  f"twice, or two launches differ")
            kerr, kmean, kgap, _ = bf16_check(f"{tag}: {kname} (bp, L, C) = ({bp}, {l}, {c}), "
                                              f"{form} form", "layer", kgot, plain(), plain32())
            del kgot, kagain
            kms = cuda_ms(kernel, n=10)
            kplain = cuda_ms(plain, n=2, warmup=1)
            kb_ms, kb_by = bound(*bounds[bkey], "bfloat16")
            wide[kname][f"{bp}x{l}x{c}_{form}"] = dict(
                max_abs_err=kerr, ms=kms, plain_ms=kplain, bound_ms=kb_ms,
                bound_by="bytes" if kb_by == "bytes" else "operations", library_ms=None,
                layer=layer)
            parts.append(f"{kname[12:]} {kms:.4f} ms (bound {kb_ms:.4f}, {kb_by}; plain "
                         f"{kplain:.3f}; err {kerr:.3g}, mean {kmean:.3g} of {kgap:.3g})")
        log(f"[{tag}] {what}: (Cin, H, F, Cout) = ({cin}, {h}, {f}, {cout}), nw = {prep.nw} "
            f"({prep.ngc} groups of C), qsplit {split.qsplit}, fsplit {split.fsplit}: "
            f"max abs err {err:.3g} (largest value {scale:.3g}), mean {mean:.3g} (plain f32 vs "
            f"bf16: {gap:.3g}), two launches bit-equal | kernel {ms:.4f} ms | plain "
            f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | library: "
            f"nn.TransformerEncoderLayer{' + the two projections as F.linear' if last else ''} "
            f"{lib_ms:.4f} ms | its kernels on their plain versions' inputs, each launched twice "
            f"(bit-equal): " + " | ".join(parts))
        entry_layers.append((ops, x, got))
        del x2, prep, want_qkv, want_ctx
    for t in tot.values():
        t["bound_ms"] = max(t["bound_t"])
        t["bound_by"] = "bytes" if t["bound_t"][0] >= t["bound_t"][1] else "operations"
        del t["bound_t"]

    # kernel 8 at layer_2's shape, with the residual, on the model's folded
    # weights, made into the kernel's operands once (as the block keeps them)
    b, hh, ww, c, e, cout = VIT_IR_SHAPE
    blk = params.layer_2[1]
    wexp, bexp = fir.folded_conv_weights(blk.expand_1x1)
    kdw, bdw = fir.folded_conv_weights(blk.conv_3x3)
    wred, bred = fir.folded_conv_weights(blk.reduce_1x1)
    args = (wexp.reshape(c, e), bexp, kdw.reshape(3, 3, e), bdw, wred.reshape(e, cout), bred)
    ops = fir.ir_operands(*args)
    x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(bf16)
    got = fir.fused_ir_cuda(x, ops, use_residual=True)
    again = fir.fused_ir_cuda(x, ops, use_residual=True)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{tag}: fused inverted residual: two launches differ")
    plain_args = (args[0].to(bf16), args[1], args[2], args[3], args[4].to(bf16), args[5])
    want = fir.fused_ir_plain(x, *plain_args, use_residual=True)
    err, mean, gap, _ = bf16_check(f"{tag}: fused inverted residual {VIT_IR_SHAPE}", "ir", got,
                                   want, fir.fused_ir_plain(x.float(), *args, use_residual=True))
    del got, again, want
    ms = cuda_ms(lambda: fir.fused_ir_cuda(x, ops, use_residual=True), n=20)
    plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *plain_args, use_residual=True), n=3)
    lib_ms = cuda_ms(cudnn_inverted_residual(x, args), n=20)
    b_ms, b_by, parts = ir_bound(b, hh, ww, c, e, cout)
    log(f"[{tag}] fused inverted residual (B, H, W, C, E, Cout) = {VIT_IR_SHAPE} bf16, plan "
        f"{fir.ir_plan(b, hh, ww, c, e, cout)}: max abs err {err:.3g}, mean {mean:.3g} (plain f32 "
        f"vs bf16: {gap:.3g}), two launches bit-equal | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()) + f") | library: the cuDNN chain (three "
        f"F.conv2d, channels_last bf16, BN folded, two F.silu, + x; not one call) {lib_ms:.4f} ms")
    tot["fused_inverted_residual"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by="bytes" if b_by == "bytes" else "operations",
                                          library_ms=lib_ms)
    del x
    # csrc/inverted_residual_wide.cu, the route of the widths the strip kernel
    # does not take (no block of MobileViT-small has one), on seeded random
    # weights: two launches bit-equal (a launch a pass)
    shapes, entry_blocks = {}, []
    for shape in VIT_IR_WIDE_SHAPES:
        b, hh, ww, c, e, cout = shape
        resid = c == cout
        args = tuple(torch.randn(sh, generator=g, device=dev) * 0.2
                     for sh in ((c, e), (e,), (3, 3, e), (e,), (e, cout), (cout,)))
        ops = fir.ir_operands(*args)
        check(isinstance(ops, fir.IRTCOperands), f"{tag}: {shape} should run on the wide kernel")
        passes = -(-cout // ops.ncp)
        x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(bf16)
        before = fir.LAUNCHES["inverted_residual_wide"]
        got = fir.fused_ir_cuda(x, ops, use_residual=resid)
        again = fir.fused_ir_cuda(x, ops, use_residual=resid)
        torch.cuda.synchronize()
        check(fir.LAUNCHES["inverted_residual_wide"] == before + 2 * passes
              and torch.equal(got, again),
              f"{tag}: wide inverted residual {shape}: not launched twice ({passes} a call), or "
              f"two launches differ")
        plain_args = (args[0].to(bf16), args[1], args[2], args[3], args[4].to(bf16), args[5])
        err, mean, gap, scale = bf16_check(
            f"{tag}: wide inverted residual {shape}", "ir", got,
            fir.fused_ir_plain(x, *plain_args, use_residual=resid),
            fir.fused_ir_plain(x.float(), *args, use_residual=resid))
        del again
        ms = cuda_ms(lambda: fir.fused_ir_cuda(x, ops, use_residual=resid), n=10)
        plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *plain_args, use_residual=resid), n=3)
        lib_ms = cuda_ms(cudnn_inverted_residual(x, args, residual=resid), n=10)
        b_ms, b_by, parts = ir_bound(b, hh, ww, c, e, cout)
        log(f"[{tag}] wide inverted residual (B, H, W, C, E, Cout) = {shape} bf16, "
            f"{'residual, ' if resid else ''}tile {ops.tile}, {passes} pass(es) of {ops.ncp} "
            f"output channels: max abs err {err:.3g} (largest value {scale:.3g}), mean "
            f"{mean:.3g} (plain f32 vs bf16: {gap:.3g}), two launches bit-equal | kernel "
            f"{ms:.4f} ms | plain {plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f") | library: the cuDNN "
            f"chain {lib_ms:.4f} ms")
        shapes["x".join(map(str, shape))] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by="bytes" if b_by == "bytes" else "operations", library_ms=lib_ms,
            passes=passes)
        entry_blocks.append((shape, args, resid, x, got))
        del ops

    # the main path of the two wide kernels: no model of the repo has these
    # widths, so it is the ops' entry points (``fused_inverted_residual``,
    # ``fused_transformer_layer``, operands made from the weights as a
    # caller gives them) once at each shape above, launches zeroed just
    # before and read just after; each output bit-equal to the comparison's
    from ggml_experiments_tpu_torch.models.mobilevit import TransformerLayerParams
    from ggml_experiments_tpu_torch.ops.attention import AttentionParams

    layer_params = [TransformerLayerParams(
        ln_before_gamma=ops.ln1[0], ln_before_beta=ops.ln1[1],
        attention=AttentionParams(wq=ops.wq, bq=ops.bq, wk=ops.wk, bk=ops.bk, wv=ops.wv,
                                  bv=ops.bv, wo=ops.wo, bo=ops.bo, num_heads=ops.num_heads),
        ln_after_gamma=ops.ln2[0], ln_after_beta=ops.ln2[1], intermediate_kernel=ops.wi,
        intermediate_bias=ops.bi, output_kernel=ops.wo2, output_bias=ops.bo2, eps=ops.eps)
        for ops, _, _ in entry_layers]
    port.reset_kernel_launches()
    outs = [fir.fused_inverted_residual(x, *args, use_residual=resid)
            for _, args, resid, x, _ in entry_blocks]
    outs += [ftl.fused_transformer_layer(
        p, x, **(dict(final_ln=ops.final_ln, input_proj=ops.win,
                      output_proj=(ops.wout, *ops.out_affine, "silu")) if ops.win is not None
                 else {}))
        for p, (ops, x, _) in zip(layer_params, entry_layers)]
    torch.cuda.synchronize()
    entry = port.kernel_launches()
    want = {"inverted_residual_wide": sum(sh["passes"] for sh in shapes.values()),
            "transformer_ln_qkv_wide": len(entry_layers),
            "transformer_proj_ffn_wide": len(entry_layers)}
    check(all(entry[k] == v for k, v in want.items()),
          f"{tag}: the entry points launched {({k: entry[k] for k in want})}, want {want}")
    refs = [got for *_, got in entry_blocks] + [got for _, _, got in entry_layers]
    check(all(torch.equal(o, ref) for o, ref in zip(outs, refs)),
          f"{tag}: an entry point's output differs from its comparison launch's")
    log(f"[{tag}] the wide kernels' main path, fused_inverted_residual at "
        f"{len(entry_blocks)} shapes and fused_transformer_layer at {len(entry_layers)} "
        f"(shape, form): launches " + ", ".join(f"{k} {entry[k]}" for k in want)
        + ", each output bit-equal to the comparison's")
    del outs, refs, entry_blocks, entry_layers, layer_params
    first = "x".join(map(str, VIT_IR_WIDE_SHAPES[0]))
    tot["inverted_residual_wide"] = dict(shapes[first], shapes=shapes,
                                         launches=entry["inverted_residual_wide"])
    for name, by_shape in wide.items():
        tot[name] = dict(next(iter(by_shape.values())), shapes=by_shape, launches=entry[name])
    return tot


def argmax_near_ties(what, got, want, tol, tie_dtype=None):
    """Rows whose argmax differs must be near-ties of ``want`` (top-2 gap
    below ``tol``), and count as flips. With ``tie_dtype`` (the dtype ``got``
    was computed in), a row where ``got`` ties ``want``'s class with another
    at its top is no flip where ``want``'s top-2 gap is below one step of
    ``tie_dtype`` at that logit (its spacing at |top-1|: at bf16 and 64-128
    a step is 0.5): both logits rounded to the same value, and argmax's
    first-index rule picked the other. Returns (agreement, flips)."""
    import torch

    ref = want.argmax(-1).to(got.device)
    diff = torch.nonzero(got.argmax(-1) != ref).flatten().tolist()
    at_ref = got.gather(-1, ref[:, None])[:, 0]
    top2 = want.topk(2, dim=-1).values
    flips = []
    for r in diff:
        gap = float(top2[r, 0] - top2[r, 1])
        top = abs(float(top2[r, 0]))
        step = torch.finfo(tie_dtype).eps * 2.0 ** math.floor(math.log2(top)) if (
            tie_dtype is not None and top > 0) else 0.0
        if bool(at_ref[r] == got[r].max()) and gap < step:
            log(f"{what}: row {r} ties the reference's class ({float(at_ref[r]):.4g}) with "
                f"another at its top, a reference gap of {gap:.3g} below one {tie_dtype} step "
                f"({step:.3g}): no flip")
            continue
        check(gap < tol, f"{what}: row {r} flips its argmax where the reference's top-2 gap is "
                         f"{gap:.3g} >= {tol}")
        flips.append(r)
    return 1.0 - len(flips) / got.shape[0], len(flips)


def ir_blocks(params):
    """MobileViT's seven inverted residuals: layer_1's, layer_2's three and
    the downsampling block of layers 3-5."""
    return [*params.layer_1, *params.layer_2,
            *(getattr(params, f"layer_{k}").downsampling for k in (3, 4, 5))]


def vision_model_phase(tag, dev, images, labels):
    """Phase 14: MobileViT through the entry points on the full checkpoint
    (see the module docstring). Returns (main-path launches by kernel, the
    params, the classify logits by route)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.ops.linear import linear
    from ggml_experiments_tpu_torch.utils.trace_report import kernel_name

    f32, bf16 = torch.float32, torch.bfloat16
    x_all = torch.from_numpy(images)
    nb = -(-len(images) // VIT_BATCH)
    p = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False)
    p_ir = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    # the unfused f32 reference: flash attention, neither fused layer nor block
    p_flash = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False, fused_layer=False)
    check(p.layer_3.transformer[0].attention.flash and p.layer_3.transformer[0].fused
          and not p.layer_2[1].fused and p_ir.layer_2[1].fused
          and not p_flash.layer_3.transformer[0].fused,
          f"{tag}: the default routes on the card are not flash + fused layer")
    n_ir = sum(blk.fused_route(bf16, dev) for blk in ir_blocks(p_ir))
    n_s2 = sum(blk.fused_route(bf16, dev) for blk in ir_blocks(p_ir) if blk.conv_3x3.stride == 2)
    n_ir32 = sum(blk.fused_route(f32, dev) for blk in ir_blocks(p_ir))
    n_s2_32 = sum(blk.fused_route(f32, dev) for blk in ir_blocks(p_ir)
                  if blk.conv_3x3.stride == 2)

    def run(params, cd, name):
        port.reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.cat([classify(params, x_all[i:i + VIT_BATCH].to(dev), compute_dtype=cd)
                         for i in range(0, len(images), VIT_BATCH)])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = port.kernel_launches()
        check(out.shape == (len(images), 44) and bool(torch.isfinite(out).all()),
              f"{tag}: classify {name}: shape {tuple(out.shape)} or values")
        return out.cpu(), launches, sec

    logits = {}
    layer = {"fused_transformer_layer": 9, **{k: 9 for k in LAYER_KERNELS}}
    # the f32 default route: the f32 fused layer and the f32 fused blocks
    f32_default = {**f32_attention_launches(9), "fused_inverted_residual": n_ir32,
                   "inverted_residual_f32": n_ir32 - n_s2_32, "inverted_residual_s2_f32": n_s2_32}
    runs = (("f32", p_flash, f32, {"flash_mha": 9}), ("bf16", p, bf16, layer),
            ("bf16+fused_ir", p_ir, bf16, {**layer, "fused_inverted_residual": n_ir,
                                           "inverted_residual_s2": n_s2}),
            ("f32 default", p_ir, f32, f32_default))
    main_launches = {}
    for name, params, cd, per_batch in runs:
        out, launches, sec = run(params, cd, name)
        for k, v in per_batch.items():
            check(launches[k] == v * nb, f"{tag}: classify {name}: {launches[k]} {k} launches, "
                                         f"want {v} a batch x {nb}")
            main_launches.setdefault(k, launches[k])
        others = {k: v for k, v in launches.items() if v and k not in per_batch}
        check(not others, f"{tag}: classify {name} launched {others}")
        logits[name] = out
        top1 = float((out.argmax(-1).numpy() == labels).mean())
        msg = f"[{tag}] classify {name}, {len(images)} held-out images in {nb} batches of " \
              f"<= {VIT_BATCH} ({sec:.2f} s): top-1 {top1:.4f} | launches " + ", ".join(
                  f"{k} {launches[k]}" for k in per_batch)
        if name != "f32":
            agree, flips = argmax_near_ties(f"{tag}: {name} vs f32", out, logits["f32"],
                                            VIT_NEAR_TIE if cd == bf16 else NEAR_TIE["float32"],
                                            tie_dtype=cd)
            msg += f" | argmax agreement with f32 {agree:.4f} ({flips} flips, at near-ties)"
        log(msg)

    # the card's f32 features against the plain CPU run, on the unfused
    # reference route and on the default route; the default's argmax against
    # the CPU's under the near-tie rule
    n = VIT_CPU_IMAGES
    p_cpu = load_mobilevit(VIT_CKPT, device="cpu")
    t0 = time.perf_counter()
    want = extract_features(p_cpu, x_all[:n])
    cpu_s = time.perf_counter() - t0

    def head(feats):
        return linear(feats.mean(dim=(1, 2)), p_cpu.classifier_kernel, p_cpu.classifier_bias,
                      compute_dtype=f32).float()

    for route, params in (("unfused (flash)", p_flash), ("default", p_ir)):
        got = extract_features(params, x_all[:n].to(dev)).cpu()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= VIT_CPU_FEATURE_REL, f"{tag}: f32 features on the card ({route} route) vs "
                                          f"the CPU: max rel err {rel:.3g} > "
                                          f"{VIT_CPU_FEATURE_REL}")
        agree, flips = argmax_near_ties(f"{tag}: f32 {route} vs the CPU", head(got), head(want),
                                        NEAR_TIE["float32"], tie_dtype=f32)
        log(f"[{tag}] f32 features of the first {n} images, card ({route} route) vs the plain "
            f"CPU run ({cpu_s:.1f} s): max abs err {float((got - want).abs().max()):.3g}, "
            f"relative to the largest {rel:.3g} (limit {VIT_CPU_FEATURE_REL}); argmax agreement "
            f"{agree:.4f} ({flips} flips, at near-ties)")
    del p_cpu, want, got

    # the calibrated q4_k_m checkpoint
    p_km = load_mobilevit(VIT_Q4KM, device=dev)
    check(p_km.layer_3.transformer[0].attention.wq.qtype in ("q4_k", "q8_0")
          and p_km.classifier_kernel is not None, f"{tag}: q4_k_m checkpoint loaded wrongly")
    out, launches, sec = run(p_km, f32, "q4_k_m")
    agree = float((out.argmax(-1) == logits["f32"].argmax(-1)).float().mean())
    flips = int((out.argmax(-1) != logits["f32"].argmax(-1)).sum())
    top1 = float((out.argmax(-1).numpy() == labels).mean())
    log(f"[{tag}] mobilevit_synth_full_q4km.gxt on the card, classify f32: top-1 {top1:.4f}, "
        f"argmax agreement with the float model {agree:.4f} ({flips} differ) | flash launches "
        f"{launches['flash_mha']}")
    del p_km

    # the features command on the synthetic image
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["features", "--weights", VIT_CKPT, "--compute", "bfloat16"])
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines[0] == "output feature shape: : Dims: (8, 8, 640)" and len(lines) == 4,
          f"{tag}: features command printed {lines}")
    log(f"[{tag}] features --weights mobilevit_synth_full.ggml --compute bfloat16: {lines[0]} | "
        f"{lines[3][:70]}")

    # throughput of extract_features at B=128 on both bf16 routes
    xb = x_all[:VIT_BATCH].to(dev)
    rates = {}
    for name, params in (("bf16", p), ("bf16+fused_ir", p_ir)):
        ms = cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
        rates[name] = (ms, VIT_BATCH / ms * 1e3)
    log(f"[{tag}] extract_features B={VIT_BATCH} bf16: " + ", ".join(
        f"{k} {ms:.3f} ms = {r:,.0f} images/s" for k, (ms, r) in rates.items()))
    # one forward of each bf16 route under torch.profiler
    kernels = {"transformer_ln_qkv": "fused layer: ln_qkv", "transformer_attention": "attention",
               "transformer_proj_ffn": "proj_ffn", "fused_inverted_residual": "inverted residual",
               "inverted_residual_s2": "inverted residual, stride 2"}
    for name, params in (("bf16", p), ("bf16+fused_ir", p_ir)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            extract_features(params, xb, compute_dtype=bf16)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups = {k: 0.0 for k in kernels.values()}
        groups.update({"convolutions": 0.0, "other device work": 0.0})
        other = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            key = e.key.lower()
            part = kernels.get(kernel_name(e.key))
            if part:
                groups[part] += ms
            elif any(w in key for w in ("conv", "cudnn", "xmma", "implicit", "winograd", "nhwc",
                                        "fprop")):
                groups["convolutions"] += ms
            else:
                groups["other device work"] += ms
                other.append((ms, e.key[:60]))
        busy = sum(groups.values())
        log(f"[{tag}] one {name} forward under torch.profiler: " + (
            f"{wall_ms:.2f} ms wall, device busy {busy:.3f} ms (idle share "
            f"{max(0.0, 1 - busy / wall_ms):.3f}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()) if busy > 0 else
            "torch.profiler recorded no device time"))
        log(f"[{tag}] the largest other device work ({name}): " + "; ".join(
            f"{k} {ms:.3f} ms" for ms, k in sorted(other, reverse=True)[:6]))
    return main_launches, p, logits


def vision_engine_phase(tag, params, images):
    """Phase 15: the VisionEngine over the ladder (8, 32, 128), u8 transport,
    bf16: mixed classify/features bursts, each result against the offline
    forward, some requests canceled."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import classify, extract_features
    from ggml_experiments_tpu_torch.serving import VisionEngine

    bf16 = torch.bfloat16
    dev = params.device
    u8 = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    eng = VisionEngine(params, image_size=256, batch_sizes=(8, 32, 128), compute_dtype=bf16)
    eng.start()
    reqs, idx, kinds = [], [], []
    t0 = time.perf_counter()
    n = 0
    for bi, burst in enumerate(VIT_ENGINE_BURSTS):
        kind = "features" if bi % 3 == 2 else "classify"
        for _ in range(burst):
            j = n % len(u8)
            reqs.append(eng.submit(u8[j], kind))
            if n % VIT_CANCEL_EVERY == 0:
                reqs[-1].cancel()     # most likely still queued
            idx.append(j)
            kinds.append(kind)
            n += 1
        time.sleep(0.05)
    eng.run_until_idle(timeout=600)
    eng_s = time.perf_counter() - t0
    eng.stop()
    # the offline forward of every image, in batches of 128 at the same dtype
    xs = torch.from_numpy(u8)
    want = {}
    for kind, fn in (("classify", classify), ("features", extract_features)):
        want[kind] = torch.cat([fn(params, xs[i:i + VIT_BATCH].to(dev).float() / 255.0,
                                   compute_dtype=bf16).cpu()
                                for i in range(0, len(u8), VIT_BATCH)])
    canceled = set(range(0, len(reqs), VIT_CANCEL_EVERY))
    served = [i for i in range(len(reqs)) if i not in canceled]
    for i in canceled:
        try:
            reqs[i].result(timeout=0)
            check(False, f"{tag}: canceled request {i} resolved with a result")
        except RuntimeError as ex:
            check("canceled" in str(ex), f"{tag}: canceled request {i} raised {ex!r}")
    skipped = eng.stats.requests_canceled
    feat_err, scale = 0.0, 0.0
    got_cls, want_cls = [], []
    for i in served:
        res = torch.from_numpy(reqs[i].result(timeout=0))
        w = want[kinds[i]][idx[i]]
        if kinds[i] == "classify":
            got_cls.append(res)
            want_cls.append(w)
        else:
            feat_err = max(feat_err, float((res - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
    check(feat_err <= VIT_ENGINE_FEATURE_MAX * scale,
          f"{tag}: engine features differ from the offline forward by {feat_err:.3g} (limit "
          f"{VIT_ENGINE_FEATURE_MAX} x {scale:.3g})")
    agree, flips = argmax_near_ties(f"{tag}: engine vs offline", torch.stack(got_cls),
                                    torch.stack(want_cls), VIT_NEAR_TIE)
    log(f"[{tag}] {len(reqs)} requests in bursts {VIT_ENGINE_BURSTS} ({len(canceled)} canceled, "
        f"{skipped} of them before or inside their batch, none resolved with a result), u8 "
        f"transport, bf16: {eng_s:.2f} s | features max abs err "
        f"vs the offline forward {feat_err:.3g} (largest {scale:.3g}) | classify argmax "
        f"agreement {agree:.4f} ({flips} flips, at near-ties) | breakdown "
        f"{json.dumps(eng.stats.breakdown())}")


class PartTimer:
    """Wall seconds spent inside module functions while active, by part. A
    wrapped call synchronizes the card before it returns, so the device work
    it queued counts in its part; nested parts count in both."""

    def __init__(self, targets):
        self.targets = targets          # {part: (module, function name)}
        self.seconds = {part: 0.0 for part in targets}
        self.saved = {}

    def __enter__(self):
        import torch

        for part, (mod, name) in self.targets.items():
            real = getattr(mod, name)
            self.saved[part] = (mod, name, real)

            def timed(*a, _real=real, _part=part, **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_part] += time.perf_counter() - t0
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved.values():
            setattr(mod, name, real)


def run_command(argv):
    """(rc, stdout, wall seconds) of one CLI command, the card synchronized."""
    import contextlib
    import io

    import torch

    from ggml_experiments_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def codes_of(qt):
    """A QTensor's codes unpacked to (K, N) int32 on the CPU."""
    import torch

    from ggml_experiments_tpu_torch.quant.qtensor import unpack_nibbles

    c = qt.codes.to(torch.int32) if qt.qtype == "q8_0" else unpack_nibbles(qt.codes, torch.int32)
    return c[: qt.shape[0], : qt.shape[1]].cpu()


def code_diffs(a_leaves, b_leaves):
    """{key: (differing codes, codes)} over the QTensor leaves two flat
    checkpoints share."""
    out = {}
    for k, a in a_leaves.items():
        if hasattr(a, "codes"):
            b = b_leaves[k]
            check(a.qtype == b.qtype and a.shape == b.shape, f"{k}: {a.qtype} {a.shape} vs "
                                                             f"{b.qtype} {b.shape}")
            out[k] = (int((codes_of(a) != codes_of(b)).sum()), a.shape[0] * a.shape[1])
    return out


def quantize_parts(mod_calibration, collect):
    """The PartTimer targets of a calibrated ``quantize``: the calibration
    forward with its Grams, the GPTQ calls, the k-quant grid fits inside them."""
    from ggml_experiments_tpu_torch.quant import kquant

    return {"forward+H": (mod_calibration, collect),
            "gptq_q4_k": (mod_calibration, "gptq_quantize_q4_k"),
            "gptq_q8_0": (mod_calibration, "gptq_quantize_q8_0"),
            "fit": (kquant, "quantize_q4_k_blocks")}


def split_line(sec, total):
    """The wall time of ``quantize`` split by part: the fits run inside GPTQ."""
    gptq_s = sec["gptq_q4_k"] + sec["gptq_q8_0"]
    return (f"{total:.2f} s = forward + H {sec['forward+H']:.2f} + GPTQ recursion "
            f"{gptq_s - sec['fit']:.2f} + k-quant fit {sec['fit']:.2f} + load, save and the "
            f"rest {total - sec['forward+H'] - gptq_s:.2f}")


def gru_calibration_phase(tag, dev, rng, tok, n_slots, inner):
    """Phase 16: the GRU's q4_k_m recipe on the card (see the module
    docstring)."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import evaluation
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
    from ggml_experiments_tpu_torch.quant import calibration, gptq
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples

    def windows(path):
        return make_examples(load_corpus(path), tok, DataConfig(seq_length=100))

    # 1. the command on the card, timed by part, against the shipped file
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gru_synth_q4km.gxt")
        with PartTimer(quantize_parts(calibration, "collect_gru_hessians")) as timer:
            rc, text, total = run_command(["quantize", "--input", GRU_SYNTH, "--output", out,
                                           "--qtype", "q4_k_m", "--calibrate", CORPUS_TRAIN,
                                           "--device", "cuda"])
        check(rc == 0, f"{tag}: quantize --qtype q4_k_m returned {rc}")
        line = json.loads(text)
        check(line["calibrated"] and line["bits_per_weight"] < 5.0
              and checkpoint.read_meta(out) == {"kind": "gru", "qtype": "q4_k_m",
                                                "calibrated": True}, f"{tag}: {line}")
        diffs = code_diffs(checkpoint.load_arrays(out, device="cpu"),
                           checkpoint.load_arrays(CKPT_Q4KM, device="cpu"))
        params_km = load_gru_any(out, device=dev)
        km_cpu = load_gru_any(out, device="cpu")
    log(f"[{tag}] quantize --qtype q4_k_m --calibrate corpus_train.txt of gru_synth.bin on the "
        f"card (384 windows): {split_line(timer.seconds, total)} | {json.dumps(line)}")
    log(f"[{tag}] codes differing from the shipped gru_synth_q4km.gxt (made by the JAX "
        f"package): " + ", ".join(f"{k} {d:,} of {n:,}" for k, (d, n) in diffs.items()))

    # the shipped file's contract, on the held-out draw of its test
    held = windows(CORPUS_HELDOUT)
    seqs = held[np.random.default_rng(0).permutation(len(held))[:GRU_HELDOUT_SEQS]]
    ref = load_gru_params(GRU_SYNTH, device=dev)
    reps = {}
    for name, p in (("port-made", params_km), ("shipped", load_gru_any(CKPT_Q4KM, device=dev))):
        port.reset_kernel_launches()
        r = evaluation.eval_gru_delta(ref, p, seqs)
        reps[name] = (r, abs(r.ppl_a - r.ppl_b) / r.ppl_b, port.kernel_launches())
    r, dppl, launches = reps["port-made"]
    check(r.top1_agreement >= KM_GRU_AGREE and dppl < KM_GRU_DPPL,
          f"{tag}: port-made q4_k_m agreement {r.top1_agreement:.5f}, relative dppl {dppl:.2e}")
    # the head (1024 x 66) and the input kernel are under qmatmul's dispatch
    # gate (K*N <= 2^20): torch.matmul on the dequantized plane, as in JAX
    check(launches["qmatmul_q4_k"] > 0, f"{tag}: eval launched {launches}")
    log(f"[{tag}] against the float model on {GRU_HELDOUT_SEQS} held-out windows (limits: "
        f"agreement >= {KM_GRU_AGREE}, relative dppl < {KM_GRU_DPPL}): " + "; ".join(
            f"{k} agreement {v[0].top1_agreement:.5f}, dppl {v[1]:.2e}, max abs "
            f"{v[0].max_abs:.4f}" for k, v in reps.items())
        + f" | qmatmul_q4_k launches {launches['qmatmul_q4_k']}")
    rc, text, eval_s = run_command(["eval", "--weights", GRU_SYNTH, "--qtype", "q8_0",
                                    "--corpus", CORPUS_HELDOUT, "--batch", "64", "--length",
                                    "100", "--device", "cuda"])
    check(rc == 0, f"{tag}: eval returned {rc}")
    log(f"[{tag}] eval --weights gru_synth.bin --qtype q8_0 --corpus corpus_heldout.txt "
        f"--batch 64 --length 100 on the card: {eval_s:.2f} s wall | {text.strip()}")

    # 2. the Shakespeare ordering: q8_0 >= GPTQ q4_k_m > RTN q4_k, q4_k_m >= 0.95
    sref = load_gru_params(CKPT, device=dev)
    train = windows(SHAKE_TRAIN)
    cal = train[np.random.default_rng(7).permutation(len(train))[:SHAKE_CAL_SEQS]]
    t0 = time.perf_counter()
    pm = calibration.gptq_gru_params(sref, cal)
    torch.cuda.synchronize()
    shake_s = time.perf_counter() - t0
    held = windows(SHAKE_HELD)
    agree = {}
    for name, p in (("q8_0", load_gru_params(CKPT, qtype="q8_0", device=dev)), ("q4_k_m", pm),
                    ("q4_k", load_gru_params(CKPT, qtype="q4_k", device=dev))):
        r = evaluation.eval_gru_delta(sref, p, held)
        agree[name] = (r.top1_agreement, abs(r.ppl_a - r.ppl_b) / r.ppl_b)
    a = {k: v[0] for k, v in agree.items()}
    check(a["q8_0"] >= a["q4_k_m"] > a["q4_k"] and a["q4_k_m"] >= 0.95,
          f"{tag}: Shakespeare ordering broken: {a}")
    log(f"[{tag}] gru_shakespeare.bin, GPTQ q4_k_m from {SHAKE_CAL_SEQS} train windows on the "
        f"card in {shake_s:.2f} s; agreement with f32 on {len(held)} held-out windows: "
        + ", ".join(f"{k} {v[0]:.5f} (dppl {v[1]:.2e})" for k, v in agree.items())
        + " (q8_0 >= q4_k_m > q4_k, q4_k_m >= 0.95: holds)")
    del sref, pm

    # 3. generate, decode and an engine from the port-made file: phase 8's checks
    ids, lens = pad_batch(corpus_prompts(tok, rng, GENERATE_SHAPE[0], 8, 40), 40)
    launches, dec, tick = calibrated_gru_phase(tag, "the port-made q4_k_m file", params_km,
                                               km_cpu, ids, lens, rng, tok, n_slots, inner)
    log(f"[{tag}] launches on the port-made file's paths: qmatmul_q4_k "
        f"{launches['qmatmul_q4_k']} (generate), fused_gru_decode {dec['launches']} ({dec['ms']:.2f} ms), fused_slot_tick "
        f"{tick['launches']} ({tick['ms']:.3f} ms)")
    del params_km, km_cpu

    # 4. GPTQ on the card and on the CPU from the same H and W: the same bits
    train = windows(CORPUS_TRAIN)
    hess = calibration.collect_gru_hessians(
        ref, train[np.random.default_rng(0).permutation(len(train))[:64]])
    for what, fn, w, h, kw in (
            ("input kernel q4_k", gptq.gptq_quantize_q4_k, ref.cell.kernel, hess["kernel"],
             dict(percdamp=1e-4)),
            ("head q8_0", gptq.gptq_quantize_q8_0, ref.dense_kernel, hess["dense_kernel"], {})):
        t0 = time.perf_counter()
        got = fn(w, h, device=dev, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = fn(w.cpu(), h.cpu(), device="cpu", **kw)
        t2 = time.perf_counter()
        for name in ("codes", "scales", "mins", "supers"):
            ga, wa = getattr(got, name), getattr(want, name)
            check((ga is None) == (wa is None) and (ga is None or torch.equal(ga.cpu(), wa)),
                  f"{tag}: {what}: the card's {name} differ from the CPU's")
        log(f"[{tag}] gptq {what} {tuple(w.shape)} from the same H and W: the card's planes "
            f"bit-equal to the CPU's | card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")


def vision_remainders_phase(tag, dev, images, labels, logits):
    """Phase 17: the MobileViT remainders on the card (see the module
    docstring). ``logits``: phase 14's classify logits of the float model by
    route."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.quant import calibration
    from ggml_experiments_tpu_torch.training import image_task

    f32, bf16 = torch.float32, torch.bfloat16
    x_all = torch.from_numpy(images)
    nb = -(-len(images) // VIT_BATCH)

    def run_classify(params, cd):
        port.reset_kernel_launches()
        out = torch.cat([classify(params, x_all[i:i + VIT_BATCH].to(dev), compute_dtype=cd)
                         for i in range(0, len(images), VIT_BATCH)]).cpu()
        torch.cuda.synchronize()
        check(out.shape == (len(images), 44) and bool(torch.isfinite(out).all()),
              f"{tag}: classify output shape/values")
        return out, port.kernel_launches()

    # 1. the command on the card, against the shipped file and the float model
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mobilevit_synth_full_q4km.gxt")
        with PartTimer(quantize_parts(calibration, "collect_mobilevit_grams")) as timer:
            rc, text, total = run_command(["quantize", "--input", VIT_CKPT, "--output", out,
                                           "--qtype", "q4_k_m", "--calibrate", "task:1234",
                                           "--device", "cuda"])
        check(rc == 0, f"{tag}: quantize --qtype q4_k_m returned {rc}")
        line = json.loads(text)
        meta = checkpoint.read_meta(out)
        check(line["calibrated"] and (meta["kind"], meta["qtype"], meta["classifier"])
              == ("mobilevit", "q4_k_m", True), f"{tag}: {line} {meta}")
        diffs = code_diffs(checkpoint.load_arrays(out, device="cpu"),
                           checkpoint.load_arrays(VIT_Q4KM, device="cpu"))
        p_km = load_mobilevit(out, device=dev)
    d = sum(v[0] for v in diffs.values())
    n = sum(v[1] for v in diffs.values())
    worst = max(diffs.items(), key=lambda kv: kv[1][0] / kv[1][1])
    log(f"[{tag}] quantize --qtype q4_k_m --calibrate task:1234 of mobilevit_synth_full.ggml "
        f"on the card (384 images): {split_line(timer.seconds, total)} | {json.dumps(line)}")
    log(f"[{tag}] codes differing from the shipped mobilevit_synth_full_q4km.gxt (made by the "
        f"JAX package): {d:,} of {n:,} over {len(diffs)} tensors; the most in {worst[0]} "
        f"({worst[1][0]:,} of {worst[1][1]:,})")
    check(p_km.layer_3.transformer[0].attention.flash and p_km.layer_3.transformer[0].fused,
          f"{tag}: the port-made file did not load on the default routes")
    # the default routes: the f32 fused layer and the f32 fused inverted
    # residual at f32; the fused layer and the fused inverted residual at
    # bf16 (the float model's bf16 + fused_ir route)
    layer = {"fused_transformer_layer": 9, **{k: 9 for k in LAYER_KERNELS},
             "fused_inverted_residual": sum(blk.fused_route(bf16, dev)
                                            for blk in ir_blocks(p_km)),
             "inverted_residual_s2": sum(blk.fused_route(bf16, dev) for blk in ir_blocks(p_km)
                                         if blk.conv_3x3.stride == 2)}
    n_ir32 = sum(blk.fused_route(f32, dev) for blk in ir_blocks(p_km))
    n_s2_32 = sum(blk.fused_route(f32, dev) for blk in ir_blocks(p_km) if blk.conv_3x3.stride == 2)
    f32_route = {**f32_attention_launches(9), "fused_inverted_residual": n_ir32,
                 "inverted_residual_f32": n_ir32 - n_s2_32, "inverted_residual_s2_f32": n_s2_32}
    for name, cd, per_batch, ref_route in (("f32", f32, f32_route, "f32"),
                                           ("bf16", bf16, layer, "bf16+fused_ir")):
        got, launches = run_classify(p_km, cd)
        for k, v in per_batch.items():
            check(launches[k] == v * nb, f"{tag}: classify {name}: {launches[k]} {k} launches, "
                                         f"want {v} a batch x {nb}")
        # every MobileViT weight is under qmatmul's dispatch gate (K*N <= 2^20):
        # torch.matmul on the dequantized plane, as the JAX package leaves it to XLA
        others = {k: v for k, v in launches.items() if v and k not in per_batch}
        check(not others, f"{tag}: classify {name} launched {others}")
        want = logits[ref_route]
        agree, flips = argmax_near_ties(f"{tag}: q4_k_m {name} vs the float model", got, want,
                                        VIT_NEAR_TIE)
        rel = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
        check(agree >= KM_VIT_AGREE, f"{tag}: classify {name}: agreement {agree:.4f}")
        if cd == f32:
            check(rel < KM_VIT_REL, f"{tag}: classify f32: relative logit RMSE {rel:.4g}")
        top1 = float((got.argmax(-1).numpy() == labels).mean())
        log(f"[{tag}] the port-made file, classify {name} of {len(images)} held-out images: "
            f"top-1 {top1:.4f}, argmax agreement with the float model's {ref_route} route "
            f"{agree:.4f} ({flips} flips, at near-ties), relative logit RMSE {rel:.5f}"
            f"{' (limit %g)' % KM_VIT_REL if cd == f32 else ''} | launches " + ", ".join(
                f"{k} {launches[k]}" for k in per_batch))
    del p_km

    # 2. eval of the weight.ggml on the card (f32: the f32 layer's route)
    attn = tuple(f32_attention_launches(1))
    for qtype in ("q4_k", "q8_0"):
        port.reset_kernel_launches()
        rc, text, sec = run_command(["eval", "--weights", VIT_CKPT, "--qtype", qtype,
                                     "--device", "cuda"])
        launches = port.kernel_launches()
        check(rc == 0 and all(launches[k] > 0 for k in attn),
              f"{tag}: eval --qtype {qtype}: rc {rc}, launches {launches}")
        log(f"[{tag}] eval --weights mobilevit_synth_full.ggml --qtype {qtype} on the card: "
            f"{sec:.2f} s wall | {text.strip()} | launches " + ", ".join(
                f"{k} {launches[k]}" for k in attn))

    # 3. activation storage on the bf16 + fused_ir route
    xb = x_all[:VIT_BATCH].to(dev)
    # parts 3-4 compare load options on the bf16 route without the fused
    # inverted residual, whose depthwise taps stay f32 whatever the storage
    p = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False)
    with torch.no_grad():
        ref32 = extract_features(p, xb)
    base = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    rows = [("none", "-", base)] + [
        (store, scope, load_mobilevit(VIT_CKPT, device=dev, fused_ir=True, act_storage=store,
                                      act_storage_scope=scope))
        for store, scope in STORE_RUNS]
    rel = {}
    for store, scope, params in rows:
        out, launches = run_classify(params, bf16)
        n_ir = sum(blk.fused_route(bf16, dev) for blk in ir_blocks(params))
        check(launches["fused_inverted_residual"] == n_ir * nb,
              f"{tag}: {store}/{scope}: {launches['fused_inverted_residual']} inverted residual "
              f"launches, want {n_ir} a batch x {nb}")
        with torch.no_grad():
            feats = extract_features(params, xb, compute_dtype=bf16)
        rel[(store, scope)] = float((feats - ref32).norm() / ref32.norm())
        ms = cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
        top1 = float((out.argmax(-1).numpy() == labels).mean())
        log(f"[{tag}] bf16 + fused_ir, act_storage {store} scope {scope}: extract_features "
            f"B={VIT_BATCH} {ms:.3f} ms = {VIT_BATCH / ms * 1e3:,.0f} images/s | feature "
            f"relative RMSE against f32 {rel[(store, scope)]:.4f} | top-1 on {len(images)} "
            f"images {top1:.4f} | fused_inverted_residual launches "
            f"{launches['fused_inverted_residual']}")
    e, a = rel[("f8_e5m2", "early")], rel[("f8_e5m2", "all")]
    check(e < STORE_REL["early"] and e < a < STORE_REL["all"],
          f"{tag}: f8_e5m2 feature noise early {e:.4f}, all {a:.4f}")
    del rows, base

    # 4. the space-to-depth stem and bf16 convolution kernels
    s2d = load_mobilevit(VIT_CKPT, device=dev, stem_space_to_depth=True, fused_ir=False)
    cb = load_mobilevit(VIT_CKPT, device=dev, conv_dtype="bfloat16", fused_ir=False)
    with torch.no_grad():
        r = float((extract_features(s2d, xb) - ref32).abs().max() / ref32.abs().max())
        check(r <= VIT_CPU_FEATURE_REL, f"{tag}: space-to-depth f32 features: max rel {r:.3g}")
        b16 = extract_features(p, xb, compute_dtype=bf16)
        rb = float((extract_features(s2d, xb, compute_dtype=bf16) - b16).norm() / b16.norm())
        rc32 = float((extract_features(cb, xb) - ref32).norm() / ref32.norm())
        rcb = float((extract_features(cb, xb, compute_dtype=bf16) - b16).norm() / b16.norm())
    check(rcb == 0.0, f"{tag}: bf16-stored kernels change the bf16 forward ({rcb:.3g})")
    log(f"[{tag}] stem_space_to_depth: f32 features max rel err {r:.3g} against the standard "
        f"stem (limit {VIT_CPU_FEATURE_REL}), bf16 relative RMSE {rb:.4f} | conv_dtype "
        f"bfloat16: f32 features relative RMSE {rc32:.4g}, bf16 features equal")
    stem_ms = {}
    for name, params in (("standard", p), ("space-to-depth", s2d)):
        for cd in (f32, bf16):
            xin = xb.to(cd)
            params.conv_stem(xin, compute_dtype=cd)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params.conv_stem(xin, compute_dtype=cd)
                torch.cuda.synchronize()
            stem_ms[(name, cdname(cd))] = sum(
                getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA) / 1e3
    fwd_ms = {name: cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
              for name, params in (("standard", p), ("space-to-depth stem", s2d),
                                   ("bf16 conv kernels", cb))}
    log(f"[{tag}] the stem at B={VIT_BATCH} under torch.profiler (device ms): " + ", ".join(
        f"{k[0]} {k[1]} {v:.4f}" for k, v in stem_ms.items()) + f" | extract_features "
        f"B={VIT_BATCH} bf16: " + ", ".join(f"{k} {v:.3f} ms" for k, v in fwd_ms.items()))
    del s2d, cb, p

    # 5. training on the image task: the tiny checkpoint with its head drawn anew
    named = dict(read_named_tensors(VIT_TINY))
    head = next(k for k in named if k.endswith("classifier/kernel:0"))
    named[head] = (np.random.default_rng(0).standard_normal(named[head].shape) * 0.01
                   ).astype(np.float32)
    tx, ty = image_task.make_dataset(TRAIN_VIT_IMAGES, seed=image_task.TRAIN_SEED, image_size=64)
    image_task.train_model(named, tx, ty, steps=2, batch=TRAIN_VIT_BATCH, log_every=0,
                           device=dev)
    port.reset_kernel_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        trained, last = image_task.train_model(named, tx, ty, steps=TRAIN_VIT_STEPS,
                                               batch=TRAIN_VIT_BATCH, log_every=1, device=dev)
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in port.kernel_launches().items() if v}
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in buf.getvalue().splitlines()
              if ln.startswith("step ")]
    check(len(losses) == TRAIN_VIT_STEPS and np.isfinite(losses).all()
          and np.mean(losses[-5:]) < np.mean(losses[:5]), f"{tag}: train_model losses {losses}")
    # the kernels are forward-only: a launch here would cut the gradient
    check(not launches, f"{tag}: train_model launched {launches}, not the plain path")
    log(f"[{tag}] train_model, mobilevit_synth.ggml (TINY_CLS_CONFIG, head drawn anew), "
        f"{TRAIN_VIT_STEPS} steps at batch {TRAIN_VIT_BATCH} on the card: "
        f"{sec / TRAIN_VIT_STEPS * 1e3:.2f} ms a step (each step's loss read back) | loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {np.mean(losses[:5]):.4f}, last "
        f"five {np.mean(losses[-5:]):.4f}) | kernel launches {launches or 'none'} (the "
        f"plain path)")


# ---- phases 18-20: HTTP serving, the dispatch gates and ``bench`` -----------------


def http_call(port, method, path, payload=None, raw=None, headers=None, timeout=300):
    """(status, reply bytes) of one request to a front end on this machine."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as ex:
        return ex.code, ex.read()


def serve_subprocess(argv, pattern):
    """Start ``python -m ggml_experiments_tpu_torch ARGV`` and wait for the
    line that gives its port on stderr: (process, port)."""
    import re
    import select

    proc = subprocess.Popen([sys.executable, "-m", "ggml_experiments_tpu_torch", *argv],
                            stderr=subprocess.PIPE, cwd=REPO)
    buf = b""
    deadline = time.time() + 300
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 0.2)
        if ready:
            chunk = os.read(proc.stderr.fileno(), 4096)
            buf += chunk
            m = re.search(pattern, buf)
            if m:
                return proc, int(m.group(1))
        if proc.poll() is not None:
            break
    proc.kill()
    proc.wait(timeout=30)
    raise SmokeFailure(f"{argv[0]} --http gave no port: rc {proc.returncode}, stderr "
                       f"{buf[-2000:]!r}")


def stop_subprocess(proc, what):
    """SIGINT, then the exit code must be 0."""
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise SmokeFailure(f"{what} did not stop on SIGINT")
    check(rc == 0, f"{what} exited {rc} on SIGINT")


def http_text_phase(tag, dev, rng, tok):
    """Phase 18: HttpFrontend over a DecodeEngine of HTTP_ENGINE_SHAPE (the
    fused tick) on gru_shakespeare.bin q8_0, bf16: HTTP_REQUESTS requests
    from HTTP_CLIENTS client threads, half streamed, HTTP_CANCELS of the
    streamed ones canceled by DELETE after their first token; every reply
    equal to the offline fused decode (a canceled one: its prefix); then the
    ``serve --http 0`` command (its defaults: 16 slots x 16 inner steps, f32)
    answering 4 requests equal to ``generate`` (forks only at near-ties),
    stopped by SIGINT."""
    import concurrent.futures
    import http.client

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.http import HttpFrontend

    bf16 = torch.bfloat16
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    n_slots, inner = HTTP_ENGINE_SHAPE
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16)
    check(eng.use_fused_tick, f"{tag}: the engine gate sends {n_slots} x {inner} to the scan")
    prompts = corpus_prompts(tok, rng, HTTP_REQUESTS, 1, 64)
    new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
    stream = [i % 2 == 1 for i in range(len(prompts))]
    cancel = set(range(1, 2 * HTTP_CANCELS, 2))
    for i in cancel:
        new_toks[i] = HTTP_CANCEL_NEW      # long enough to be cut short
    offline = fused.fused_gru_decode(params, *pad_batch(prompts, 64), 64 + max(new_toks),
                                     compute_dtype=bf16).cpu().numpy()
    eng.start()
    front = HttpFrontend(eng, tok, port=0)
    front.start()

    def one(i):
        text = tok.decode(prompts[i].tolist())
        payload = {"prompt": text, "max_new_tokens": new_toks[i], "stream": stream[i]}
        if not stream[i]:
            code, body = http_call(front.port, "POST", "/v1/generate", payload)
            check(code == 200, f"{tag}: request {i}: HTTP {code} {body[:200]!r}")
            reply = json.loads(body)
            return reply["tokens"], reply["canceled"]
        conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=300)
        conn.request("POST", "/v1/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"{tag}: stream {i}: HTTP {resp.status}")
        rid = json.loads(resp.readline())["id"]
        toks, final = [], None
        while final is None:
            line = json.loads(resp.readline())
            if "token" in line:
                toks.append(line["token"])
                if i in cancel and len(toks) == 1:
                    code, _ = http_call(front.port, "DELETE", f"/v1/requests/{rid}")
                    check(code == 200, f"{tag}: DELETE of request {rid}: HTTP {code}")
            else:
                final = line
        resp.read()     # the closing chunk
        conn.close()
        check(final["done"] and final["generated"] == len(toks),
              f"{tag}: stream {i}: final chunk {final}")
        return toks, final["canceled"]

    port.reset_kernel_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        replies = list(pool.map(one, range(len(prompts))))
    wall = time.perf_counter() - t0
    launches = port.kernel_launches()
    code, health = http_call(front.port, "GET", "/v1/health")
    health = json.loads(health)
    code2, stats = http_call(front.port, "GET", "/v1/stats")
    stats = json.loads(stats)
    front.stop()
    eng.stop()
    check(code == code2 == 200 and health["status"] == "ok" and health["slots"] == n_slots,
          f"{tag}: /v1/health {code} {health}")
    check(launches["fused_slot_tick"] > 0, f"{tag}: the tick kernel was not launched: {launches}")
    cut, generated = 0, 0
    for i, (toks, canceled) in enumerate(replies):
        total = prompts[i].size + new_toks[i]
        want = offline[i, :total].tolist()
        generated += max(0, len(toks) - prompts[i].size)
        if i in cancel:
            check(canceled and toks == want[:len(toks)],
                  f"{tag}: canceled request {i}: not a prefix of the offline decode")
            cut += len(toks) < total
        else:
            check(not canceled and toks == want,
                  f"{tag}: request {i} ({'streamed' if stream[i] else 'whole'}) differs from "
                  f"the offline decode")
    check(cut > 0, f"{tag}: no DELETE landed before its request finished")
    check(stats["requests_completed"] + stats["requests_canceled"] >= len(prompts) - len(cancel)
          and stats["tokens_generated"] > 0, f"{tag}: /v1/stats {stats}")
    log(f"[{tag}] HttpFrontend over a {n_slots} x {inner} engine (fused tick, q8_0 bf16): "
        f"{len(prompts)} requests from {HTTP_CLIENTS} clients ({sum(stream)} streamed, "
        f"{len(cancel)} canceled by DELETE, {cut} of them cut short) in {wall:.3f} s = "
        f"{len(prompts) / wall:.1f} requests/s, {generated:,} new tokens = "
        f"{generated / wall:,.0f} tokens/s; every reply equal to the offline decode | tick "
        f"launches {launches['fused_slot_tick']} | /v1/stats {json.dumps(stats)}")

    # the command, at its defaults: 16 slots x 16 inner steps (the scan tick), f32
    proc, port_no = serve_subprocess(["serve", "--weights", CKPT, "--qtype", "q8_0",
                                      "--http", "0"], rb"serving HTTP on 127\.0\.0\.1:(\d+)")
    try:
        sub = corpus_prompts(tok, rng, 4, 8, 40)
        t0 = time.perf_counter()
        got = []
        for p in sub:
            code, body = http_call(port_no, "POST", "/v1/generate",
                                   {"prompt": tok.decode(p.tolist()), "max_new_tokens": 64})
            check(code == 200, f"{tag}: serve --http: HTTP {code} {body[:200]!r}")
            got.append(json.loads(body)["tokens"])
        sub_s = time.perf_counter() - t0
    finally:
        stop_subprocess(proc, "serve --http")
    ids, lens = pad_batch(sub, 40)
    want = gru_textgen.generate(params, ids, lens, 40 + 64, compute_dtype=torch.float32).cpu()
    rows = [np.asarray(g[:p.size + 64]) for g, p in zip(got, sub)]
    for i, (row, p) in enumerate(zip(rows, sub)):
        check(row.size == p.size + 64, f"{tag}: serve --http reply {i}: {row.size} tokens")
    width = min(r.size for r in rows)
    got_t = torch.from_numpy(np.stack([r[:width] for r in rows]))
    z = torch.zeros(len(sub), dtype=torch.int32, device=dev)
    tf = torch.full((len(sub),), width, dtype=torch.int32, device=dev)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(params), want[:, :width].to(dev),
                                        tf, tf, z, z, torch.zeros(len(sub), 1024, device=dev),
                                        width, torch.float32, margins=True)
    agree, forked = first_divergence_near_ties(got_t, want[:, :width], gaps.cpu(),
                                               NEAR_TIE["float32"], f"{tag}: serve --http")
    log(f"[{tag}] serve --http 0 (its defaults: 16 slots x 16 inner steps, f32): 4 requests in "
        f"{sub_s:.2f} s, tokens vs generate: agreement {agree:.6f}, {forked} rows fork (at "
        f"near-ties) | stopped by SIGINT, rc 0")


def ppm_bytes(u8):
    h, w, _ = u8.shape
    return f"P6\n{w} {h}\n255\n".encode() + u8.tobytes()


def http_vision_phase(tag, dev, images):
    """Phase 19: HttpFrontend over a VisionEngine (ladder 8/32/128, u8
    transport, bf16) on the full checkpoint at its default routes: phase
    14's held-out images as raw PPM bodies and as JSON ``image_b64``, to
    /v1/classify and /v1/features from HTTP_CLIENTS threads; the top-1
    against the offline classify of the same u8 images under the near-tie
    rule, the features' debug vectors against the offline forward; the
    fused layer and the inverted residual launched; an oversize body 413;
    then the ``serve-vision --http 0`` command for 4 requests."""
    import base64
    import concurrent.futures
    import http.client

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.serving import VisionEngine
    from ggml_experiments_tpu_torch.serving.http import MAX_BODY_BYTES, HttpFrontend

    bf16 = torch.bfloat16
    params = load_mobilevit(VIT_CKPT, device=dev)
    u8 = np.clip(np.round(images[:HTTP_IMAGES] * 255.0), 0, 255).astype(np.uint8)
    x = torch.from_numpy(u8).to(dev).float() / 255.0
    want_cls = classify(params, x, compute_dtype=bf16).float().cpu()
    want_feat = extract_features(params, x, compute_dtype=bf16).float().cpu()
    del x
    eng = VisionEngine(params, image_size=256, batch_sizes=(8, 32, 128), compute_dtype=bf16)
    eng.start()
    front = HttpFrontend(None, vision=eng, port=0)
    front.start()

    def one(i):
        kind = "classify" if i % 4 < 2 else "features"
        if i % 2 == 0:
            code, body = http_call(front.port, "POST", f"/v1/{kind}", raw=ppm_bytes(u8[i]),
                                   headers={"Content-Type": "image/x-portable-pixmap"})
        else:
            code, body = http_call(front.port, "POST", f"/v1/{kind}",
                                   {"image_b64": base64.b64encode(ppm_bytes(u8[i])).decode()})
        check(code == 200, f"{tag}: image {i} {kind}: HTTP {code} {body[:200]!r}")
        return kind, json.loads(body)

    port.reset_kernel_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        replies = list(pool.map(one, range(len(u8))))
    wall = time.perf_counter() - t0
    launches = port.kernel_launches()
    conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=60)
    conn.putrequest("POST", "/v1/classify")
    conn.putheader("Content-Type", "image/png")
    conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    conn.endheaders()
    big = conn.getresponse().status
    conn.close()
    code, stats = http_call(front.port, "GET", "/v1/vision/stats")
    front.stop()
    eng.stop()
    check(big == 413, f"{tag}: an oversize body got HTTP {big}, want 413")
    check(launches["fused_inverted_residual"] > 0 and launches["fused_transformer_layer"] > 0,
          f"{tag}: the fused layer or the inverted residual was not launched: {launches}")
    got_cls, ref_cls, feat_err, scale = [], [], 0.0, 0.0
    for i, (kind, reply) in enumerate(replies):
        if kind == "classify":
            top = reply["top"]
            row = torch.full((want_cls.shape[1],), -1e30)
            for cls_id, logit in top:
                row[cls_id] = logit
            got_cls.append(row)
            ref_cls.append(want_cls[i])
        else:
            vec = want_feat[i, 0, 0]
            w = torch.cat([vec[:5], vec[-5:]])
            g = torch.tensor(reply["first5"] + reply["last5"])
            check(reply["shape"] == list(want_feat.shape[1:]),
                  f"{tag}: features {i}: shape {reply['shape']}")
            feat_err = max(feat_err, float((g - w).abs().max()))
            scale = max(scale, float(want_feat[i].abs().max()))
    check(feat_err <= VIT_ENGINE_FEATURE_MAX * scale,
          f"{tag}: features differ from the offline forward by {feat_err:.3g} (limit "
          f"{VIT_ENGINE_FEATURE_MAX} x {scale:.3g})")
    agree, flips = argmax_near_ties(f"{tag}: HTTP classify vs offline", torch.stack(got_cls),
                                    torch.stack(ref_cls), VIT_NEAR_TIE)
    log(f"[{tag}] HttpFrontend over a VisionEngine (8/32/128, u8, bf16, default routes): "
        f"{len(u8)} images (PPM bodies and image_b64, classify and features) from "
        f"{HTTP_CLIENTS} clients in {wall:.3f} s = {len(u8) / wall:.1f} requests/s | top-1 "
        f"agreement with the offline classify {agree:.4f} ({flips} flips, at near-ties), "
        f"features max abs err {feat_err:.3g} (largest {scale:.3g}) | launches: fused layer "
        f"{launches['fused_transformer_layer']}, inverted residual "
        f"{launches['fused_inverted_residual']} | oversize body: 413 | /v1/vision/stats "
        f"{stats.decode().strip()}")

    proc, port_no = serve_subprocess(["serve-vision", "--weights", VIT_CKPT, "--compute",
                                      "bfloat16", "--http", "0"],
                                     rb"vision service on 127\.0\.0\.1:(\d+)")
    try:
        t0 = time.perf_counter()
        tops = []
        for i in range(4):
            code, body = http_call(port_no, "POST", "/v1/classify", raw=ppm_bytes(u8[i]),
                                   headers={"Content-Type": "image/x-portable-pixmap"})
            check(code == 200, f"{tag}: serve-vision: HTTP {code} {body[:200]!r}")
            tops.append(json.loads(body)["top"][0])
        sub_s = time.perf_counter() - t0
    finally:
        stop_subprocess(proc, "serve-vision")
    for i, (cls_id, _) in enumerate(tops):
        if cls_id != int(want_cls[i].argmax()):
            top2 = want_cls[i].topk(2).values
            check(float(top2[0] - top2[1]) < VIT_NEAR_TIE,
                  f"{tag}: serve-vision image {i}: top-1 {cls_id}, offline "
                  f"{int(want_cls[i].argmax())}")
    log(f"[{tag}] serve-vision --http 0: 4 classify requests in {sub_s:.2f} s, top-1 as "
        f"offline (near-tie rule) | stopped by SIGINT, rc 0")


def gates_phase(tag, dev, rng, tok):
    """Phase 20: the committed dispatch gates at their edges (no calibration
    file: GXT_TORCH_DECODE_DISPATCH names a missing one), read from the launch
    counters, then the ``bench`` command's JSON lines."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen, mobilevit
    from ggml_experiments_tpu_torch.serving import DecodeEngine, engine as engine_mod

    bf16 = torch.bfloat16
    thr = gru_textgen.dispatch_thresholds(reload=True)
    check(thr["source"] == "default" and thr["min_b"] == gru_textgen.DECODE_FUSED_MIN_B
          and thr["min_t"] == gru_textgen.DECODE_FUSED_MIN_T,
          f"{tag}: decode thresholds {thr} are not the committed ones")
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)

    def decode_launches(b, t, cd):
        ids, lens = pad_batch(corpus_prompts(tok, rng, b, 1, 16), 16)
        port.reset_kernel_launches()
        out = gru_textgen.decode(params, ids, lens, t, compute_dtype=cd)
        torch.cuda.synchronize()
        check(out.shape == (b, t), f"{tag}: decode ({b}, {t}) shape {tuple(out.shape)}")
        return port.kernel_launches()["fused_gru_decode"]

    # at the thresholds, and one step of the sweeps' doubling grids past each
    min_b, min_t = thr["min_b"], thr["min_t"]
    cap = gru_textgen.DECODE_FUSED_MAX_B_F32
    f32 = torch.float32
    checks = [((min_b, min_t, bf16), True), ((min_b // 2, min_t, bf16), False),
              ((min_b, min_t // 2, bf16), False), ((cap, min_t, f32), True),
              ((2 * cap, min_t, f32), False), ((2 * cap, min_t, bf16), True)]
    for (b, t, cd), fused_want in checks:
        n = decode_launches(b, t, cd)
        check((n > 0) == fused_want, f"{tag}: decode({b}, {t}, {cdname(cd)}) launched the "
                                     f"persistent kernel {n} times (want "
                                     f"{'some' if fused_want else 'none'})")
    log(f"[{tag}] decode() gate (B, T) >= ({min_b}, {min_t}), at f32 B <= {cap}: "
        + ", ".join(f"({b}, {t}, {cdname(cd)}) -> {'fused' if f else 'scan'}"
                    for (b, t, cd), f in checks))

    slots, inner = engine_mod.FUSED_TICK_MIN_SLOTS, engine_mod.FUSED_TICK_MIN_INNER
    cap = engine_mod.FUSED_TICK_MAX_SLOTS_F32
    f32 = torch.float32
    ecks = [((slots, inner, bf16), True), ((slots // 2, inner, bf16), False),
            ((slots, inner // 2, bf16), False), ((2 * cap, inner, bf16), True),
            ((cap, inner, f32), True), ((2 * cap, inner, f32), False)]
    for (s, i, cd), fused_want in ecks:
        eng = DecodeEngine(params, n_slots=s, max_prompt=16, inner_steps=i, compute_dtype=cd)
        check(eng.use_fused_tick == fused_want, f"{tag}: engine {s} x {i} {cdname(cd)}: fused "
                                                f"tick {eng.use_fused_tick}")
        port.reset_kernel_launches()
        reqs = [eng.submit(p, 8) for p in corpus_prompts(tok, rng, 4, 1, 16)]
        eng.run_until_idle(timeout_s=300)
        n = port.kernel_launches()
        check(all(r._done.is_set() for r in reqs)
              and (n["fused_slot_tick"] > 0) == fused_want
              and (n["qmatmul_q8_0"] > 0) != fused_want,
              f"{tag}: engine {s} x {i} {cdname(cd)} launched {n['fused_slot_tick']} ticks, "
              f"{n['qmatmul_q8_0']} qmatmuls")
    log(f"[{tag}] engine gate (n_slots, inner) >= ({slots}, {inner}), at f32 n_slots <= {cap}: "
        + ", ".join(f"({s}, {i}, {cdname(cd)}) -> {'fused' if f else 'scan'}"
                    for (s, i, cd), f in ecks))

    vit = mobilevit.load_mobilevit(VIT_CKPT, device=dev)
    blocks = ir_blocks(vit)
    want_ir = {cdname(cd): sum(blk.fused_route(cd, dev) for blk in blocks)
               for cd in (bf16, torch.float32)}
    x = torch.rand((8, 256, 256, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    got_ir = {}
    for cd in (bf16, torch.float32):
        port.reset_kernel_launches()
        mobilevit.extract_features(vit, x, compute_dtype=cd)
        torch.cuda.synchronize()
        got_ir[cdname(cd)] = port.kernel_launches()["fused_inverted_residual"]
    widths = [(blk.conv_3x3.stride, blk.expand_1x1.kernel.shape[-1]) for blk in blocks]
    # every block of E >= IR_FUSED_MIN_EXPAND: stride 1 and stride 2 at both dtypes
    routed = {cdname(cd): sum(e >= mobilevit.IR_FUSED_MIN_EXPAND for _, e in widths)
              for cd in (bf16, torch.float32)}
    check(want_ir == routed and min(want_ir.values()) > 0 and got_ir == want_ir,
          f"{tag}: fused_ir default: {got_ir} inverted-residual launches a forward, want "
          f"{routed} ((stride, E) {widths}, E >= {mobilevit.IR_FUSED_MIN_EXPAND})")
    log(f"[{tag}] fused_ir default on the card: E >= {mobilevit.IR_FUSED_MIN_EXPAND} of the "
        f"(stride, E) {widths}, at both strides and dtypes: "
        f"{got_ir} launches a forward")
    del vit, x
    torch.cuda.empty_cache()

    for argv in (["bench", "--model", "gru", "--batch", "1024", "--steps", "256",
                  "--qtype", "q8_0", "--compute", "bfloat16"],
                 ["bench", "--model", "mobilevit", "--batch", "128", "--compute", "bfloat16"],
                 ["bench", "--model", "mobilevit", "--batch", "128", "--compute", "float32"]):
        rc, out, sec = run_command(argv)
        line = json.loads(out.strip().splitlines()[-1])
        check(rc == 0 and line["device"] == torch.cuda.get_device_name(0)
              and line["ms_per_call"] > 0 and np.isfinite(line["ms_per_call"]),
              f"{tag}: {' '.join(argv)}: rc {rc}, {line}")
        log(f"[{tag}] {' '.join(argv)} ({sec:.1f} s): {json.dumps(line)}")


# ---------------------------------------------------------------------------
# phase 21: multi-device serving (the parent spawns this script as ranks)
# ---------------------------------------------------------------------------

def md_request_set(rng, tok, n, lo, hi, new_lo, new_hi, temp=0.0):
    prompts = corpus_prompts(tok, rng, n, lo, hi)
    return [(p, int(rng.integers(new_lo, new_hi + 1)), temp) for p in prompts]


def md_save_requests(path, reqs):
    import numpy as np

    np.savez(path, flat=np.concatenate([p for p, _, _ in reqs]).astype(np.int32),
             lens=np.asarray([p.size for p, _, _ in reqs], np.int32),
             new=np.asarray([n for _, n, _ in reqs], np.int32),
             temp=np.asarray([t for _, _, t in reqs], np.float32))


def md_load_requests(path):
    import numpy as np

    with np.load(path) as f:
        ends = np.cumsum(f["lens"])
        return [(f["flat"][e - n:e], int(nw), float(t))
                for e, n, nw, t in zip(ends, f["lens"], f["new"], f["temp"])]


def md_save_tokens(path, tokens):
    import numpy as np

    np.savez(path, flat=np.concatenate(tokens).astype(np.int32),
             lens=np.asarray([len(t) for t in tokens], np.int32))


def md_load_tokens(path):
    import numpy as np

    with np.load(path) as f:
        ends = np.cumsum(f["lens"])
        return [f["flat"][e - n:e] for e, n in zip(ends, f["lens"])]


def md_serve(eng, reqs):
    """The primary submits ``reqs`` in order; every rank drives the loop.
    Returns (the primary's tokens, seconds)."""
    import torch

    from ggml_experiments_tpu_torch.parallel import multihost

    multihost.sync_hosts()
    t0 = time.perf_counter()
    handles = ([eng.submit(p, n, temperature=t) for p, n, t in reqs]
               if multihost.is_primary() else [])
    eng.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    return [h.result(timeout=0) for h in handles], time.perf_counter() - t0


def md_in_turn(rank, world, fn):
    """``fn()`` on each rank in turn (the others wait at barriers), so that
    two ranks on one card are timed alone. Returns this rank's result."""
    from ggml_experiments_tpu_torch.parallel import multihost

    out = None
    for r in range(world):
        multihost.sync_hosts()
        if r == rank:
            out = fn()
    multihost.sync_hosts()
    return out


def md_serve_rank(tag, work, rank, world, dev):
    """Rank ``rank`` of phase 21's two-rank session: (a) the slot-sharded
    fused tick engine, its shard tick against the plain version; (b) the
    tensor-parallel scan tick and the qmatmul kernel on a column shard; (c)
    the data-parallel MobileViT forward."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models.mobilevit import (
        extract_features_data_parallel,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.parallel import (
        gru_param_specs,
        make_mesh,
        multihost,
        place,
        sharding,
    )
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.engine import init_state

    f32, bf16 = torch.float32, torch.bfloat16
    primary = multihost.is_primary()
    out = {"rank": rank}
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    wf = fused._prep_weights(params)
    n_slots, inner = MD_ENGINE_SHAPE

    # ---- (a) the slot-sharded fused tick --------------------------------------------
    mesh = make_mesh((world, 1))
    dp = place(params, gru_param_specs(params), mesh)   # every leaf replicated
    eng = DecodeEngine(dp, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                       top_k=20, top_p=0.9)
    check(eng._fused_slot_axis == "data", f"{tag}: the tick is not slot-sharded")
    reqs = md_load_requests(os.path.join(work, "serve.npz"))
    port.reset_kernel_launches()
    toks, secs = md_serve(eng, reqs)        # timed as it runs: nothing patched in
    out["serve"] = dict(launches=port.kernel_launches()["fused_slot_tick"],
                        digest=eng.state_digest(), steps=eng.stats.device_steps, seconds=secs,
                        tokens_per_s=eng.stats.tokens_per_s, held=sum(
                            r is not None for r in eng._slot_req.values()),
                        plan=str(fused.LAST_PLAN.get("fused_slot_tick")))
    # a second engine serves the same requests with each tick's gather
    # instrumented (a synchronize and a barrier a tick, which the timed run
    # above does not carry): the wait for the peer's tick, then the gather
    gathers, waits = [], []
    real_gather = fused._gather_slots

    def timed_gather(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multihost.sync_hosts()
        t1 = time.perf_counter()
        res = real_gather(*a)
        torch.cuda.synchronize()
        waits.append(t1 - t0)
        gathers.append(time.perf_counter() - t1)
        return res

    eng2 = DecodeEngine(dp, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                        compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                        top_k=20, top_p=0.9)
    fused._gather_slots = timed_gather
    try:
        toks2, _ = md_serve(eng2, reqs)
    finally:
        fused._gather_slots = real_gather
    check(eng2.state_digest() == out["serve"]["digest"] and all(
        np.array_equal(a, b) for a, b in zip(toks, toks2)),
        f"{tag}: rank {rank}: the instrumented run served other tokens")
    out["serve"].update(gather_ms=[round(1e3 * g, 3) for g in gathers],
                        wait_ms=[round(1e3 * w, 3) for w in waits])
    del eng2
    # the same gather, warm, ten times in lockstep: of a tensor on the card
    # and of a host tensor
    row = 4 * wf.u + 8 + inner
    for where, buf in (("cuda", torch.zeros((n_slots // world, row), dtype=torch.uint8,
                                            device=dev)),
                       ("host", torch.zeros((n_slots // world, row), dtype=torch.uint8))):
        times = []
        for _ in range(11):
            multihost.sync_hosts()
            t0 = time.perf_counter()
            mesh.all_gather(buf, "data")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["serve"][f"gather_{where}_ms"] = 1e3 * statistics.median(times[1:])
    if primary:
        md_save_tokens(os.path.join(work, "serve_tokens.npz"), toks)

    # each rank's shard of one identical sampled tick against its plain version
    shard = fused.tick_shard(n_slots, wf.mode, inner, world, rank)
    lo, hi = shard.lo, shard.hi
    ids, lens = pad_batch([p for p, _, _ in reqs[:n_slots]], 64)
    st = init_state(params, n_slots, 64)
    st.prompt, st.plen = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    st.total = st.plen + inner
    st.temp = torch.full((n_slots,), 0.8, device=dev)
    kw = dict(enable_sampling=True, seed=12345, top_k=20, top_p=0.9)
    h_k, prev_k, pos_k, t_k = fused.fused_slot_tick_shard(params, st, inner, shard,
                                                          compute_dtype=bf16, **kw)
    sl = slice(lo, hi)
    t_p, _, _, pos_p, gaps = fused.gru_loop_reference(
        wf, st.prompt[sl], st.plen[sl], st.total[sl], st.prev[sl], st.pos[sl], st.h[sl], inner,
        bf16, temp=st.temp[sl], seed=12345, top_k=20, top_p=0.9, margins=True,
        slot_base=shard.slot_base, key_tile=shard.key_tile)
    check(torch.equal(pos_k, pos_p), f"{tag}: rank {rank}: shard tick cursors differ")
    agree, forked = first_divergence_near_ties(t_k.int(), t_p, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: rank {rank} sampled shard tick")
    unkeyed = fused.gru_loop_cuda("fused_slot_tick", wf, st.prompt[sl], st.plen[sl],
                                  st.total[sl], st.prev[sl], st.pos[sl], st.h[sl], inner, bf16,
                                  temp=st.temp[sl], seed=12345, top_k=20, top_p=0.9,
                                  toks_u8=True)[0]
    # the rows whose sampled steps (past the prompt) drew another stream
    sampled_steps = torch.arange(inner, device=dev)[None, :] >= st.plen[sl, None]
    rows = sampled_steps.any(dim=1)
    rekeyed = float(((unkeyed != t_k) & sampled_steps).any(dim=1)[rows].float().mean())
    check(rank == 0 or rekeyed > 0.5, f"{tag}: rank {rank}: the shard's keys changed "
                                      f"{rekeyed:.3f} of its sampled rows' streams")
    # teacher-forced at f32: h against the plain version
    tf_st = init_state(params, n_slots, inner)
    tf_st.prompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, wf.v, (n_slots, inner)).astype(np.int32)).to(dev)
    tf_st.plen = torch.full((n_slots,), inner, dtype=torch.int32, device=dev)
    tf_st.total = tf_st.plen.clone()
    h_k, _, _, tt_k = fused.fused_slot_tick_shard(params, tf_st, inner, shard, compute_dtype=f32)
    tt_p, h_p, *_ = fused.gru_loop_reference(
        wf, tf_st.prompt[sl], tf_st.plen[sl], tf_st.total[sl], tf_st.prev[sl], tf_st.pos[sl],
        tf_st.h[sl], inner, f32, slot_base=shard.slot_base, key_tile=shard.key_tile)
    tf_err = float((h_k - h_p).abs().max())
    check(torch.equal(tt_k.int(), tt_p) and tf_err <= 1e-4,
          f"{tag}: rank {rank}: teacher-forced shard tick h err {tf_err:.3g}")
    greedy = init_state(params, n_slots, 64)
    greedy.prompt, greedy.plen, greedy.total = st.prompt, st.plen, st.total
    port.reset_kernel_launches()
    times = md_in_turn(rank, world, lambda: (
        cuda_ms(lambda: fused.fused_slot_tick_shard(params, greedy, inner, shard,
                                                    compute_dtype=bf16), n=10),
        cuda_ms(lambda: fused.gru_loop_reference(
            wf, greedy.prompt[sl], greedy.plen[sl], greedy.total[sl], greedy.prev[sl],
            greedy.pos[sl], greedy.h[sl], inner, bf16), n=1, warmup=1)))
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    b = hi - lo
    v, e, u = wf.v, wf.e, wf.u
    ops = 2 * v * e * 3 * u + 2 * b * inner * (3 * u * u + u * v)
    nbytes = weight_bytes + b * 64 * 4 + b * (4 * 4 + 4 * u) + b * (4 * 2 + 4 * u) + b * inner
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    out["tick"] = dict(lo=lo, hi=hi, slot_base=shard.slot_base, key_tile=shard.key_tile,
                       agree=agree, forked=forked, rekeyed=rekeyed, max_abs_err=tf_err,
                       ms=times[0], plain_ms=times[1], bound_ms=b_ms, bound_by=b_by)
    log(f"[{tag}] rank {rank}: shard slots [{lo}, {hi}) keyed at slot_base "
        f"{shard.slot_base}, key_tile {shard.key_tile}: sampled bf16 tick against its plain "
        f"version {agree:.6f} token agreement ({forked} rows fork, at near-ties), "
        f"{100 * rekeyed:.1f}% of sampled rows draw another stream than an unkeyed launch | "
        f"teacher-forced f32 h max abs err {tf_err:.3g} | greedy bf16 shard tick "
        f"{times[0]:.3f} ms alone on the card, plain {times[1]:.1f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    del greedy, tf_st, st
    multihost.sync_hosts()

    # ---- (b) the tensor-parallel scan tick ------------------------------------------
    tp = make_mesh((1, world))
    placed = place(params, gru_param_specs(params), tp)
    rk = placed.cell.recurrent_kernel
    check(isinstance(rk, sharding.Placed) and rk.dim == 1 and rk.local.shape == (1024, 1536)
          and isinstance(placed.dense_kernel, sharding.Placed) and placed.dense_kernel.dim == 0,
          f"{tag}: the TP placement is not column-parallel gates + a row-parallel head")
    tp_slots, tp_inner = MD_TP_SHAPE
    eng_tp = DecodeEngine(placed, n_slots=tp_slots, max_prompt=64, inner_steps=tp_inner,
                          compute_dtype=bf16)
    check(not eng_tp.use_fused_tick, f"{tag}: tensor-parallel params took the fused tick")
    port.reset_kernel_launches()
    toks_tp, secs_tp = md_serve(eng_tp, md_load_requests(os.path.join(work, "tp.npz")))
    out["tp"] = dict(launches=port.kernel_launches()["qmatmul_q8_0"], seconds=secs_tp,
                     digest=eng_tp.state_digest(), steps=eng_tp.stats.device_steps,
                     tokens_per_s=eng_tp.stats.tokens_per_s)
    check(out["tp"]["launches"] > 0, f"{tag}: the TP scan tick launched no qmatmul kernel")
    if primary:
        md_save_tokens(os.path.join(work, "tp_tokens.npz"), toks_tp)
    readings = md_in_turn(rank, world, lambda: qmatmul_phase(
        f"{tag} rank {rank} column shard", rk.local, dev) if rank == 0 else None)
    if readings is not None:
        out["qmatmul"] = {f"{m}:{c}": r for (m, c), r in readings.items()}
    del eng_tp, placed
    torch.cuda.empty_cache()

    # ---- (c) the data-parallel MobileViT forward ------------------------------------
    vit = load_mobilevit(VIT_CKPT, device=dev)
    with np.load(os.path.join(work, "images.npz")) as f:
        images = torch.from_numpy(f["images"])
    feats = {}
    images = images.to(dev)
    for cd in (bf16, f32):
        port.reset_kernel_launches()
        feats[cdname(cd)] = extract_features_data_parallel(vit, images, compute_dtype=cd)
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        secs = []
        for _ in range(3):       # timed once warm: the first call sets up routes and caches
            multihost.sync_hosts()
            t0 = time.perf_counter()
            extract_features_data_parallel(vit, images, compute_dtype=cd)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        secs = statistics.median(secs)
        names = (("fused_transformer_layer", "fused_inverted_residual") if cd == bf16
                 else tuple(f32_attention_launches(1)))
        check(all(launches[n] > 0 for n in names), f"{tag}: rank {rank} {cdname(cd)} forward "
                                                   f"launched {launches}")
        out[f"vision_{cdname(cd)}"] = dict(seconds=secs, launches={n: launches[n] for n in names})
    if primary:
        np.savez(os.path.join(work, "features.npz"),
                 **{k: t.cpu().numpy() for k, t in feats.items()})
    out["vision_digest"] = float(feats["bfloat16"].double().abs().sum())
    return out


def md_die_rank(tag, work, rank, world, dev):
    """Phase 21 (d): two ranks snapshot mid-decode; rank 1 dies with no
    shutdown; rank 0's next tick must fail or stall, never complete."""
    import threading

    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, multihost, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    params = place(params, gru_param_specs(params), make_mesh((world, 1)))
    eng = DecodeEngine(params, n_slots=MD_DIE_SLOTS, max_prompt=64,
                       inner_steps=MD_ENGINE_SHAPE[1], compute_dtype=torch.bfloat16,
                       use_fused_tick=True)
    if multihost.is_primary():
        for p, n, t in md_load_requests(os.path.join(work, "die.npz")):
            eng.submit(p, n)
    eng._tick()
    eng._tick()
    snap = os.path.join(work, "engine.gxt")
    if multihost.is_primary():
        eng.snapshot(snap)
    out = {"rank": rank, "snapshot_written": os.path.exists(snap),
           "slot_axis": eng._fused_slot_axis}
    multihost.sync_hosts()
    if rank == 1:
        os._exit(17)            # no shutdown, no barrier
    status = {"done": False, "error": None}

    def tick():
        try:
            eng._tick()
        except Exception as ex:  # noqa: BLE001 - the peer's death, whatever its form
            status["error"] = f"{type(ex).__name__}: {ex}"[:160]
        status["done"] = True

    t0 = time.perf_counter()
    th = threading.Thread(target=tick, daemon=True)
    th.start()
    th.join(timeout=MD_DEATH_WAIT_S)
    out["peer_death"] = ("error" if status["error"] else
                         "wedged" if not status["done"] else "tick_succeeded")
    out["detail"] = status["error"]
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"die_{rank}.json"), "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    os._exit(0)                 # the group is unusable now


def md_nccl_rank(tag, work, rank, world, dev):
    """Phase 21 (e): a one-rank NCCL session serving through the engine's
    process-group path (refill broadcast, slot-sharded tick, gather)."""
    import torch
    import torch.distributed as dist

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    params = place(params, gru_param_specs(params), make_mesh((1, 1)))
    n_slots, inner = MD_ENGINE_SHAPE
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=torch.bfloat16, use_fused_tick=True)
    check(eng._fused_slot_axis == "data", f"{tag}: the NCCL session's tick is not sharded")
    port.reset_kernel_launches()
    toks, secs = md_serve(eng, md_load_requests(os.path.join(work, "nccl.npz")))
    md_save_tokens(os.path.join(work, "nccl_tokens.npz"), toks)
    return {"rank": rank, "backend": str(dist.get_backend()), "seconds": secs,
            "steps": eng.stats.device_steps,
            "launches": port.kernel_launches()["fused_slot_tick"]}


def rank_main(argv) -> int:
    """``chip_smoke.py --rank SCENARIO PORT RANK WORLD DIR BACKEND``: one rank
    of a phase-21 session, spawned by the phase. Writes DIR/SCENARIO_RANK.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    scenario, port_, rank, world, work, backend = argv
    rank, world = int(rank), int(world)
    os.environ["GXT_TORCH_DECODE_DISPATCH"] = os.path.join(work, "none.json")
    from ggml_experiments_tpu_torch.parallel import multihost

    dev = multihost.initialize(backend, f"tcp://localhost:{port_}", world, rank,
                               device="cuda:0", timeout_s=MD_TIMEOUT_S[scenario])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = {"serve": md_serve_rank, "die": md_die_rank, "nccl": md_nccl_rank,
           "train": mt_train_rank, "train_nccl": mt_nccl_rank}[scenario]
    phase = "22 mesh training" if scenario.startswith("train") else "21 multi-device"
    out = run(f"{phase} {scenario}", work, rank, world, dev)
    with open(os.path.join(work, f"{scenario}_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.sync_hosts()
    multihost.shutdown()
    return 0


def md_spawn(tag, scenario, world, work, backend):
    """Run ``world`` ranks of ``scenario`` (this script with ``--rank``) and
    print their output. Returns their exit codes."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_ = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(MD_RANK_ARGV + ["--rank", scenario, str(port_), str(r),
                                               str(world), work, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MD_SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("["):
                log(line)
        if p.returncode not in (0, 17):
            log(f"[{tag}] rank {r} of {scenario} exited {p.returncode}:\n{text[-6000:]}")
    log(f"[{tag}] {scenario}: {world} rank(s) over {backend} on cuda:0, ran "
        f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    return [p.returncode for p in procs]


def md_result(work, scenario, rank):
    with open(os.path.join(work, f"{scenario}_{rank}.json")) as f:
        return json.load(f)


def multidevice_phase(tag, dev, rng, tok, images, smi):
    """Phase 21: multi-device serving on one card. Two ranks share cuda:0
    over gloo (NCCL refuses two ranks on one device): (a) the slot-sharded
    fused tick engine, (b) the tensor-parallel scan tick, (c) the
    data-parallel MobileViT forward, (d) host death and the snapshot's
    restore in this process; then (e) a one-rank NCCL session. Returns the
    kernels-line entries of the sharded tick and the column-shard qmatmul."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.ops.linear import linear
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    f32, bf16 = torch.float32, torch.bfloat16
    n_slots, inner = MD_ENGINE_SHAPE
    half = n_slots // 2
    # the first wave fills every slot: greedy requests, then the same sampled
    # prompts at the last MD_SAMPLED_PAIRS columns of each shard; a backlog
    # of greedy requests waits for the refills
    greedy = md_request_set(rng, tok, n_slots - 2 * MD_SAMPLED_PAIRS + MD_BACKLOG, 1, 64, 16,
                            256)
    sampled = md_request_set(rng, tok, MD_SAMPLED_PAIRS, 4, 64, 64, 200, temp=0.8)
    g0 = half - MD_SAMPLED_PAIRS
    serve = greedy[:g0] + sampled + greedy[g0:2 * g0] + sampled + greedy[2 * g0:]
    tp_reqs = md_request_set(rng, tok, MD_TP_REQUESTS, 1, 64, 16, 128)
    die = md_request_set(rng, tok, MD_DIE_REQUESTS, 1, 64, 16, 256)
    nccl = md_request_set(rng, tok, MD_NCCL_REQUESTS, 1, 64, 16, 128)
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    for name, reqs in (("serve", serve), ("tp", tp_reqs), ("die", die), ("nccl", nccl)):
        md_save_requests(os.path.join(work, f"{name}.npz"), reqs)
    np.savez(os.path.join(work, "images.npz"), images=images[:MD_VIT_IMAGES])

    # the single-process references, on this process's card
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)

    def offline(reqs):
        ids, lens = pad_batch([p for p, _, _ in reqs], 64)
        return fused.fused_gru_decode(params, ids, lens, 64 + max(n for _, n, _ in reqs),
                                      compute_dtype=bf16).cpu().numpy()

    one = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                       top_k=20, top_p=0.9)
    t0 = time.perf_counter()
    one_handles = [one.submit(p, n, temperature=t) for p, n, t in serve]
    one.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ---- (a), (b), (c): two ranks sharing the card -----------------------------------
    rcs = md_spawn(tag, "serve", 2, work, MD_BACKEND)
    check(rcs == [0, 0], f"{tag}: the two-rank session failed: exit codes {rcs}")
    r0, r1 = md_result(work, "serve", 0), md_result(work, "serve", 1)
    got = md_load_tokens(os.path.join(work, "serve_tokens.npz"))
    check(len(got) == len(serve), f"{tag}: {len(got)} of {len(serve)} requests came back")
    want = offline(serve)
    n_greedy = 0
    for i, ((p, n, t), g) in enumerate(zip(serve, got)):
        check(g.size == p.size + n and np.array_equal(g[:p.size], p) and g.max() < 66,
              f"{tag}: request {i}: {g.size} tokens")
        if t == 0.0:
            n_greedy += 1
            check(np.array_equal(g, want[i, :p.size + n]) and np.array_equal(
                g, one_handles[i].result(timeout=0)),
                f"{tag}: greedy request {i} differs from the offline decode / one process")
    pairs = [(g0 + k, half + g0 + k) for k in range(MD_SAMPLED_PAIRS)]
    distinct = sum(not np.array_equal(got[a], got[b]) for a, b in pairs)
    check(distinct == len(pairs), f"{tag}: {len(pairs) - distinct} identical sampled prompts "
                                  f"in the two shards drew one stream")
    for key in ("digest", "steps"):
        check(r0["serve"][key] == r1["serve"][key], f"{tag}: the ranks' {key} differ: "
                                                    f"{r0['serve'][key]} {r1['serve'][key]}")
    check(r1["serve"]["held"] == 0, f"{tag}: the follower holds requests")
    check(r0["serve"]["launches"] > 0 and r1["serve"]["launches"] > 0,
          f"{tag}: a rank launched no tick: {r0['serve']['launches']}, "
          f"{r1['serve']['launches']}")
    check(r1["tick"]["slot_base"] == half, f"{tag}: rank 1 keyed at {r1['tick']['slot_base']}")
    log(f"[{tag}] (a) {len(serve)} requests ({n_greedy} greedy, each equal to the offline "
        f"decode and to one process's engine; {2 * MD_SAMPLED_PAIRS} sampled, the "
        f"{len(pairs)} prompts repeated in the two shards at the same column all drew distinct "
        f"streams) on a {n_slots} x {inner} engine, each rank ticking {half} slots: "
        f"{r0['serve']['steps']} ticks, state digests equal ({r0['serve']['digest']}), tick "
        f"launches {r0['serve']['launches']} + {r1['serve']['launches']}, plan "
        f"{r0['serve']['plan']}")
    log(f"[{tag}] (a) {smi}: both ranks share one card (gloo on loopback), so these "
        f"figures are overhead, not scaling | shard tick alone on the card: rank 0 "
        f"{r0['tick']['ms']:.3f} ms, rank 1 {r1['tick']['ms']:.3f} ms | the gather of the ticked "
        f"slots, tick by tick (ms), in a second run of the same requests with a sync and a "
        f"barrier a tick: rank 0 {r0['serve']['gather_ms']}, rank 1 "
        f"{r1['serve']['gather_ms']}, after waiting {r0['serve']['wait_ms']} / "
        f"{r1['serve']['wait_ms']} for the peer; warm, alone (median of 10): "
        f"{r0['serve']['gather_cuda_ms']:.3f} ms from the card, "
        f"{r0['serve']['gather_host_ms']:.3f} ms of host tensors | two ranks, uninstrumented, "
        f"{r0['serve']['tokens_per_s']:,.0f} tokens/s ({r0['serve']['seconds']:.3f} s) against "
        f"one process {one.stats.tokens_per_s:,.0f} tokens/s ({one_s:.3f} s), the same engine "
        f"and requests")

    # (b) the tensor-parallel scan tick against the single-process plain loop
    got_tp = md_load_tokens(os.path.join(work, "tp_tokens.npz"))
    ids, lens = pad_batch([p for p, _, _ in tp_reqs], 64)
    steps = 64 + max(n for _, n, _ in tp_reqs)
    ref = gru_textgen.generate(params, ids, lens, steps, compute_dtype=bf16)
    z = torch.zeros(len(tp_reqs), dtype=torch.int32, device=dev)
    tt = torch.full((len(tp_reqs),), steps, dtype=torch.int32, device=dev)
    *_, gaps = fused.gru_loop_reference(
        fused._prep_weights(params), torch.nn.functional.pad(torch.from_numpy(ids).to(dev),
                                                             (0, steps - 64)),
        torch.from_numpy(lens).to(dev), tt, z, z, torch.zeros(len(tp_reqs), 1024, device=dev),
        steps, bf16, margins=True)
    got_pad = np.zeros((len(tp_reqs), steps), np.int64)
    want_pad = ref.cpu().numpy().astype(np.int64)
    for i, ((p, n, _), g) in enumerate(zip(tp_reqs, got_tp)):
        check(g.size == p.size + n, f"{tag}: TP request {i}: {g.size} tokens")
        got_pad[i, :g.size] = g
        got_pad[i, g.size:] = want_pad[i, g.size:]
    agree, forked = first_divergence_near_ties(torch.from_numpy(got_pad),
                                               torch.from_numpy(want_pad), gaps.cpu(),
                                               NEAR_TIE["bfloat16"],
                                               f"{tag}: TP scan tick vs generate")
    check(r0["tp"]["digest"] == r1["tp"]["digest"], f"{tag}: TP state digests differ")
    log(f"[{tag}] (b) {len(tp_reqs)} greedy requests on the TP scan tick ((1, 2) mesh: gate "
        f"kernels column-parallel, 1024 x 1536 a rank through the qmatmul kernel; head "
        f"row-parallel): token agreement with one process's generate {agree:.6f} ({forked} rows "
        f"fork, at near-ties) | qmatmul launches {r0['tp']['launches']} + "
        f"{r1['tp']['launches']} | {r0['tp']['tokens_per_s']:,.0f} tokens/s "
        f"({r0['tp']['steps']} ticks), state digests equal")

    # (c) the data-parallel MobileViT forward against one process's
    vit = load_mobilevit(VIT_CKPT, device=dev)
    x = torch.from_numpy(images[:MD_VIT_IMAGES]).to(dev)
    with np.load(os.path.join(work, "features.npz")) as f:
        dp = {k: torch.from_numpy(f[k]).to(dev) for k in ("bfloat16", "float32")}
    for cd in (bf16, f32):
        want_f = extract_features(vit, x, compute_dtype=cd)
        err = float((dp[cdname(cd)] - want_f).abs().max())
        lim = (VIT_ENGINE_FEATURE_MAX if cd == bf16 else VIT_CPU_FEATURE_REL) * float(
            want_f.abs().max())
        check(err <= lim, f"{tag}: DP {cdname(cd)} features differ by {err:.3g} (limit "
                          f"{lim:.3g})")

        def logits(feats):
            return linear(feats.mean(dim=(1, 2)), vit.classifier_kernel, vit.classifier_bias,
                          compute_dtype=f32).float()

        agree_v, flips = argmax_near_ties(f"{tag}: DP {cdname(cd)} argmax",
                                          logits(dp[cdname(cd)]), logits(want_f), VIT_NEAR_TIE)
        rv = r0[f"vision_{cdname(cd)}"]
        log(f"[{tag}] (c) DP MobileViT {cdname(cd)}, {MD_VIT_IMAGES} images, "
            f"{MD_VIT_IMAGES // 2} a rank: features max abs err {err:.3g} against one process "
            f"(limit {lim:.3g}), argmax agreement {agree_v:.4f} ({flips} flips, at near-ties) | "
            f"rank 0 launches {rv['launches']} | {1e3 * rv['seconds']:.3f} ms a warm DP "
            f"forward (median of 3, gather included)")
    del vit, dp
    torch.cuda.empty_cache()

    # ---- (d) host death, then the restore in this process ----------------------------
    want_die = offline(die)
    uninterrupted = DecodeEngine(params, n_slots=MD_DIE_SLOTS, max_prompt=64,
                                 inner_steps=inner, compute_dtype=bf16, use_fused_tick=True)
    u_handles = [uninterrupted.submit(p, n) for p, n, _ in die]
    uninterrupted.run_until_idle(timeout_s=600)
    rcs = md_spawn(tag, "die", 2, work, MD_BACKEND)
    check(rcs == [0, 17], f"{tag}: host death: exit codes {rcs} (want 0 and 17)")
    with open(os.path.join(work, "die_0.json")) as f:
        d0 = json.load(f)
    check(d0["snapshot_written"] and d0["slot_axis"] == "data"
          and d0["peer_death"] in ("error", "wedged"), f"{tag}: host death: {d0}")
    eng2 = DecodeEngine.restore(os.path.join(work, "engine.gxt"), params, inner_steps=inner,
                                compute_dtype=bf16, use_fused_tick=True)
    partial = sum(1 for r in eng2.restored_requests
                  if 0 < len(r._tokens) < r.prompt_ids.size + r.max_new_tokens)
    queued = sum(1 for r in eng2.restored_requests if not r._tokens)
    check(partial > 0 and queued > 0,
          f"{tag}: the snapshot holds {len(eng2.restored_requests)} requests, {partial} "
        f"mid-way, {queued} queued")
    eng2.run_until_idle(timeout_s=600)
    restored = {request_key(r.prompt_ids, r.max_new_tokens): r.result(timeout=0)
                for r in eng2.restored_requests}
    done_before = len(die) - len(restored)
    for i, ((p, n, _), h) in enumerate(zip(die, u_handles)):
        k = request_key(p, n)
        if k in restored:
            check(np.array_equal(restored[k], h.result(timeout=0)) and np.array_equal(
                restored[k], want_die[i, :p.size + n]),
                f"{tag}: restored request {i} differs from the uninterrupted run")
    log(f"[{tag}] (d) host death: snapshot after 2 ticks of a {MD_DIE_SLOTS}-slot two-rank "
        f"engine, rank 1 exits 17, rank 0's next tick: {d0['peer_death']} after "
        f"{d0['seconds']:.1f} s ({d0['detail']}) | restored in one process: "
        f"{len(restored)} requests ({partial} mid-way, {queued} queued; {done_before} done "
        f"before) finish equal to the uninterrupted engine and the offline decode")

    # ---- (e) one rank over NCCL --------------------------------------------------------
    rcs = md_spawn(tag, "nccl", 1, work, "nccl")
    check(rcs == [0], f"{tag}: the one-rank NCCL session failed: exit code {rcs}")
    n0 = md_result(work, "nccl", 0)
    got_n = md_load_tokens(os.path.join(work, "nccl_tokens.npz"))
    want_n = offline(nccl)
    for i, ((p, n, _), g) in enumerate(zip(nccl, got_n)):
        check(np.array_equal(g, want_n[i, :p.size + n]), f"{tag}: NCCL request {i} differs")
    check("nccl" in n0["backend"] and n0["launches"] > 0, f"{tag}: NCCL session: {n0}")
    log(f"[{tag}] (e) one rank, backend {n0['backend']}: {len(nccl)} requests through the "
        f"refill broadcast and the slot gather on NCCL, {n0['steps']} ticks, {n0['launches']} "
        f"tick launches, every request equal to the offline decode")
    tmp.cleanup()

    ticks = [r0["tick"], r1["tick"]]
    tick_entry = dict(launches=r0["serve"]["launches"] + r1["serve"]["launches"],
                      max_abs_err=max(t["max_abs_err"] for t in ticks), ms=ticks[0]["ms"],
                      plain_ms=ticks[0]["plain_ms"], bound_ms=ticks[0]["bound_ms"],
                      bound_by=ticks[0]["bound_by"], library_ms=None,
                      plan=r0["serve"]["plan"])
    readings = {(int(k.split(":")[0]), k.split(":")[1]): v for k, v in r0["qmatmul"].items()}
    qmm_entry = qmatmul_entry(readings, r0["tp"]["launches"] + r1["tp"]["launches"])
    return tick_entry, qmm_entry


# ---------------------------------------------------------------------------
# phase 22: training on a mesh (the parent spawns this script as ranks)
# ---------------------------------------------------------------------------

def mt_data(tok, dev):
    """Phase 12's initial params (seed 0) and its first global batches."""
    import itertools

    import torch

    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
    from ggml_experiments_tpu_torch.training.data import (
        DataConfig,
        batches,
        load_corpus,
        make_examples,
    )

    B, T = TRAIN_SHAPES[0]
    data = DataConfig(seq_length=T, batch_size=B)
    stream = list(itertools.islice(batches(make_examples(load_corpus(CORPUS_TRAIN), tok, data),
                                           data, seed=0, epochs=1), MT_STEPS["dp"]))
    init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
    return init, stream


def mt_config(**kw):
    import torch

    from ggml_experiments_tpu_torch.training import TrainConfig

    kw.setdefault("compute_dtype", torch.bfloat16)
    return TrainConfig(epochs=1, log_every=1, learning_rate=MT_LR, **kw)


def mt_leaves(params):
    """The whole params' tensors, on the host."""
    from ggml_experiments_tpu_torch.training.gru_trainer import gather_params, param_leaves

    return [t.detach().cpu() for _, t in param_leaves(gather_params(params))]


def mt_train(init, stream, mesh, dev, **kw):
    """``train(..., mesh=)`` with the launches counted from zero: (placed
    params, whole leaves, losses, launches of the train kernels)."""
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.training import train

    port.reset_kernel_launches()
    for k in ft.PLAIN_CALLS:
        ft.PLAIN_CALLS[k] = 0
    params, hist = train(init, stream, mt_config(**kw), mesh=mesh, device=dev)
    torch.cuda.synchronize()
    launches = {k: port.kernel_launches()[k] for k in TRAIN_KERNELS + TRAIN_F32_KERNELS}
    check(not any(ft.PLAIN_CALLS.values()), f"plain versions ran: {ft.PLAIN_CALLS}")
    return params, mt_leaves(params), [h["loss"] for h in hist], launches


def mt_checksum(leaves):
    return float(sum(float(t.double().abs().sum()) for t in leaves))


def mt_timings(init, stream, mesh, dev, gather_wr):
    """A rank's step time over MT_TIMED_STEPS steps (synchronized only at the
    ends of the window), then, instrumented apart: the gradient all-reduce
    (the step's flat buffer of every leaf's gradient and the loss) and, with
    ``gather_wr``, the recurrent kernel's gather; medians of 5, each after a
    barrier."""
    import torch

    from ggml_experiments_tpu_torch.parallel import DATA_AXIS, axis_slice, multihost
    from ggml_experiments_tpu_torch.training.gru_trainer import (
        init_train_state,
        make_train_step,
        param_leaves,
    )

    params, opt = init_train_state(init, mesh, device=dev)
    step = make_train_step(MT_LR, mesh, compute_dtype=torch.bfloat16)
    sl = axis_slice(mesh, DATA_AXIS, stream[0][0].shape[0])
    feed = [tuple(torch.from_numpy(a[sl].copy()).to(dev) for a in b) for b in stream]
    step(params, opt, *feed[0])
    torch.cuda.synchronize()
    multihost.sync_hosts()
    t0 = time.perf_counter()
    for i in range(MT_TIMED_STEPS):
        _, _, loss = step(params, opt, *feed[i % len(feed)])
    float(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MT_TIMED_STEPS

    def timed(fn):
        times = []
        for _ in range(5):
            multihost.sync_hosts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    n = sum(t.numel() for _, t in param_leaves(params)) + 1
    flat = torch.ones(n, device=dev)
    out = {"step_ms": step_ms, "allreduce_ms": timed(lambda: mesh.all_reduce(flat, DATA_AXIS)),
           "allreduce_mb": n * 4 / 1e6}
    if gather_wr:
        out["gather_wr_ms"] = timed(lambda: params.cell.recurrent_kernel.gather())
    return out


def mt_pair_check(tag, dev, init, ids):
    """The fused pair (forward, backward recurrence, dWr) on a rank's first
    DP step's operands: ``ids`` its (B, T) rows of the first global batch,
    their input projection by ``init``'s cell at bf16, h0 zero, a seeded
    cotangent. Each kernel held against its plain version with phase 11's
    limits (the forward, the backward twice, the dWr GEMM alone on equal
    operands), then the pair CUDA-event timed beside its bound (phase 11's
    formula: each kernel's bytes and 2 T B U 3U operations)."""
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.ops.gru import input_projection

    bf16 = torch.bfloat16
    cell = init.cell
    b, T = ids.shape
    u = cell.units
    with torch.no_grad():
        xs = init.embeddings[torch.from_numpy(ids.T.copy()).long().to(dev)]   # (T, B, E)
        mxs = input_projection(cell, xs, compute_dtype=bf16).contiguous()
    h0 = torch.zeros((b, u), dtype=bf16, device=dev)
    wr = cell.recurrent_kernel.detach().to(bf16).contiguous()
    brec = cell.bias[1].detach().float().contiguous()
    g = torch.Generator(device=dev).manual_seed(22)
    dys = (torch.randn((T, b, u), generator=g, device=dev) * 0.01).to(bf16)
    what = f"rank pair B={b} T={T}"

    ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
    torch.cuda.synchronize()
    plan = ft.train_plan(b, u)
    check(ft.LAST_PLAN["fused_gru_train_fwd"] == plan, f"{tag}: {what}: forward ran "
                                                       f"{ft.LAST_PLAN} for {plan}")
    pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    ys_max = train_fwd_check(tag, f"{what}: forward", ys, mhs, pys, pmhs,
                             train_bf16_gaps(mxs, h0, wr, brec, pys))[0]
    got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
    again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
    want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
    rel = train_bwd_check(tag, f"{what}: backward", got, again, want)
    dmx_abs = float((got[0].float() - want[0].float()).abs().max())
    del again, want
    dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr)
    dwr_k = ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)
    dwr_p = ft.gru_train_dwr_plain(h0, pys, dmxs, plane)
    dwr_abs = float((dwr_k - dwr_p).abs().max())
    dwr_rel = dwr_abs / float(dwr_p.abs().max())
    check(dwr_rel <= TRAIN_DWR_REL, f"{tag}: {what}: dWr max |diff| / max |plain| = "
                                    f"{dwr_rel:.3g} > {TRAIN_DWR_REL}")
    del pys, pmhs, dmxs, plane, dwr_k, dwr_p

    def pair():
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        return ys, mhs, ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)

    ms = cuda_ms(pair, n=5, warmup=1)
    ops = 2 * T * b * u * 3 * u
    dmxs, dwr, dbrec, dh0 = got
    plane = ys     # the recurrence's (T, B, U) bf16 plane, as large as ys
    parts = (bound(tensor_bytes(mxs, h0, wr, brec, ys, mhs), ops, "bfloat16"),
             bound(tensor_bytes(mxs, mhs, ys, dys, h0, wr, dmxs, plane, dbrec, dh0), ops,
                   "bfloat16"),
             bound(tensor_bytes(h0, ys, dmxs, plane, dwr), ops, "bfloat16"))
    return {"pair_ms": ms, "pair_bound_ms": sum(p[0] for p in parts),
            "plan": list(plan),
            "pair_err": {"ys_max_abs": ys_max, "dmxs_max_abs": dmx_abs, "dwr_max_abs": dwr_abs,
                         "dwr_rel": dwr_rel, **{f"{k}_rel": v for k, v in rel.items()}}}


def mt_train_rank(tag, work, rank, world, dev):
    """A rank of phase 22's two-rank session: (a) DP, (b) TP, (c) resume,
    (d) TP MobileViT; see the module docstring."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.parallel import (
        DATA_AXIS,
        axis_slice,
        make_mesh,
        mobilevit_param_specs,
        place,
    )
    from ggml_experiments_tpu_torch.parallel.sharding import Placed
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    f32, bf16 = torch.float32, torch.bfloat16
    init, stream = mt_data(CharTokenizer(), dev)
    dp, tp = make_mesh((2, 1)), make_mesh((1, 2))
    out = {"rank": rank}
    # (a) data parallel
    _, dp_leaves, losses, launches = mt_train(init, stream, dp, dev)
    out["dp"] = {"losses": losses, "launches": launches, "checksum": mt_checksum(dp_leaves)}
    # (a) again at f32, train-gru's default: the f32 pair on each rank's rows
    _, f32_leaves, losses, launches = mt_train(init, stream[:MT_F32_STEPS], dp, dev,
                                               compute_dtype=f32)
    out["dp_f32"] = {"losses": losses, "launches": launches,
                     "checksum": mt_checksum(f32_leaves)}
    # (b) tensor parallel: the params' column shards, the kernels on the gathered wr
    params, tp_leaves, losses, launches = mt_train(init, stream[:MT_STEPS["tp"]], tp, dev)
    wr = params.cell.recurrent_kernel
    check(isinstance(wr, Placed) and tuple(wr.local.shape) == (1024, 1536),
          f"{tag}: the TP recurrent kernel is not a column shard")
    out["tp"] = {"losses": losses, "launches": launches, "checksum": mt_checksum(tp_leaves)}
    if rank == 0:
        torch.save({"dp": dp_leaves, "tp": tp_leaves, "dp_f32": f32_leaves},
                   os.path.join(work, "mt_params.pt"))
    del params, wr, f32_leaves
    # (c) interrupted after MT_RESUME_AFTER steps, resumed from the file
    ck = os.path.join(work, "mt_resume.gxt")
    mt_train(init, stream[:MT_RESUME_AFTER], dp, dev, resume_path=ck, save_every=1)
    _, resumed, losses, launches = mt_train(init, stream, dp, dev, resume_path=ck, save_every=1)
    out["resume"] = {"equal": all(torch.equal(a, b) for a, b in zip(resumed, dp_leaves)),
                     "steps": len(losses), "launches": launches,
                     "bytes": os.path.getsize(ck)}
    # timings: each rank's steps, the collectives apart, the pair alone on the card
    out["dp"].update(mt_timings(init, stream, dp, dev, False))
    out["tp"].update(mt_timings(init, stream, tp, dev, True))
    pair_rows = stream[0][0][axis_slice(dp, DATA_AXIS, stream[0][0].shape[0])]
    out.update(md_in_turn(rank, world, lambda: mt_pair_check(tag, dev, init, pair_rows)))
    torch.cuda.empty_cache()
    # (d) tensor-parallel MobileViT
    with np.load(os.path.join(work, "mt_images.npz")) as f:
        x = torch.from_numpy(f["images"]).to(dev)
    vit = load_mobilevit(VIT_CKPT, device=dev)
    pv = place(vit, mobilevit_param_specs(vit), tp)
    check(isinstance(pv.layer_3.transformer[0].attention.wq, Placed)
          and isinstance(pv.classifier_kernel, Placed), f"{tag}: MobileViT is not placed")
    port.reset_kernel_launches()
    feats = {"float32": extract_features(pv, x, compute_dtype=f32),
             "bfloat16": classify(pv, x, compute_dtype=bf16)}
    torch.cuda.synchronize()
    vit_launches = port.kernel_launches()
    q8 = load_mobilevit(VIT_CKPT, device=dev, qtype="q8_0")
    pq = place(q8, mobilevit_param_specs(q8), tp)
    feats["q8_0"] = extract_features(pq, x, compute_dtype=f32)
    check(not any(hasattr(layer, attr) for blk in (pv.layer_3, pv.layer_4, pv.layer_5)
                  for layer in blk.transformer
                  for attr in ("_gxt_fused_operands", "_gxt_fused_operands_f32")),
          f"{tag}: placed layers kept their operands")
    out["vit"] = {k: float(v.double().abs().sum()) for k, v in feats.items()}
    out["vit"]["launches"] = {k: vit_launches[k] for k in (
        *f32_attention_launches(1), "fused_transformer_layer", "fused_inverted_residual")}
    if rank == 0:
        np.savez(os.path.join(work, "mt_vit.npz"), **{k: v.cpu().numpy() for k, v in
                                                       feats.items()})
    return out


def mt_nccl_rank(tag, work, rank, world, dev):
    """Phase 22 (e): one NCCL rank runs (a)'s steps on a (1, 1) mesh."""
    import torch
    import torch.distributed as dist

    from ggml_experiments_tpu_torch.parallel import make_mesh
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    init, stream = mt_data(CharTokenizer(), dev)
    mesh = make_mesh((1, 1))
    check(mesh.group("data") is not None, f"{tag}: the (1, 1) mesh has no group")
    _, leaves, losses, launches = mt_train(init, stream, mesh, dev)
    torch.save(leaves, os.path.join(work, "mt_nccl_params.pt"))
    return {"rank": rank, "backend": str(dist.get_backend()), "losses": losses,
            "launches": launches}


def train_mesh_phase(tag, dev, images, smi):
    """Phase 22: training on a mesh on one card (see the module docstring).
    Returns the launches of each train kernel by run and rank."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.training import train
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    np.savez(os.path.join(work, "mt_images.npz"), images=images[:MT_VIT_IMAGES])
    init, stream = mt_data(CharTokenizer(), dev)
    one = {}
    for run, n, cd in (("dp", MT_STEPS["dp"], bf16), ("tp", MT_STEPS["tp"], bf16),
                       ("dp_f32", MT_F32_STEPS, f32)):
        params, hist = train(init, stream[:n], mt_config(compute_dtype=cd), device=dev)
        one[run] = ([h["loss"] for h in hist], mt_leaves(params))
        del params
    torch.cuda.empty_cache()

    rcs = md_spawn(tag, "train", 2, work, MD_BACKEND)
    check(rcs == [0, 0], f"{tag}: the two-rank session failed: exit codes {rcs}")
    r0, r1 = md_result(work, "train", 0), md_result(work, "train", 1)
    saved = torch.load(os.path.join(work, "mt_params.pt"))
    n_local = TRAIN_SHAPES[0][0] // 2
    for run, mesh in (("dp", (2, 1)), ("dp_f32", (2, 1)), ("tp", (1, 2))):
        a, b = r0[run], r1[run]
        f32_run = run == "dp_f32"
        steps = MT_F32_STEPS if f32_run else MT_STEPS[run]
        names = TRAIN_F32_KERNELS if f32_run else TRAIN_KERNELS
        # every reading first, logged, then the checks: a failing run shows them all
        want_losses, want_leaves = one[run]
        rel = max(abs(x - w) / abs(w) for x, w in zip(a["losses"], want_losses))
        diffs = [(g - w).abs() for g, w in zip(saved[run], want_leaves)]
        d_max = max(float(d.max()) for d in diffs)
        d_mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
        bit_equal = all(torch.equal(g, w) for g, w in zip(saved[run], want_leaves))
        rows = 2 * n_local if run == "tp" else n_local
        label = {"dp": "(a) DP", "dp_f32": "(a) DP at f32", "tp": "(b) TP"}[run]
        log(f"[{tag}] {label} {mesh} mesh, {'f32' if f32_run else 'bf16'}, global "
            f"B={2 * n_local} T={TRAIN_SHAPES[0][1]}, {steps} steps: launches a rank fwd/bwd/dWr "
            f"{[a['launches'][k] for k in names]} + "
            f"{[b['launches'][k] for k in names]} on {rows} rows each | losses rank 0 "
            f"{a['losses']}, rank 1 {b['losses']}, params checksums {a['checksum']!r} "
            f"{b['checksum']!r} | against one process (rank 0's): loss relative {rel:.3g} "
            f"(limit {MT_LOSS_REL}), params max |diff| {d_max:.3g} (limit {MT_PARAM_MAX}), "
            f"mean {d_mean:.3g} (limit {MT_PARAM_MEAN}), bit-equal {bit_equal}")
        for r, x in ((0, a), (1, b)):
            check(all(x["launches"][k] == steps for k in names)
                  and not any(x["launches"][k] for k in TRAIN_KERNELS + TRAIN_F32_KERNELS
                              if k not in names),
                  f"{tag}: {run} rank {r} launched {x['launches']} in {steps} steps")
        check(a["losses"] == b["losses"] and a["checksum"] == b["checksum"],
              f"{tag}: {run}: the ranks' losses or params differ")
        check(rel <= MT_LOSS_REL, f"{tag}: {run} losses {a['losses']} against one process's "
                                  f"{want_losses}: relative {rel:.3g} > {MT_LOSS_REL}")
        check(d_max <= MT_PARAM_MAX and d_mean <= MT_PARAM_MEAN,
              f"{tag}: {run} params after {steps} steps differ from one process's by max "
              f"{d_max:.3g} (limit {MT_PARAM_MAX}), mean {d_mean:.3g} (limit {MT_PARAM_MEAN})")
        if f32_run:
            continue
        log(f"[{tag}] ({'a' if run == 'dp' else 'b'}) {smi}: two ranks share one card over gloo, "
            f"so these are overhead, not scaling | ms a step (window of {MT_TIMED_STEPS} steps, "
            f"no barrier inside): rank 0 {a['step_ms']:.3f}, rank 1 {b['step_ms']:.3f} | gradient "
            f"all-reduce over 'data' ({a['allreduce_mb']:.2f} MB f32, instrumented apart, median "
            f"of 5): rank 0 {a['allreduce_ms']:.3f} ms, rank 1 {b['allreduce_ms']:.3f} ms"
            + (f" | wr gather (1024 x 1536 f32 a rank): rank 0 {a['gather_wr_ms']:.3f} ms, "
               f"rank 1 {b['gather_wr_ms']:.3f} ms" if run == "tp" else ""))
    log(f"[{tag}] fused pair (fwd + bwd recurrence + dWr) at a rank's B={n_local}, T=100, "
        f"U=1024, on its first DP step's operands, against the plain versions (phase 11's "
        f"limits), rank 0 / rank 1: " + ", ".join(
            f"{k} {r0['pair_err'][k]:.3g} / {r1['pair_err'][k]:.3g}" for k in r0["pair_err"])
        + f" | alone on the card, plan {r0['plan']}: rank 0 {r0['pair_ms']:.3f} ms, rank 1 "
          f"{r1['pair_ms']:.3f} ms, bound {r0['pair_bound_ms']:.3f} ms")
    for r, x in ((0, r0), (1, r1)):
        res = x["resume"]
        check(res["equal"] and res["steps"] == MT_STEPS["dp"] - MT_RESUME_AFTER
              and all(res["launches"][k] == res["steps"] for k in TRAIN_KERNELS),
              f"{tag}: rank {r}'s resumed run: {res}")
    log(f"[{tag}] (c) (a) interrupted after {MT_RESUME_AFTER} steps (resume file "
        f"{r0['resume']['bytes']:,} bytes, the whole params and moments written by rank 0) and "
        f"resumed for {r0['resume']['steps']} steps: bit-equal to (a) on both ranks")

    # (d) the TP MobileViT against one process's
    check(r0["vit"] == r1["vit"], f"{tag}: the ranks' MobileViT outputs differ: {r0['vit']}, "
                                  f"{r1['vit']}")
    with np.load(os.path.join(work, "mt_vit.npz")) as f:
        got = {k: torch.from_numpy(f[k]).to(dev) for k in ("float32", "bfloat16", "q8_0")}
    x = torch.from_numpy(images[:MT_VIT_IMAGES]).to(dev)
    vit = load_mobilevit(VIT_CKPT, device=dev)
    q8 = load_mobilevit(VIT_CKPT, device=dev, qtype="q8_0")
    want = {"float32": extract_features(vit, x, compute_dtype=f32),
            "bfloat16": classify(vit, x, compute_dtype=bf16),
            "q8_0": extract_features(q8, x, compute_dtype=f32)}
    errs = {}
    for k in ("float32", "q8_0"):
        errs[k] = float((got[k] - want[k]).abs().max()) / float(want[k].abs().max())
        check(errs[k] <= VIT_CPU_FEATURE_REL, f"{tag}: TP MobileViT {k} features: relative "
                                              f"{errs[k]:.3g} > {VIT_CPU_FEATURE_REL}")
    agree, flips = argmax_near_ties(f"{tag}: TP MobileViT bf16 argmax", got["bfloat16"],
                                    want["bfloat16"], VIT_NEAR_TIE)
    vl = r0["vit"]["launches"]
    check(all(v > 0 for v in vl.values()), f"{tag}: TP MobileViT launches {vl}")
    log(f"[{tag}] (d) TP MobileViT (1, 2), {MT_VIT_IMAGES} images: f32 features relative error "
        f"{errs['float32']:.3g}, q8_0 {errs['q8_0']:.3g} (limit {VIT_CPU_FEATURE_REL}); bf16 "
        f"classify argmax agreement {agree:.4f} ({flips} flips, at near-ties) | rank 0 launches "
        f"{vl} | outputs equal on both ranks")
    del vit, q8, got, want
    torch.cuda.empty_cache()

    # (e) one NCCL rank
    rcs = md_spawn(tag, "train_nccl", 1, work, "nccl")
    check(rcs == [0], f"{tag}: the one-rank NCCL session failed: exit code {rcs}")
    n0 = md_result(work, "train_nccl", 0)
    nccl_leaves = torch.load(os.path.join(work, "mt_nccl_params.pt"))
    check("nccl" in n0["backend"] and n0["losses"] == one["dp"][0]
          and all(torch.equal(a, b) for a, b in zip(nccl_leaves, one["dp"][1]))
          and all(n0["launches"][k] == MT_STEPS["dp"] for k in TRAIN_KERNELS),
          f"{tag}: NCCL rank: {n0}, one process's losses {one['dp'][0]}")
    log(f"[{tag}] (e) one rank, backend {n0['backend']}, (1, 1) mesh: {MT_STEPS['dp']} steps, "
        f"losses {n0['losses']} and params bit-equal to one process's | phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    launches = {k: {"dp": [r0["dp"]["launches"][k], r1["dp"]["launches"][k]],
                    "tp": [r0["tp"]["launches"][k], r1["tp"]["launches"][k]],
                    "nccl": n0["launches"][k]} for k in TRAIN_KERNELS}
    launches.update({k: {"dp": [r0["dp_f32"]["launches"][k], r1["dp_f32"]["launches"][k]]}
                     for k in TRAIN_F32_KERNELS})
    return launches


# ---- phases 23-25: the f32 fused block, AOT artifacts, the trace report ----------------


def ir_f32_phase(tag, dev):
    """Phase 23: the f32 fused inverted residual (``csrc/inverted_residual_f32.cu``)
    through ``fused_inverted_residual(..., compute_dtype=float32)`` on the full
    checkpoint's folded weights at each IR_F32_SHAPES shape (one launch
    each: the main path), held to its plain version at IR_F32_REL of the
    plain output's largest magnitude, a second launch bit-equal; the kernel
    on operands made once, the plain version and the cuDNN f32 chain timed.
    Returns the main shape's kernels-line entry."""
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    f32 = torch.float32
    vit = load_mobilevit(VIT_CKPT, device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    blocks = {"layer_2": vit.layer_2[1], "layer_1": vit.layer_1[0]}
    cases = []
    for name, (b, hh, ww, c, e, cout, resid) in IR_F32_SHAPES.items():
        blk = blocks[name]
        args = fir._folded(blk)
        check(args[0].shape == (c, e) and args[4].shape == (e, cout)
              and blk.use_residual == resid, f"{tag}: {name}'s block is not {IR_F32_SHAPES[name]}")
        cases.append((name, (b, hh, ww, c, e, cout, resid), args,
                      torch.randn((b, hh, ww, c), generator=g, device=dev)))
    port.reset_kernel_launches()
    outs = [fir.fused_inverted_residual(x, *args, use_residual=resid, compute_dtype=f32)
            for _, (*_, resid), args, x in cases]
    torch.cuda.synchronize()
    launches = port.kernel_launches()["inverted_residual_f32"]
    check(launches == len(cases), f"{tag}: {launches} f32 kernel launches for {len(cases)} calls")
    entry = None
    for (name, shape, args, x), got in zip(cases, outs):
        b, hh, ww, c, e, cout, resid = shape
        again = fir.fused_inverted_residual(x, *args, use_residual=resid, compute_dtype=f32)
        want = fir.fused_ir_plain(x, *args, use_residual=resid)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(got.dtype == f32 and bool(torch.isfinite(got).all()) and err <= IR_F32_REL * scale,
              f"{tag}: f32 fused block {name} {shape}: max abs err {err:.3g} against the plain "
              f"version (limit {IR_F32_REL} x {scale:.3g})")
        check(torch.equal(got, again), f"{tag}: f32 fused block {name}: two launches differ")
        del again, want
        ops = fir.ir_f32_operands(*args)
        ms = cuda_ms(lambda: fir.fused_ir_f32_cuda(x, ops, use_residual=resid), n=20)
        g_ms = graph_ms(lambda: fir.fused_ir_f32_cuda(x, ops, use_residual=resid))
        plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *args, use_residual=resid), n=3)
        lib_ms = cuda_ms(cudnn_inverted_residual(x, args, residual=resid), n=20)
        b_ms, b_by, parts = ir_bound(b, hh, ww, c, e, cout, "float32")
        log(f"[{tag}] f32 fused inverted residual {name} (B, H, W, C, E, Cout) = {shape[:6]}, "
            f"residual {resid}: max abs err {err:.3g} ({err / scale:.3g} of the largest value "
            f"{scale:.3g}), two launches bit-equal | kernel {ms:.4f} ms (CUDA graph "
            f"{g_ms:.4f} ms a call; tile {fir.ir_tc_tile(True, 1, c, cout)}) | plain "
            f"{plain_ms:.3f} ms "
            f"| bound {b_ms:.4f} ms ({b_by}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                         parts.items())
            + f") | library: the cuDNN f32 chain (three F.conv2d, channels_last, TF32 off, BN "
              f"folded, two F.silu{', + x' if resid else ''}) {lib_ms:.4f} ms | "
              f"{fir.ir_f32_smem_bytes(c, e, cout)} bytes of shared memory a block")
        if entry is None:    # the main shape: layer_2's
            entry = dict(max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by="bytes" if b_by == "bytes" else "operations",
                         library_ms=lib_ms, launches=launches)
        del ops, got
    del vit, cases, outs
    torch.cuda.empty_cache()
    return entry


# ---- phases 26-27: the stride-2 fused block, the serving tools -------------------------


def ir_s2_phase(tag, dev, images):
    """Phase 26: the stride-2 fused inverted residual (``csrc/inverted_residual_s2.cu``)
    through ``fused_inverted_residual(..., stride=2)`` on the full
    checkpoint's folded weights at each IR_S2_SHAPES shape, bf16 and f32
    (one launch each), held to its plain version (f32 at IR_F32_REL of the
    plain output's largest value; bf16 at phase 13's limits for kernel 8),
    a second launch bit-equal; the kernel on operands made once, the plain
    version and the cuDNN stride-2 chain timed beside the bound. Then the
    main path: ``extract_features`` of ``images`` (a batch) on the model's
    default route, whose stride-2 launches are counted. Returns the two
    kernels-line entries (layer_2's shape; every shape under "shapes")."""
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    f32, bf16 = torch.float32, torch.bfloat16
    vit = load_mobilevit(VIT_CKPT, device=dev)
    blocks = {"layer_2": vit.layer_2[0], **{f"layer_{k}": getattr(vit, f"layer_{k}").downsampling
                                            for k in (3, 4, 5)}}
    g = torch.Generator(device=dev).manual_seed(26)
    entries = {}
    for cd in (bf16, f32):
        name = "inverted_residual_s2_f32" if cd == f32 else "inverted_residual_s2"
        cases = []
        for layer, shape in IR_S2_SHAPES.items():
            b, hh, ww, c, e, cout = shape
            blk = blocks[layer]
            args = fir._folded(blk)
            check(blk.conv_3x3.stride == 2 and not blk.use_residual and args[0].shape == (c, e)
                  and args[4].shape == (e, cout), f"{tag}: {layer}'s block is not {shape}")
            cases.append((layer, shape, args,
                          torch.randn((b, hh, ww, c), generator=g, device=dev).to(cd)))
        port.reset_kernel_launches()
        outs = [fir.fused_inverted_residual(x, *args, stride=2, compute_dtype=cd)
                for _, _, args, x in cases]
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        check(launches[name] == launches["fused_inverted_residual"] == len(cases)
              and sum(launches.values()) == 2 * len(cases),
              f"{tag}: {len(cases)} stride-2 calls at {cdname(cd)} launched {launches}")
        shapes = {}
        for (layer, shape, args, x), got in zip(cases, outs):
            b, hh, ww, c, e, cout = shape
            again = fir.fused_inverted_residual(x, *args, stride=2, compute_dtype=cd)
            pargs = (args[0].to(cd), args[1], args[2], args[3], args[4].to(cd), args[5])
            want = fir.fused_ir_plain(x, *pargs, stride=2).float()
            torch.cuda.synchronize()
            check(got.shape == (b, hh // 2, ww // 2, cout) and got.dtype == cd
                  and bool(torch.isfinite(got.float()).all()),
                  f"{tag}: {layer} {cdname(cd)}: output {got.dtype}{tuple(got.shape)}")
            scale = float(want.abs().max())
            d = (got.float() - want).abs()
            err, mean = float(d.max()), float(d.mean())
            if cd == f32:
                limit = f"limit {IR_F32_REL} x {scale:.3g}"
                check(err <= IR_F32_REL * scale, f"{tag}: stride-2 f32 {layer} {shape}: max abs "
                                                 f"err {err:.3g} ({limit})")
            else:
                gap = float((fir.fused_ir_plain(x.float(), *args, stride=2) - want).abs().mean())
                limit = (f"limits {VIT_BF16_MAX['ir']} x {scale:.3g}, mean "
                         f"{VIT_BF16_MEAN_FRAC['ir']} x {gap:.3g}")
                check(err <= VIT_BF16_MAX["ir"] * scale and mean <= VIT_BF16_MEAN_FRAC["ir"] * gap,
                      f"{tag}: stride-2 bf16 {layer} {shape}: max abs err {err:.3g}, mean "
                      f"{mean:.3g} ({limit}, the plain version's bf16-vs-f32 distance)")
            check(torch.equal(got, again), f"{tag}: stride-2 {cdname(cd)} {layer}: two launches "
                                           f"differ")
            del again, want
            ops = fir.ir_s2_operands(*args, compute_dtype=cd)
            ms = cuda_ms(lambda: fir.fused_ir_s2_cuda(x, ops), n=20)
            g_ms = graph_ms(lambda: fir.fused_ir_s2_cuda(x, ops))
            plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *pargs, stride=2), n=3)
            lib_ms = cuda_ms(cudnn_inverted_residual(x, args, residual=False, stride=2), n=20)
            b_ms, b_by, parts = ir_bound(b, hh, ww, c, e, cout, cdname(cd), stride=2)
            log(f"[{tag}] stride-2 fused inverted residual {cdname(cd)} {layer} (B, H, W, C, E, "
                f"Cout) = {shape}: max abs err {err:.3g} ({err / scale:.3g} of the largest value "
                f"{scale:.3g}; mean {mean:.3g}; {limit}), two launches bit-equal | kernel "
                f"{ms:.4f} ms (CUDA graph {g_ms:.4f} ms a call; tile "
                f"{fir.ir_tc_tile(cd == f32, 2, c, cout)}) | plain {plain_ms:.3f} ms | bound "
                f"{b_ms:.4f} ms ({b_by}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                + f") | library: the cuDNN stride-2 chain (three F.conv2d, channels_last, the "
                  f"depthwise at stride 2, BN folded, two F.silu) {lib_ms:.4f} ms | "
                  f"{fir.ir_s2_smem_bytes(c, e, cout, cd)} bytes of shared memory a block")
            shapes[layer] = dict(max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms,
                                 bound_by="bytes" if b_by == "bytes" else "operations",
                                 library_ms=lib_ms)
            del ops
        del outs, cases
        # the main path: a batch through extract_features on the default
        # route, which takes all four downsamplers at both dtypes
        port.reset_kernel_launches()
        feats = extract_features(vit, images, compute_dtype=cd)
        torch.cuda.synchronize()
        n = port.kernel_launches()[name]
        check(n == len(IR_S2_SHAPES) and bool(torch.isfinite(feats.float()).all()),
              f"{tag}: extract_features at {cdname(cd)} launched {n} stride-2 kernels, want "
              f"{len(IR_S2_SHAPES)} (one a downsampler: {', '.join(IR_S2_SHAPES)})")
        log(f"[{tag}] extract_features B={images.shape[0]} {cdname(cd)} on the default route: "
            f"{n} {name} launches (one a downsampler)")
        entries[name] = dict(shapes["layer_2"], launches=n, shapes=shapes)
    del vit
    torch.cuda.empty_cache()
    return entries


def tools_phase(tag):
    """Phase 27: the port's serving tools once each, at a small setting, in
    processes of their own: ``tools/torch_serving_breakdown.py`` (64 slots,
    16 inner steps, fetch depth 2), ``tools/torch_vision_serving_soak.py``
    (512 images, 16 cancels) and ``tools/torch_capacity_probe.py`` (q8_0,
    one worker: the fused tick at 1024 slots; no scan or routing cells);
    each must end in its JSON line with figures that hang together."""
    def run(script, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", script), *argv],
                              cwd=REPO, capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
        check(proc.returncode == 0, f"{tag}: {script} {' '.join(argv)} exited "
                                    f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        try:
            out = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            raise SmokeFailure(f"{tag}: {script} printed no JSON line: {proc.stdout[-500:]!r}")
        return out, time.perf_counter() - t0

    sb, sec = run("torch_serving_breakdown.py", "--slots", "64", "--depths", "2", "--inner",
                  "16", "--req-tokens", "64", "--warm-tokens", "16")
    check(len(sb["configs"]) == 2 and all(
        c["device"]["tick"] == "fused" and c["device"]["timer"] == "cuda events"
        and c["e2e"]["tokens"] > 0 and 0 < c["e2e_fraction_of_device"] for c in sb["configs"]),
        f"{tag}: torch_serving_breakdown.py: {sb}")
    log(f"[{tag}] tools/torch_serving_breakdown.py --slots 64 --depths 2 --inner 16 ({sec:.1f} s)"
        f": device tick {sb['configs'][0]['device']['tick_ms']} ms | " + "; ".join(
            f"fetch_async {c['fetch_async']}: e2e {c['e2e']['tokens_per_s']:,.0f} tokens/s = "
            f"{c['e2e_fraction_of_device']} of the device tick, breakdown {c['e2e']['breakdown']}"
            for c in sb["configs"]))
    so, sec = run("torch_vision_serving_soak.py", "--images", "512", "--cancels", "16")
    check(so["completed"] + so["canceled"] == so["images"] == 512 and so["e2e_img_s"] > 0
          and so["offline_img_s"] > 0, f"{tag}: torch_vision_serving_soak.py: {so}")
    log(f"[{tag}] tools/torch_vision_serving_soak.py --images 512 --cancels 16 ({sec:.1f} s): "
        f"offline B=128 {so['offline_img_s']:,.1f} images/s, engine end to end "
        f"{so['e2e_img_s']:,.1f} ({so['fraction_of_offline']} of offline), {so['canceled']} "
        f"canceled | breakdown {so['breakdown']}")
    cp, sec = run("torch_capacity_probe.py", "--qtypes", "q8_0", "--start", "1024",
                  "--max-slots", "1024", "--scan-slots", "", "--routing-slots", "")
    fused = cp["fused"]["q8_0"]
    check(fused["max_slots"] == 1024 and fused["at_max"]["ok"]
          and fused["at_max"]["tokens_per_s"] > 0
          and cp["weight_bytes"]["q4_0"] < cp["weight_bytes"]["q8_0"] < cp["weight_bytes"]["f32"],
          f"{tag}: torch_capacity_probe.py: {cp}")
    log(f"[{tag}] tools/torch_capacity_probe.py --qtypes q8_0 --start 1024 --max-slots 1024 "
        f"({sec:.1f} s, one worker): weight bytes {cp['weight_bytes']} | the fused tick at "
        f"{fused['max_slots']} slots: {fused['at_max']['tokens_per_s']:,.0f} tokens/s "
        f"({fused['at_max'].get('device_median_ms')} ms a 128-step tick)")


class _LogSink:
    """Messages logged to ``logger`` inside the block (its level lowered to
    WARNING for the block)."""

    def __init__(self, logger):
        import logging

        self.logger, self.messages = logger, []
        sink = self

        class _H(logging.Handler):
            def emit(self, record):
                sink.messages.append(record.getMessage())

        self.handler = _H(level=logging.WARNING)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def aot_phase(tag, dev, tok, images):
    """Phase 24: ``aot-export`` and ``aot-run`` on the card for both models
    (the CLI defaults but the GRU's depth: the GRU at batch 8, prompt 50,
    AOT_GRU_STEPS steps on ``gru_shakespeare.bin`` at q8_0, its export's
    time growing with the steps it unrolls; MobileViT at 256 px, batch 8 on
    ``mobilevit_synth_full.ggml``). The artifacts' outputs against the
    eager entry points on params an eager call has used (their caches
    filled): GRU tokens equal, features within AOT_FEATURE_REL of the
    largest; the launches of the artifacts' runs; export and load seconds
    and bytes (each under AOT_MAX_BYTES: no weights inside), loaded without
    the unpickling fallback. Returns the launches of the two replays."""
    import logging

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.mobilevit import (
        extract_features,
        from_named_tensors,
        infer_config,
    )
    from ggml_experiments_tpu_torch.serving import aot

    out = {}
    serde_log = logging.getLogger("torch._export.serde.serialize")
    with tempfile.TemporaryDirectory() as tmp:
        # -- the GRU decode artifact
        art = os.path.join(tmp, "decode.gxa")
        rc, text, export_s = run_command(["aot-export", "--model", "gru", "--weights", CKPT,
                                          "--qtype", "q8_0", "--steps", str(AOT_GRU_STEPS),
                                          "--output", art])
        check(rc == 0, f"{tag}: aot-export --model gru failed")
        meta = json.loads(text.strip().splitlines()[-1])
        check(meta["kind"] == "gru-decode" and meta["device"] == "cuda"
              and (meta["batch"], meta["prompt_len"], meta["total_steps"]) == (
                  8, 50, AOT_GRU_STEPS)
              and meta["qtype"] == "q8_0", f"{tag}: GRU artifact header {meta}")
        b, p, t = meta["batch"], meta["prompt_len"], meta["total_steps"]
        # eager generate on aot-run's default prompt, every row the same
        params = load_gru_any(CKPT, qtype="q8_0", device=dev)
        ids = tok.encode("ROMEO:")
        prompt = torch.zeros((b, p), dtype=torch.int32, device=dev)
        prompt[:, :len(ids)] = torch.tensor(ids, dtype=torch.int32, device=dev)
        lengths = torch.full((b,), len(ids), dtype=torch.int32, device=dev)
        want = gru_textgen.generate(params, prompt, lengths, t)   # fills the params' caches
        check("launch" in params.cell.recurrent_kernel.dense, f"{tag}: no eager launch cache")
        port.reset_kernel_launches()
        with _LogSink(serde_log) as msgs:
            rc, run_text, run_s = run_command(["aot-run", "--artifact", art, "--weights", CKPT])
        launches = port.kernel_launches()
        check(rc == 0 and run_text == tok.decode(want[0].tolist()) + "\n",
              f"{tag}: aot-run printed {run_text!r}, eager generate gives "
              f"{tok.decode(want[0].tolist())!r}")
        check(launches["qmatmul_q8_0"] == t and sum(launches.values()) == t,
              f"{tag}: aot-run launched {launches}, expected {t} qmatmul_q8_0")
        check(not any("weights_only=False" in m for m in msgs),
              f"{tag}: the GRU artifact loaded through the unpickling fallback: {msgs}")
        # the program again, on the params eager generate has used
        t0 = time.perf_counter()
        _, ep = aot.load_artifact(art)
        load_s = time.perf_counter() - t0
        got = aot.call_artifact(ep, params, prompt, lengths)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"{tag}: the GRU artifact's tokens differ from eager generate")
        size = os.path.getsize(art)
        check(size < AOT_MAX_BYTES, f"{tag}: the GRU artifact holds {size} bytes")
        out["qmatmul_q8_0"] = launches["qmatmul_q8_0"]
        log(f"[{tag}] GRU decode artifact (B, P, T) = ({b}, {p}, {t}), q8_0: aot-export "
            f"{export_s:.2f} s (load the weights, trace, save), {size:,} bytes "
            f"({os.path.getsize(CKPT):,} in gru.bin), {len(ep.graph.nodes)} graph nodes | aot-run "
            f"{run_s:.2f} s (load, weights, replay): text equal to eager generate's, "
            f"{launches['qmatmul_q8_0']} qmatmul_q8_0 launches and no other kernel, no "
            f"unpickling fallback | load_artifact {load_s:.2f} s; replay on params an eager "
            f"call has used: tokens equal to eager generate")
        del params, ep, got, want
        # -- the MobileViT features artifact
        art = os.path.join(tmp, "features.gxa")
        rc, text, export_s = run_command(["aot-export", "--model", "mobilevit", "--weights",
                                          VIT_CKPT, "--output", art])
        check(rc == 0, f"{tag}: aot-export --model mobilevit failed")
        meta = json.loads(text.strip().splitlines()[-1])
        check(meta["kind"] == "mobilevit-features" and meta["device"] == "cuda"
              and (meta["batch"], meta["image_size"]) == (8, 256),
              f"{tag}: MobileViT artifact header {meta}")
        with _LogSink(serde_log) as msgs:
            rc, run_text, run_s = run_command(["aot-run", "--artifact", art, "--weights",
                                               VIT_CKPT])
        check(rc == 0 and "output feature shape: : Dims: (8, 8, 640)" in run_text
              and "i0 = 0, i1 = 0" in run_text, f"{tag}: aot-run printed {run_text!r}")
        check(not any("weights_only=False" in m for m in msgs),
              f"{tag}: the MobileViT artifact loaded through the unpickling fallback: {msgs}")
        t0 = time.perf_counter()
        _, ep = aot.load_artifact(art)
        load_s = time.perf_counter() - t0
        named = read_named_tensors(VIT_CKPT)
        vit = from_named_tensors(named, infer_config(named, image_size=256), device=dev)
        x = torch.from_numpy(np.ascontiguousarray(images[:meta["batch"]])).to(dev)
        want = extract_features(vit, x)
        port.reset_kernel_launches()
        got = aot.call_artifact(ep, vit, x)
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        n_layers = sum(len(blk.transformer) for blk in (vit.layer_3, vit.layer_4, vit.layer_5))
        n_ir = sum(blk.fused_route(torch.float32, dev) for blk in ir_blocks(vit))
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(got.shape == want.shape and err <= AOT_FEATURE_REL * scale,
              f"{tag}: the MobileViT artifact's features: max abs err {err:.3g} against "
              f"extract_features (limit {AOT_FEATURE_REL} x {scale:.3g})")
        n_s2 = sum(blk.fused_route(torch.float32, dev) for blk in ir_blocks(vit)
                   if blk.conv_3x3.stride == 2)
        attn = f32_attention_launches(n_layers)
        check(all(launches[k] == v for k, v in attn.items()) and n_ir > 0
              and launches["inverted_residual_f32"] == n_ir - n_s2
              and launches["inverted_residual_s2_f32"] == n_s2
              and launches["fused_inverted_residual"] == n_ir
              and sum(launches.values()) == sum(attn.values()) + 2 * n_ir,
              f"{tag}: the MobileViT artifact's replay launched {launches}, expected {attn} and "
              f"{n_ir} f32 inverted residuals, {n_s2} of them at stride 2")
        size = os.path.getsize(art)
        check(size < AOT_MAX_BYTES, f"{tag}: the MobileViT artifact holds {size} bytes")
        out.update({k: launches[k] for k in attn})
        out["inverted_residual_f32"] = launches["inverted_residual_f32"]
        out["inverted_residual_s2_f32"] = launches["inverted_residual_s2_f32"]
        log(f"[{tag}] MobileViT features artifact (B, S) = (8, 256), f32: aot-export "
            f"{export_s:.2f} s, {size:,} bytes ({os.path.getsize(VIT_CKPT):,} in the "
            f"weight.ggml), {len(ep.graph.nodes)} graph nodes, load {load_s:.2f} s | aot-run "
            f"{run_s:.2f} s, no unpickling fallback | "
            f"replay: max abs err {err:.3g} against extract_features (largest {scale:.3g}), "
            + ", ".join(f"{launches[k]} {k}" for k in attn) + f" and {n_ir} f32 inverted "
            f"residual launches, no other kernel of the port")
    del vit, ep, got, want
    torch.cuda.empty_cache()
    return out


def trace_report_rows(argv):
    """(rows as (us a call, count, name), the table) of one run of
    ``tools/torch_trace_report.py`` in a process of its own: a process that
    has run the profiler before reads other kernels' activity into a later
    trace, or loses some."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_trace_report.py"),
                           *argv], cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"torch_trace_report.py {' '.join(argv)} failed:\n"
                                f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["us/call", "%"])
    rows = []
    for ln in lines[start + 1:]:
        us, _, count, name = ln.split(None, 3)
        rows.append((float(us), int(count), name))
    return rows, "\n".join(lines[start:])


def trace_phase(tag, dev):
    """Phase 25: the trace report (``tools/torch_trace_report.py``, on
    ``utils/trace_report``) of one f32 MobileViT forward at B=VIT_BATCH
    (flash attention and the f32 fused inverted residual) and one bf16 GRU
    ``decode`` at TRACE_DECODE_SHAPE (the persistent kernel), random
    full-size weights: the rows name the port's kernels by their counters'
    names with the launches the runs made; then the native host runtime,
    built on this host, its readers against the numpy ones."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch import runtime
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors_py
    from ggml_experiments_tpu_torch.formats.gru_bin import read_tensors_py
    from ggml_experiments_tpu_torch.models.mobilevit import (
        MobileViTConfig,
        from_named_tensors,
        random_named_tensors,
    )

    cfg = MobileViTConfig()
    vit = from_named_tensors(random_named_tensors(cfg), cfg, device=dev)
    n_layers = sum(len(blk.transformer) for blk in (vit.layer_3, vit.layer_4, vit.layer_5))
    n_s2 = sum(blk.fused_route(torch.float32, dev) for blk in ir_blocks(vit)
               if blk.conv_3x3.stride == 2)
    n_ir = sum(blk.fused_route(torch.float32, dev) for blk in ir_blocks(vit)) - n_s2
    del vit
    t0 = time.perf_counter()
    rows, table = trace_report_rows(["--model", "mobilevit", "--batch", str(VIT_BATCH),
                                     "--compute", "float32", "--reps", "1", "--top", "60"])
    sec = time.perf_counter() - t0
    byname = {name: (us, count) for us, count, name in rows}
    attn = f32_attention_launches(n_layers)
    for name, n in (*attn.items(), ("inverted_residual_f32", n_ir),
                    ("inverted_residual_s2_f32", n_s2)):
        check(byname.get(name, (0, 0))[1] == n,
              f"{tag}: the f32 MobileViT trace names no {name} row of {n} launches: "
              f"{[(r[2][:40], r[1]) for r in rows[:8]]}")
    busy = sum(us for us, _, _ in rows)
    log(f"[{tag}] tools/torch_trace_report.py --model mobilevit --batch {VIT_BATCH} --compute "
        f"float32 ({sec:.1f} s): {busy / 1e3:.2f} ms busy a forward; " + ", ".join(
            f"{k} {byname[k][0] / 1e3:.3f} ms in {n}" for k, n in attn.items())
        + f" launches, inverted_residual_f32 "
        f"{byname['inverted_residual_f32'][0] / 1e3:.3f} ms in {n_ir}, inverted_residual_s2_f32 "
        f"{byname.get('inverted_residual_s2_f32', (0, 0))[0] / 1e3:.3f} ms in {n_s2}:\n"
        + "\n".join(table.splitlines()[:13]))
    b, t = TRACE_DECODE_SHAPE
    rows, table = trace_report_rows(["--model", "gru", "--batch", str(b), "--steps", str(t),
                                     "--reps", "1", "--top", "6"])
    check(rows and rows[0][2] == "fused_gru_decode",
          f"{tag}: the GRU decode trace's top row is {rows[0][2][:60] if rows else None!r}")
    log(f"[{tag}] tools/torch_trace_report.py --model gru --batch {b} --steps {t} (bf16 q8_0, "
        f"device us a call):\n" + table)
    # the native host runtime, which g++ built at the first weight file read
    check(runtime.available(), f"{tag}: no g++ on this host for the native runtime")
    gru_native, gru_py = runtime.read_gru_bin_native(CKPT), read_tensors_py(CKPT)
    check(len(gru_native) == len(gru_py) == 6
          and all(np.array_equal(a, b) for a, b in zip(gru_native, gru_py)),
          f"{tag}: the native gru.bin reader differs from the numpy one")
    vit_native = runtime.read_named_tensors_native(VIT_CKPT)
    vit_py = read_named_tensors_py(VIT_CKPT)
    check(vit_native.keys() == vit_py.keys()
          and all(np.array_equal(vit_native[k], vit_py[k]) for k in vit_py),
          f"{tag}: the native weight.ggml reader differs from the numpy one")
    log(f"[{tag}] native runtime ({os.path.basename(runtime.lib_path())}, built by g++ on this "
        f"host at the first weight file read): gru.bin (6 tensors) and weight.ggml "
        f"({len(vit_py)} tensors) read equal to the numpy readers")
    torch.cuda.empty_cache()


# ---- phase 28: the f32 fused layer --------------------------------------------------------


def layer_f32_phase(tag, dev, images):
    """Phase 28: the f32 fused transformer layer (``csrc/transformer_layer_f32.cu``)
    at phase 13's shapes on the full checkpoint's weights at B = VIT_BATCH:
    each stage's first layer (input projection), a middle one and the last
    (final LN + conv_projection with BN and SiLU). Each of the three kernels
    on its plain version's inputs and the whole layer against
    ``fused_transformer_layer_plain``, within LAYER_F32_REL of the largest
    value, two launches bit-equal; each kernel, the layer and the plain
    versions timed beside the 3xTF32 bound and the library columns
    (``nn.TransformerEncoderLayer(C, H, F, SiLU, norm_first)`` at f32 with
    TF32 off, no projections; ``scaled_dot_product_attention`` f32 for the
    attention). Then ``extract_features`` at f32 for each LAYER_F32_BATCHES
    with the route on and off in turns (on: the three kernels a layer and
    no flash attention; off: flash a layer), features within
    VIT_CPU_FEATURE_REL of each other. Returns the kernels-line readings of
    the three kernels, a forward's worth summed."""
    import torch
    import torch.nn.functional as F

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    f32 = torch.float32
    vit = tmv.load_mobilevit(VIT_CKPT, device=dev)
    g = torch.Generator(device=dev).manual_seed(28)
    tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_t=[0.0, 0.0], library_ms=None)
           for k in F32_LAYER_KERNELS}
    tot["transformer_attention_f32"]["library_ms"] = 0.0
    layer_sum = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, bound_t=[0.0, 0.0])

    def rel(got, want):
        return float((got - want).abs().max()), float(want.abs().max())

    for blk, side in ((vit.layer_3, 32), (vit.layer_4, 16), (vit.layer_5, 8)):
        n = len(blk.transformer)
        cin, c = blk.conv_1x1.kernel.shape[-2:]
        l = (side // blk.patch_size) ** 2
        bp = VIT_BATCH * blk.patch_size ** 2
        pk = blk.conv_projection.kernel
        h = blk.transformer[0].attention.num_heads
        f = blk.transformer[0].intermediate_kernel.shape[-1]
        variants = [("first", 1, dict(input_proj=blk.conv_1x1.kernel.reshape(cin, c))),
                    ("middle", n - 2, {}),
                    ("last", 1, dict(final_ln=(blk.ln_gamma, blk.ln_beta), final_ln_eps=blk.eps,
                                     output_proj=(pk.reshape(c, -1), blk.conv_projection.bn.scale,
                                                  blk.conv_projection.bn.bias,
                                                  blk.conv_projection.activation)))]
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True, device=dev,
                                               dtype=f32).eval()
        xl = torch.randn((bp, l, c), generator=g, device=dev)
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: lib(xl), n=10)
        del lib, xl
        for name, count, kw in variants:
            if count <= 0:
                continue
            layer = blk.transformer[{"first": 0, "middle": 1, "last": n - 1}[name]]
            ops = ftl.layer_operands(layer, c, f32, **kw)
            width = cin if "input_proj" in kw else c
            cout = ops.wout.shape[1] if ops.wout is not None else c
            x = torch.randn((bp, l, width), generator=g, device=dev)
            got = ftl.fused_layer_cuda(x, ops)
            again = ftl.fused_layer_cuda(x, ops)
            torch.cuda.synchronize()
            want = ftl.fused_transformer_layer_plain(x, ops)
            err, scale = rel(got, want)
            what = f"f32 layer {name} (bp, L, Cin, C, Cout) = ({bp}, {l}, {width}, {c}, {cout})"
            check(bool(torch.isfinite(got).all()) and err <= LAYER_F32_REL * scale,
                  f"{tag}: {what}: max abs err {err:.3g} against the plain version (limit "
                  f"{LAYER_F32_REL} x {scale:.3g})")
            check(torch.equal(got, again), f"{tag}: {what}: two launches differ")
            del got, again, want
            bounds = transformer_layer_bound(bp, l, width, c, f, cout, "float32",
                                             in_proj="input_proj" in kw,
                                             out_proj="output_proj" in kw)
            ms = cuda_ms(lambda: ftl.fused_layer_cuda(x, ops), n=10)
            plain_ms = cuda_ms(lambda: ftl.fused_transformer_layer_plain(x, ops), n=2, warmup=1)
            b_ms, b_by = bound(*bounds["layer"], "tf32x3")
            layer_sum["ms"] += count * ms
            layer_sum["plain_ms"] += count * plain_ms
            layer_sum["lib_ms"] += count * lib_ms
            layer_sum["bound_t"][0] += count * bound(bounds["layer"][0], 0, "tf32x3")[0]
            layer_sum["bound_t"][1] += count * bound(0, bounds["layer"][1], "tf32x3")[0]
            log(f"[{tag}] {what} x{count}: max abs err {err:.3g} ({err / scale:.3g} of the "
                f"largest value {scale:.3g}), two launches bit-equal | layer {ms:.4f} ms | plain "
                f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | nn.TransformerEncoderLayer "
                f"f32, TF32 off (no projections) {lib_ms:.4f} ms")

            # the three kernels, each on its plain version's inputs
            dh, dhp = c // h, ftl.head_pad(c // h)
            x2 = x.reshape(bp * l, width)
            want_qkv = ftl.ln_qkv_plain(x2, ops)
            want_ctx = ftl.attention_plain(want_qkv, l, ops)
            heads = [want_qkv.reshape(bp, l, 3, h, dhp)[:, :, j, :, :dh].transpose(1, 2)
                     .contiguous() for j in range(3)]
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), n=10)
            del heads
            cases = (("transformer_ln_qkv_f32", lambda: ftl.ln_qkv_cuda(x2, ops, l),
                      lambda: ftl.ln_qkv_plain(x2, ops), "ln_qkv", None),
                     ("transformer_attention_f32", lambda: ftl.attention_cuda(want_qkv, l, ops),
                      lambda: ftl.attention_plain(want_qkv, l, ops), "attention", sdpa_ms),
                     ("transformer_proj_ffn_f32", lambda: ftl.proj_ffn_cuda(x2, want_ctx, ops, l),
                      lambda: ftl.proj_ffn_plain(x2, want_ctx, ops), "proj_ffn", None))
            parts = []
            for kname, kernel, plain, part, klib in cases:
                kgot, kagain = kernel(), kernel()
                torch.cuda.synchronize()
                kerr, kscale = rel(kgot, plain())
                check(bool(torch.isfinite(kgot).all()) and kerr <= LAYER_F32_REL * kscale,
                      f"{tag}: {kname} {what}: max abs err {kerr:.3g} against the plain version "
                      f"(limit {LAYER_F32_REL} x {kscale:.3g})")
                check(torch.equal(kgot, kagain), f"{tag}: {kname} {what}: two launches on the "
                                                 f"same inputs differ")
                del kgot, kagain
                kms = cuda_ms(kernel, n=10)
                kplain = cuda_ms(plain, n=2, warmup=1)
                t = tot[kname]
                t["max_abs_err"] = max(t["max_abs_err"], kerr)
                t["ms"] += count * kms
                t["plain_ms"] += count * kplain
                nbytes, ops_n = bounds[part]
                t["bound_t"][0] += count * bound(nbytes, 0, "tf32x3")[0]
                t["bound_t"][1] += count * bound(0, ops_n, "tf32x3")[0]
                if klib is not None:
                    t["library_ms"] += count * klib
                kb_ms, kb_by = bound(nbytes, ops_n, "tf32x3")
                parts.append(f"{part} {kms:.4f} ms (bound {kb_ms:.4f}, {kb_by}; plain "
                             f"{kplain:.3f}; err {kerr / kscale:.3g} of the largest)")
            log(f"[{tag}]   its kernels on their plain versions' inputs, each launched twice "
                f"(bit-equal): " + " | ".join(parts) + f" | scaled_dot_product_attention f32 "
                f"{sdpa_ms:.4f} ms")

            # each kernel on one and on two consumer warpgroups forced, and at a
            # ragged T of 3 x 16 rows (neither a 64- nor a 128-row tile; the
            # attention's tile packs three sequences of 16); the attention
            # refuses two warpgroups where its block has one 64-row tile
            want_out = ftl.proj_ffn_plain(x2, want_ctx, ops)
            xr = torch.randn((48, width), generator=g, device=dev)
            want_r = ftl.ln_qkv_plain(xr, ops)
            ctx_r = ftl.attention_plain(want_r, 16, ops)
            want_rout = ftl.proj_ffn_plain(xr, ctx_r, ops)
            forced = []
            for nwg in (None, 1, 2):
                for kname, kernel, kwant in (
                        ("ln_qkv", lambda: ftl.ln_qkv_cuda(x2, ops, l, _plan=nwg), want_qkv),
                        ("attention", lambda: ftl.attention_cuda(want_qkv, l, ops, _plan=nwg),
                         want_ctx),
                        ("proj_ffn", lambda: ftl.proj_ffn_cuda(x2, want_ctx, ops, l, _plan=nwg),
                         want_out),
                        ("ln_qkv T=48", lambda: ftl.ln_qkv_cuda(xr, ops, 16, _plan=nwg), want_r),
                        ("attention T=48", lambda: ftl.attention_cuda(want_r, 16, ops, _plan=nwg),
                         ctx_r),
                        ("proj_ffn T=48", lambda: ftl.proj_ffn_cuda(xr, ctx_r, ops, 16,
                                                                    _plan=nwg), want_rout)):
                    try:
                        kgot, kagain = kernel(), kernel()
                    except ValueError as ex:
                        one_tile = kname.startswith("attention") and (kname.endswith("T=48")
                                                                      or l <= 64)
                        check(nwg == 2 and (c == 240 and "does not fit" in str(ex)
                                            or one_tile and "takes 1 consumer" in str(ex)),
                              f"{tag}: {kname} {what} on {nwg} warpgroups refused: {ex}")
                        forced.append(f"{kname} x{nwg} refused")
                        continue
                    torch.cuda.synchronize()
                    kerr, kscale = rel(kgot, kwant)
                    check(bool(torch.isfinite(kgot).all()) and kerr <= LAYER_F32_REL * kscale
                          and torch.equal(kgot, kagain),
                          f"{tag}: {kname} {what} on {nwg} warpgroups: max abs err {kerr:.3g} "
                          f"(limit {LAYER_F32_REL} x {kscale:.3g}), bit-equal "
                          f"{torch.equal(kgot, kagain)}")
                    forced.append(f"{kname} x{nwg or 'plan'} {kerr / kscale:.3g}")
                    del kgot, kagain
            log(f"[{tag}]   forced warpgroups and T=48, each launched twice (bit-equal), err of "
                f"the largest: " + ", ".join(forced))
            del x, x2, want_qkv, want_ctx, want_out, xr, want_r, ctx_r, want_rout, ops
    for t in tot.values():
        t["bound_ms"] = max(t["bound_t"])
        t["bound_by"] = "bytes" if t["bound_t"][0] >= t["bound_t"][1] else "operations"
        del t["bound_t"]
    log(f"[{tag}] a B={VIT_BATCH} forward's nine f32 layers: {layer_sum['ms']:.3f} ms in three "
        f"launches a layer (" + ", ".join(f"{k[12:]} {v['ms']:.3f}" for k, v in tot.items())
        + f") | bound {max(layer_sum['bound_t']):.3f} ms | plain {layer_sum['plain_ms']:.2f} ms "
          f"| nn.TransformerEncoderLayer f32 {layer_sum['lib_ms']:.3f} ms (no projections) | "
          f"scaled_dot_product_attention f32 "
          f"{tot['transformer_attention_f32']['library_ms']:.3f} ms")

    # the route through the model: extract_features at f32, on and off in turns
    n_layers = sum(len(b.transformer) for b in (vit.layer_3, vit.layer_4, vit.layer_5))
    for b in LAYER_F32_BATCHES:
        xb = images[:b]
        feats, times = {}, {}
        for on in (False, True, True, False):
            with contextlib.nullcontext() if on else f32_layer_route_off():
                port.reset_kernel_launches()
                out = tmv.extract_features(vit, xb)
                torch.cuda.synchronize()
                launches = port.kernel_launches()
                times.setdefault(on, []).append(
                    cuda_ms(lambda: tmv.extract_features(vit, xb), n=5, warmup=1))
            want = f32_attention_launches(n_layers) if on else {"flash_mha": n_layers}
            unwanted = ("flash_mha",) if on else F32_LAYER_KERNELS
            check(all(launches[k] == v for k, v in want.items())
                  and not any(launches[k] for k in unwanted),
                  f"{tag}: extract_features B={b} f32, route {'on' if on else 'off'}: "
                  f"launches {launches}")
            feats[on] = out
        err, scale = rel(feats[True], feats[False])
        check(err <= VIT_CPU_FEATURE_REL * scale,
              f"{tag}: extract_features B={b} f32: route on against off, max abs err "
              f"{err:.3g} (limit {VIT_CPU_FEATURE_REL} x {scale:.3g})")
        off, on_ = min(times[False]), min(times[True])
        log(f"[{tag}] extract_features B={b} f32, the f32 layer route off / on (turns off, "
            f"on, on, off): " + ", ".join(f"{t:.3f}" for t in times[False]) + " / "
            + ", ".join(f"{t:.3f}" for t in times[True]) + f" ms ({off / on_:.3f}x by the "
            f"best turns) | features: on against off, max abs err {err / scale:.3g} of the "
            f"largest | launches on: three f32 kernels a layer, no flash; off: flash a layer")
    del vit
    torch.cuda.empty_cache()
    return tot


# ---- phase 29: the examples and the three tools ------------------------------------------


def example_module(name):
    """``examples/<name>.py`` loaded as a module (the examples are scripts, not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checkpoint_digests():
    """sha256 of every file under ``checkpoints/``."""
    import hashlib

    out = {}
    for root, _, names in os.walk(os.path.join(REPO, "checkpoints")):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, REPO)] = hashlib.sha256(f.read()).hexdigest()
    return out


def counted_run(tag, what, fn):
    """``fn()`` with the launch counters zeroed before it and read after it,
    its standard output captured. Returns (its result, the printed text, the
    nonzero launches, seconds)."""
    import io

    import torch

    import ggml_experiments_tpu_torch as port

    buf = io.StringIO()
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in port.kernel_launches().items() if v}
    log(f"[{tag}] {what}: {sec:.2f} s | launches {launches}")
    return result, buf.getvalue(), launches, sec


def cls_report_checks(tag, what, rep):
    """tests/test_trained_classifier.py's margins on a report of
    ``tools/torch_train_mobilevit_cls.py``."""
    check(0.85 <= rep["top1_f32"] <= 0.985, f"{tag}: {what}: f32 top-1 {rep['top1_f32']}")
    check(rep["agreement_q8_0"] >= 0.99 and rep["dtop1_q8_0"] <= 0.009,
          f"{tag}: {what}: q8_0 agreement {rep['agreement_q8_0']}, dtop1 {rep['dtop1_q8_0']}")
    check(rep["agreement_q4_0"] >= 0.85 and rep["dtop1_q4_0"] <= 0.10,
          f"{tag}: {what}: q4_0 agreement {rep['agreement_q4_0']}, dtop1 {rep['dtop1_q4_0']}")
    rel8, rel4 = rep["rel_logit_rmse_q8_0"], rep["rel_logit_rmse_q4_0"]
    check(rel8 < 0.02 and rel4 < 0.15 and rel8 < rel4,
          f"{tag}: {what}: relative logit RMSE q8_0 {rel8}, q4_0 {rel4}")
    check(rep["agreement_q8_0"] >= rep["agreement_q5_1"] >= rep["agreement_q4_0"] >= 0.80,
          f"{tag}: {what}: agreement q8_0 {rep['agreement_q8_0']}, q5_1 "
          f"{rep['agreement_q5_1']}, q4_0 {rep['agreement_q4_0']}")


def examples_phase(tag, dev):
    """Phase 29: the five ``examples/torch_*.py`` and the three tools on the
    card, each through its entry point, launches counted by run;
    ``checkpoints/`` byte for byte unchanged at the end."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer
    from tools import torch_train_mobilevit_cls as cls_tool
    from tools import torch_verify_reference_golden as golden

    t_phase = time.perf_counter()
    digests = checkpoint_digests()
    tok = CharTokenizer()
    bf16 = torch.bfloat16
    runs = {}

    # torch_generate_text: q8_0, 200 greedy bf16 steps (the scan path's qmatmul)
    ex = example_module("torch_generate_text")
    _, out, launches, sec = counted_run(tag, "examples/torch_generate_text.py (q8_0, bf16, 200 "
                                          "steps)", lambda: ex.main(CKPT, *EXAMPLE_PROMPTS))
    check(launches.get("qmatmul_q8_0", 0) > 0, f"{tag}: generate_text launched no qmatmul")
    params = load_gru_any(CKPT, qtype="q8_0", device=dev)
    want = ex.generate_texts(params, EXAMPLE_PROMPTS)
    check(out == "".join(t + "\n--------\n" for t in want),
          f"{tag}: generate_text's texts differ from the port's own generate: {out[:300]!r}")
    runs["torch_generate_text"] = dict(s=sec, launches=launches)

    # torch_serve_continuous: 32 slots x 16 inner steps, the fused tick
    ex = example_module("torch_serve_continuous")
    _, out, launches, sec = counted_run(tag, "examples/torch_serve_continuous.py (32 slots x 16)",
                                     lambda: ex.main(CKPT))
    check(launches.get("fused_slot_tick", 0) > 0, f"{tag}: serve_continuous took the scan tick")
    texts = out.split("\n--------\n")[:-1]
    prompts = [np.asarray(tok.encode(p), np.int32) for p in ex.PROMPTS]
    ids, lens = pad_batch(prompts, ex.MAX_PROMPT)
    offline = fused.fused_gru_decode(params, ids, lens, ex.MAX_PROMPT + ex.MAX_NEW_TOKENS,
                                     compute_dtype=bf16).cpu()
    check(len(texts) == len(prompts) and all(
        t == tok.decode(offline[i, :p.size + ex.MAX_NEW_TOKENS].tolist())
        for i, (t, p) in enumerate(zip(texts, prompts))),
        f"{tag}: serve_continuous's texts differ from the offline decode: {out[:300]!r}")
    log(f"[{tag}]   {out.splitlines()[-1]} | texts equal to the offline decode")
    runs["torch_serve_continuous"] = dict(s=sec, launches=launches)
    del params

    with tempfile.TemporaryDirectory() as tmp:
        # torch_train_and_export: train-gru's default f32 model on the Shakespeare split
        ex = example_module("torch_train_and_export")
        gru = os.path.join(tmp, "gru.bin")
        _, out, launches, sec = counted_run(
            tag, f"examples/torch_train_and_export.py shakespeare_train.txt, "
                 f"{EXAMPLE_EPOCHS} epochs (f32)",
            lambda: ex.main(SHAKE_TRAIN, gru, str(EXAMPLE_EPOCHS)))
        for name in ("fused_gru_train_fwd_f32", "fused_gru_train_bwd_f32",
                     "fused_gru_train_dwr_f32"):
            check(launches.get(name, 0) > 0, f"{tag}: train_and_export launched no {name}")
        loss = float(out.strip().splitlines()[-1].split()[2].rstrip(";"))
        check(math.isfinite(loss) and os.path.exists(gru + ".best.gxt"),
              f"{tag}: train_and_export: {out!r}")
        back = load_gru_params(gru, device=dev)
        gen = gru_textgen.generate(back, *pad_batch([np.asarray(tok.encode("ROMEO: "), np.int32)],
                                                    7), 64)
        check(gen.shape == (1, 64) and int(gen.max()) < 66, f"{tag}: exported gru.bin generates "
                                                            f"{gen.shape}")
        log(f"[{tag}]   {out.strip().splitlines()[-1]} | gru.bin read back: {tok.decode(gen[0].tolist())!r}")
        runs["torch_train_and_export"] = dict(s=sec, launches=launches, final_loss=loss)
        del back

        # torch_extract_features: q8_0 dense kernels, bf16 on the default routes
        ex = example_module("torch_extract_features")
        _, out, launches, sec = counted_run(tag, "examples/torch_extract_features.py "
                                              "mobilevit_synth_full.ggml (q8_0, bf16)",
                                         lambda: ex.main(VIT_CKPT))
        check(out.splitlines()[0] == "feature shape: (1, 8, 8, 640)",
              f"{tag}: extract_features printed {out!r}")
        for name in ("fused_transformer_layer", "fused_inverted_residual",
                     "inverted_residual_s2"):
            check(launches.get(name, 0) > 0, f"{tag}: extract_features launched no {name}")
        log(f"[{tag}]   {' | '.join(out.splitlines())}")
        runs["torch_extract_features"] = dict(s=sec, launches=launches)

        # torch_multichip: one process, a (1, 1) mesh
        ex = example_module("torch_multichip")
        _, out, launches, sec = counted_run(tag, "examples/torch_multichip.py (one rank)", ex.main)
        lines = out.splitlines()
        check(lines[0] == "1 devices, mesh {'data': 1, 'model': 1}"
              and math.isfinite(float(lines[2].split(": ")[1]))
              and lines[3] == "sharded decode: (8, 32)", f"{tag}: multichip printed {out!r}")
        log(f"[{tag}]   {' | '.join(lines)}")
        runs["torch_multichip"] = dict(s=sec, launches=launches)

        # one example as a command, in a process of its own
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "examples/torch_extract_features.py", VIT_CKPT],
                              cwd=REPO, capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
        check(proc.returncode == 0 and proc.stdout.startswith("feature shape: (1, 8, 8, 640)"),
              f"{tag}: examples/torch_extract_features.py as a command: rc {proc.returncode}\n"
              f"{proc.stdout[-500:]}{proc.stderr[-2000:]}")
        log(f"[{tag}] python3 examples/torch_extract_features.py as a command: "
            f"{time.perf_counter() - t0:.1f} s | {' | '.join(proc.stdout.splitlines())}")

        # the golden check's helper: card against CPU, f32 at 256 px
        named = read_named_tensors(VIT_CKPT)
        card, _, launches, sec = counted_run(
            tag, "tools/torch_verify_reference_golden.py features_from_named "
                 "(mobilevit_synth_full.ggml, 256 px, f16 convolutions, f32)",
            lambda: golden.features_from_named(named, device=dev))
        cpu = golden.features_from_named(named, device="cpu")
        rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        check(card.shape == cpu.shape == (8, 8, 640) and rel <= VIT_CPU_FEATURE_REL,
              f"{tag}: golden features on the card {card.shape}, {rel:.3g} of the largest "
              f"from the CPU's")
        log(f"[{tag}]   features {card.shape}, against the CPU's: max abs err {rel:.3g} of the "
            f"largest (limit {VIT_CPU_FEATURE_REL}) | first 5 {np.round(card[0, 0, :5], 5)}")
        runs["golden_helper"] = dict(s=sec, launches=launches, rel_err_vs_cpu=rel)
        del named

        # the classifier tool's report on the committed tiny and full checkpoints
        for full in (False, True):
            name = "mobilevit_synth_full.ggml" if full else "mobilevit_synth.ggml"
            argv = ["--eval-only"] + (["--full"] if full else [])
            rc, out, launches, sec = counted_run(
                tag, f"tools/torch_train_mobilevit_cls.py {' '.join(argv)} ({name})",
                lambda: cls_tool.main(argv))
            check(rc == 0, f"{tag}: tools/torch_train_mobilevit_cls.py {argv} returned {rc}")
            rep = json.loads(out[out.index("{"):])
            cls_report_checks(tag, name, rep)
            for k in ("transformer_ln_qkv_f32", "transformer_ln_qkv", "fused_inverted_residual"):
                check(launches.get(k, 0) > 0, f"{tag}: the report on {name} launched no {k}")
            log(f"[{tag}]   {json.dumps(rep)}")
            # the card's f32 argmax against the CPU's under the near-tie rule
            s = cls_tool.setting(full)
            x, _ = cls_tool.heldout(s, CLS_CPU_IMAGES[full])
            got = cls_tool.logits_of(load_mobilevit(cls_tool.COMMITTED[full], config=s["config"],
                                                    device=dev), x)
            want = cls_tool.logits_of(load_mobilevit(cls_tool.COMMITTED[full],
                                                     config=s["config"], device="cpu"), x)
            agree, flips = argmax_near_ties(f"{tag}: {name} f32 card vs cpu", torch.from_numpy(got),
                                            torch.from_numpy(want), NEAR_TIE["float32"])
            log(f"[{tag}]   f32 argmax of {len(x)} images against the CPU's: agreement "
                f"{agree:.4f} ({flips} flips, at near-ties)")
            runs[f"cls_report_{'full' if full else 'tiny'}"] = dict(s=sec, launches=launches,
                                                                    report=rep)

        # a short tiny training through the tool's train(), into a temporary path
        s = dict(cls_tool.setting(False), **CLS_TRAIN)
        path = os.path.join(tmp, "mobilevit_synth.ggml")
        msgs = []
        loss, _, launches, sec = counted_run(
            tag, f"tools/torch_train_mobilevit_cls.py train() tiny, {CLS_TRAIN}",
            lambda: cls_tool.train(s, path, device=dev, log=msgs.append))
        p = load_mobilevit(path, config=s["config"], device=dev)
        x, y = cls_tool.heldout(s, 100)
        top1 = float((cls_tool.logits_of(p, x).argmax(-1) == y).mean())
        check(math.isfinite(loss) and os.path.getsize(path) > 0,
              f"{tag}: the tiny training: loss {loss}")
        log(f"[{tag}]   {msgs[-1]} | {sec:.2f} s for the call (the data, "
            f"{CLS_TRAIN['steps']} steps from the seeded init, the write) | top-1 of 100 "
            f"held-out images {top1:.2f}")
        runs["cls_train_tiny"] = dict(s=sec, launches=launches, final_loss=loss)

    check(checkpoint_digests() == digests, f"{tag}: checkpoints/ changed")
    log(f"[{tag}] checkpoints/: {len(digests)} files byte for byte unchanged | phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"[{tag}] " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != 'report'}
                                  for k, v in runs.items()}))
    return runs


def request_key(prompt_ids, max_new):
    """A request's identity across an engine restore (queued requests are
    renumbered there, so ids do not carry over)."""
    return tuple(int(t) for t in prompt_ids), int(max_new)


# ---- phase 30: MobileViT-small above 384 px: attention past shared memory ----------------


def long_sequence_phase(tag, dev):
    """Phase 30: MobileViT-small at 512 px, where layer_3's sequences are
    L = 1024 tokens, past what a block's shared memory holds whole. First
    the three kernels that stream a head's keys (the bf16 layer attention,
    the f32 layer attention, flash attention) against their plain versions
    at L = 640 and 1024 on layer_3's widths and weights, bp = 512 (B = 128
    images): two launches bit-equal, the bf16 one within the layer's bf16
    limits (and its share of values bit-equal logged), the f32 ones within
    LAYER_F32_REL / VIT_F32_REL of the largest value; the streamed bf16 plan
    forced at L = 256 (the resident plan's longest) bit-equal to the
    resident plan there and the two timed in turns; each timed
    beside its plain version, ``scaled_dot_product_attention`` (the library
    column, f32 with TF32 off) and its bound (``attention_bound``: q.k^T
    twice where the keys are walked twice), the whole layer beside
    ``nn.TransformerEncoderLayer``. Then the main path through the entry
    points on ``mobilevit_synth_full.ggml`` at 512 px: ``classify`` of
    LONG_IMAGES held-out images in batches of VIT_BATCH at bf16 and f32 on
    the default routes and at f32 with the fused layer off (flash), launch
    counts zeroed before each run and read after it (layer_3's two layers a
    batch stream the keys); the bf16 argmax against f32 under the near-tie
    rule; the f32 features of LONG_CPU_IMAGES images against the CPU's
    within VIT_CPU_FEATURE_REL; ``extract_features`` at B = VIT_BATCH at
    both dtypes timed, with its device time by kernel from
    ``tools/torch_trace_report.py --image-size 512``; the ``features`` and
    ``classify`` commands at ``--image-size 512``. Returns the kernels-line
    entries of the three streamed kernels."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.nn.functional as F

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl
    from ggml_experiments_tpu_torch.training.image_task import (
        FULL_AMP_FACTOR,
        HELDOUT_SEED,
        make_dataset,
    )
    from ggml_experiments_tpu_torch.utils.observability import attention_bound

    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(30)
    p = load_mobilevit(VIT_CKPT, device=dev)
    p_flash = load_mobilevit(VIT_CKPT, device=dev, fused_layer=False)
    layer = p.layer_3.transformer[0]
    c, h = layer.attention.wq.shape[0], layer.attention.num_heads
    f = layer.intermediate_kernel.shape[-1]
    bp = VIT_BATCH * p.layer_3.patch_size ** 2
    ops16, ops32 = ftl.layer_operands(layer, c, bf16), ftl.layer_operands(layer, c, f32)
    names = {"transformer_attention": "transformer_attention_512px",
             "transformer_attention_f32": "transformer_attention_f32_512px",
             "flash_mha": "flash_mha_512px"}
    out = {n: dict(max_abs_err=0.0, shapes={}) for n in names.values()}

    def heads(q, k, v):
        return [t.reshape(bp, -1, h, c // h).transpose(1, 2).contiguous() for t in (q, k, v)]

    def qkv_heads(qkv, l):
        t = qkv.reshape(bp, l, 3, h, ftl.head_pad(c // h))[..., :c // h]
        return [t[:, :, j].transpose(1, 2).contiguous() for j in range(3)]

    def record(name, l, err, ms, plain_ms, lib_ms, dtype, passes, extra=""):
        b_ms, b_by, _ = attention_bound(bp, l, c, h, dtype, passes=passes)
        e = out[name]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["shapes"][f"L={l}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                     bound_by=b_by, max_abs_err=err)
        if l == 1024:
            e.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[{tag}] {name[:-6]} (bp, L, C, H) = ({bp}, {l}, {c}, {h}): max abs err {err:.3g}"
            f"{extra} | kernel {ms:.4f} ms = {100 * b_ms / ms:.1f}% of its bound {b_ms:.4f} ms "
            f"({b_by}) | plain {plain_ms:.3f} ms | scaled_dot_product_attention {lib_ms:.4f} ms")

    for l in LONG_KERNEL_L:
        x2 = torch.randn((bp * l, c), generator=g, device=dev)
        # the bf16 layer attention: the streamed plan past 256 keys
        qkv = ftl.ln_qkv_plain(x2.to(bf16), ops16)
        check(ftl.attention_plan(l) == "streamed", f"{tag}: L={l} does not stream at bf16")
        got, again = ftl.attention_cuda(qkv, l, ops16), ftl.attention_cuda(qkv, l, ops16)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{tag}: bf16 attention L={l}: two launches differ")
        want = ftl.attention_plain(qkv, l, ops16)
        err16 = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        same = float((got == want).float().mean())
        check(bool(torch.isfinite(got.float()).all()) and err16 <= VIT_BF16_MAX["layer"] * scale,
              f"{tag}: bf16 attention L={l}: max abs err {err16:.3g} (limit "
              f"{VIT_BF16_MAX['layer']} x {scale:.3g})")
        del got, again, want
        ms = cuda_ms(lambda: ftl.attention_cuda(qkv, l, ops16), n=10)
        plain_ms = cuda_ms(lambda: ftl.attention_plain(qkv, l, ops16), n=2, warmup=1)
        hd = qkv_heads(qkv, l)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*hd, scale=1.0), n=10)
        record(names["transformer_attention"], l, err16, ms, plain_ms, lib_ms, "bfloat16", 2,
               f" (largest {scale:.3g}; {100 * same:.3f}% of the values bit-equal), two launches "
               f"bit-equal")
        del qkv, hd
        # the f32 layer attention: windows of 256 keys with a running max
        qkv = ftl.ln_qkv_plain(x2, ops32)
        got, again = ftl.attention_cuda(qkv, l, ops32), ftl.attention_cuda(qkv, l, ops32)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{tag}: f32 attention L={l}: two launches differ")
        want = ftl.attention_plain(qkv, l, ops32)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= LAYER_F32_REL * scale,
              f"{tag}: f32 attention L={l}: max abs err {err:.3g} (limit {LAYER_F32_REL} x "
              f"{scale:.3g})")
        del got, again, want
        ms = cuda_ms(lambda: ftl.attention_cuda(qkv, l, ops32), n=10)
        plain_ms = cuda_ms(lambda: ftl.attention_plain(qkv, l, ops32), n=2, warmup=1)
        hd = qkv_heads(qkv, l)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*hd, scale=1.0), n=5)
        record(names["transformer_attention_f32"], l, err, ms, plain_ms, lib_ms, "float32", 1,
               f" ({err / scale:.3g} of the largest, limit {LAYER_F32_REL}), two launches "
               f"bit-equal")
        del qkv, hd, x2
        # flash at f32 (the main path with the fused layer off) and bf16
        q, k, v = (torch.randn((bp, l, c), generator=g, device=dev) for _ in range(3))
        got, again = fa.flash_mha_cuda(q, k, v, h), fa.flash_mha_cuda(q, k, v, h)
        q16 = [t.to(bf16) for t in (q, k, v)]
        g16, a16 = fa.flash_mha_cuda(*q16, h), fa.flash_mha_cuda(*q16, h)
        torch.cuda.synchronize()
        check(torch.equal(got, again) and torch.equal(g16, a16),
              f"{tag}: flash L={l}: two launches differ")
        want = fa.flash_mha_plain(q, k, v, h)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= VIT_F32_REL * scale, f"{tag}: flash f32 L={l}: max rel err "
                                          f"{err / scale:.3g} > {VIT_F32_REL}")
        del got, again, want
        w16 = fa.flash_mha_plain(*q16, h)
        e16 = float((g16.float() - w16.float()).abs().max())
        s16 = float(w16.float().abs().max())
        check(e16 <= VIT_BF16_MAX["flash"] * s16, f"{tag}: flash bf16 L={l}: max abs err "
                                                  f"{e16:.3g} (limit {VIT_BF16_MAX['flash']} x "
                                                  f"{s16:.3g})")
        same16 = float((g16 == w16).float().mean())
        del g16, a16, w16
        ms = cuda_ms(lambda: fa.flash_mha_cuda(q, k, v, h), n=5)
        ms16 = cuda_ms(lambda: fa.flash_mha_cuda(*q16, h), n=5)
        plain_ms = cuda_ms(lambda: fa.flash_mha_plain(q, k, v, h), n=2, warmup=1)
        hd = heads(q, k, v)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*hd), n=5)
        record(names["flash_mha"], l, err, ms, plain_ms, lib_ms, "float32", 1,
               f" f32 ({err / scale:.3g} of the largest, limit {VIT_F32_REL}), bf16 {e16:.3g} "
               f"({100 * same16:.3f}% bit-equal; kernel {ms16:.4f} ms), two launches bit-equal")
        del q, k, v, q16, hd
        torch.cuda.empty_cache()
    # the streamed plan forced where the resident one runs: the same bits,
    # and the two timed in turns (resident, streamed, streamed, resident)
    turns = []
    for l in (256,):
        x2 = torch.randn((bp * l, c), generator=g, device=dev).to(bf16)
        qkv = ftl.ln_qkv_plain(x2, ops16)
        st = ftl.attention_cuda(qkv, l, ops16, _plan="streamed")
        res = ftl.attention_cuda(qkv, l, ops16, _plan="resident")
        check(torch.equal(st, res), f"{tag}: L={l}: the streamed plan's bits differ from the "
                                    f"resident plan's")
        ms = [cuda_ms(lambda: ftl.attention_cuda(qkv, l, ops16, _plan=plan), n=10)
              for plan in ("resident", "streamed", "streamed", "resident")]
        turns.append(f"L={l} resident {ms[0]:.4f} / {ms[3]:.4f} ms, streamed {ms[1]:.4f} / "
                     f"{ms[2]:.4f} ms")
        del x2, qkv, st, res
    log(f"[{tag}] bf16 attention plans, bit-equal, in turns at bp = {bp}: " + " | ".join(turns))
    # the whole layer at L = 1024 beside nn.TransformerEncoderLayer
    parts = []
    for cd, ops in ((bf16, ops16), (f32, ops32)):
        x3 = torch.randn((bp, 1024, c), generator=g, device=dev).to(cd)
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True, device=dev,
                                               dtype=cd).eval()
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: lib(x3), n=5)
        ms = cuda_ms(lambda: ftl.fused_layer_cuda(x3, ops), n=5)
        parts.append(f"{cd} {ms:.4f} ms (nn.TransformerEncoderLayer {lib_ms:.4f} ms)")
        del x3, lib
    log(f"[{tag}] the fused layer at (bp, L, C) = ({bp}, 1024, {c}): " + " | ".join(parts))
    torch.cuda.empty_cache()

    # the main path: 512 px through the entry points
    images, labels = make_dataset(LONG_IMAGES, seed=HELDOUT_SEED, image_size=512,
                                  amp_factor=FULL_AMP_FACTOR)
    x_all = torch.from_numpy(images)
    nb = -(-LONG_IMAGES // VIT_BATCH)
    logits = {}
    streamed = {"bf16": ("transformer_attention_streamed", "transformer_attention"),
                "f32": ("transformer_attention_f32_streamed", "transformer_attention_f32"),
                "f32 flash": ("flash_mha_streamed", "flash_mha")}
    for name, params, cd in (("bf16", p, bf16), ("f32", p, f32), ("f32 flash", p_flash, f32)):
        port.reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lo = torch.cat([classify(params, x_all[i:i + VIT_BATCH].to(dev), compute_dtype=cd)
                        for i in range(0, LONG_IMAGES, VIT_BATCH)])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = port.kernel_launches()
        key, total = streamed[name]
        check(lo.shape == (LONG_IMAGES, 44) and bool(torch.isfinite(lo).all()),
              f"{tag}: classify {name} at 512 px: shape {tuple(lo.shape)} or values")
        check(launches[key] == 2 * nb and launches[total] == 9 * nb,
              f"{tag}: classify {name} at 512 px launched {launches[key]} {key} and "
              f"{launches[total]} {total}, want 2 and 9 a batch x {nb}")
        out[names[total]]["launches"] = launches[key]
        logits[name] = lo.cpu()
        top1 = float((lo.argmax(-1).cpu().numpy() == labels).mean())
        log(f"[{tag}] classify {name} at 512 px, {LONG_IMAGES} held-out images in {nb} batches "
            f"({sec:.2f} s): top-1 {top1:.4f} | {key} {launches[key]}, {total} {launches[total]}")
    agree, flips = argmax_near_ties(f"{tag}: bf16 vs f32 at 512 px", logits["bf16"],
                                    logits["f32"], VIT_NEAR_TIE, tie_dtype=bf16)
    agree32, flips32 = argmax_near_ties(f"{tag}: f32 default vs f32 flash at 512 px",
                                        logits["f32"], logits["f32 flash"], NEAR_TIE["float32"],
                                        tie_dtype=f32)
    log(f"[{tag}] argmax agreement at 512 px: bf16 with f32 {agree:.4f} ({flips} flips, at "
        f"near-ties); f32 default with f32 flash {agree32:.4f} ({flips32} flips)")
    # the card's f32 features against the CPU's
    n = LONG_CPU_IMAGES
    p_cpu = load_mobilevit(VIT_CKPT, device="cpu")
    t0 = time.perf_counter()
    want = extract_features(p_cpu, x_all[:n])
    cpu_s = time.perf_counter() - t0
    got = extract_features(p, x_all[:n].to(dev)).cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    check(got.shape == (n, 16, 16, 640) and err <= VIT_CPU_FEATURE_REL * scale,
          f"{tag}: f32 features at 512 px vs the CPU: max abs err {err:.3g} (limit "
          f"{VIT_CPU_FEATURE_REL} x {scale:.3g})")
    log(f"[{tag}] f32 features of {n} images at 512 px, card (default route) vs the plain CPU "
        f"run ({cpu_s:.1f} s): max abs err {err:.3g}, {err / scale:.3g} of the largest (limit "
        f"{VIT_CPU_FEATURE_REL})")
    del p_cpu, want, got
    # extract_features at B = VIT_BATCH timed, and its device time by kernel
    # from tools/torch_trace_report.py in a process of its own (a process that
    # has run the profiler before loses some of a later trace's kernels)
    xb = x_all[:VIT_BATCH].to(dev)
    for name, cd in (("bf16", bf16), ("f32", f32)):
        ms = cuda_ms(lambda: extract_features(p, xb, compute_dtype=cd), n=5)
        rows, _ = trace_report_rows(["--model", "mobilevit", "--batch", str(VIT_BATCH),
                                     "--image-size", "512", "--qtype", "none", "--compute",
                                     str(cd).split(".")[1], "--reps", "2", "--top", "200"])
        busy = sum(us for us, _, _ in rows) / 1e3
        byname = {n: us / 1e3 for us, _, n in rows}
        mine = {k: v for k, v in byname.items() if k in port.kernel_launches()}
        log(f"[{tag}] extract_features B={VIT_BATCH} at 512 px, {name}: {ms:.3f} ms = "
            f"{VIT_BATCH / ms * 1e3:,.0f} images/s | the trace (random weights, a process of its "
            f"own): device busy {busy:.3f} ms a forward (idle share "
            f"{max(0.0, 1 - busy / ms):.3f} of the timed forward): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(mine.items(), key=lambda kv: -kv[1]))
            + f", the rest {busy - sum(mine.values()):.3f} ms")
    del xb, x_all, images
    # the commands at --image-size 512
    for cmd in ("features", "classify"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([cmd, "--weights", VIT_CKPT, "--image-size", "512"])
        lines = buf.getvalue().splitlines()
        ok = (lines[0] == "output feature shape: : Dims: (16, 16, 640)" if cmd == "features"
              else lines[0].startswith("class "))
        check(rc == 0 and ok, f"{tag}: {cmd} --image-size 512 printed {lines}")
        log(f"[{tag}] {cmd} --weights mobilevit_synth_full.ggml --image-size 512: {lines[0]}")
    log(f"[{tag}] phase 30 in {time.perf_counter() - t_phase:.1f} s")
    del p, p_flash
    torch.cuda.empty_cache()
    return out


# ---- phase 31: the persistent kernel at vocabularies past 256 and units off 32 --------


def wide_gru_params(v, u, qtype="q8_0", e=256, seed=0):
    """A GRU of the reference's E at vocabulary V and U units, random weights
    made from ``seed`` (the trained checkpoint's scales), on the card."""
    import numpy as np

    from ggml_experiments_tpu_torch.convert import params_from_numpy

    rng = np.random.default_rng(seed)
    a = {"embeddings": rng.normal(0, 0.5, (v, e)), "kernel": rng.normal(0, e ** -0.5, (e, 3 * u)),
         "recurrent_kernel": rng.normal(0, u ** -0.5, (u, 3 * u)),
         "bias": rng.normal(0, 0.1, (2, 3 * u)),
         "dense_kernel": rng.normal(0, 3 * u ** -0.5, (u, v)), "dense_bias": rng.normal(0, 0.1, (v,))}
    return params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype=qtype,
                             device="cuda")


def gru_loop_bound(wf, b, t, nbytes_io):
    """The persistent loop's least time: the table's and the steps'
    operations against the weights and the call's inputs and outputs."""
    v, e, u = wf.v, wf.e, wf.u
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    ops = 2 * v * e * 3 * u + 2 * b * t * (3 * u * u + u * v)
    return bound(weight_bytes + nbytes_io, ops, "bfloat16")


def wide_decode_cell(tag, name, params, B, T, cd, want_decomp, rng):
    """``decode()`` at (B, T) and ``cd`` on params past the kernel's old
    limits: one launch on the plan ``decode_plan`` gives (its decomposition
    ``want_decomp``), tokens against the plain version under the near-tie
    rule, the kernel teacher-forced over WIDE_TF_STEPS against its plain
    version (tokens equal, h within 1e-4 at f32, TF_BF16_H_MAX at bf16), two
    launches bit-equal, each timed. Returns the kernels-line entry."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    dev = params.device
    cdn = cdname(cd)
    wf = fused._prep_weights(params)
    v, u = wf.v, wf.u
    lens = rng.integers(1, 17, B).astype(np.int32)
    ids = np.zeros((B, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, v, n)
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    port.reset_kernel_launches()
    toks = gru_textgen.decode(params, ids_t, lens_t, T, compute_dtype=cd)
    torch.cuda.synchronize()
    launches = port.kernel_launches()["fused_gru_decode"]
    plan = fused.LAST_PLAN.get("fused_gru_decode")
    check(launches == 1 and plan.decomp == want_decomp,
          f"{tag}: {name} took {launches} launches, plan {plan} (want one, {want_decomp}-owned)")
    check(toks.dtype == torch.int32 and toks.shape == (B, T) and int(toks.max()) < v,
          f"{tag}: {name} output dtype/shape/range")
    ms = cuda_ms(lambda: fused.fused_gru_decode(params, ids_t, lens_t, T, compute_dtype=cd),
                 n=3, warmup=1)
    again = fused.fused_gru_decode(params, ids_t, lens_t, T, compute_dtype=cd)
    check(torch.equal(toks, again), f"{tag}: {name}: two launches differ")
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.full((B,), T, dtype=torch.int32, device=dev)
    prompt = torch.nn.functional.pad(ids_t, (0, T - 16))
    h0 = torch.zeros(B, u, device=dev)
    plain_ms = cuda_ms(lambda: fused.gru_loop_reference(wf, prompt, lens_t, tb, z, z, h0, T, cd),
                       n=1, warmup=0)
    want, _, _, _, gaps = fused.gru_loop_reference(wf, prompt, lens_t, tb, z, z, h0, T, cd,
                                                   margins=True)
    agree, forked = first_divergence_near_ties(toks, want, gaps, NEAR_TIE[cdn],
                                               f"{tag}: {name}")
    tf_ids = torch.from_numpy(rng.integers(0, v, (B, WIDE_TF_STEPS)).astype(np.int32)).to(dev)
    tl = torch.full((B,), WIDE_TF_STEPS, dtype=torch.int32, device=dev)
    toks_k, h_k = fused.fused_gru_decode(params, tf_ids, tl, WIDE_TF_STEPS, compute_dtype=cd,
                                         return_state=True)
    toks_p, h_p, _, _ = fused.gru_loop_reference(wf, tf_ids, tl, tl, z, z, h0, WIDE_TF_STEPS, cd)
    err = float((h_k - h_p).abs().max())
    lim = 1e-4 if cd == torch.float32 else TF_BF16_H_MAX
    check(torch.equal(toks_k, toks_p) and err <= lim,
          f"{tag}: {name} teacher-forced: tokens equal {torch.equal(toks_k, toks_p)}, h err "
          f"{err:.3g} (limit {lim})")
    b_ms, b_by = gru_loop_bound(wf, B, T, ids.nbytes + lens.nbytes + B * T * 4)
    log(f"[{tag}] {name}: decode() B={B} T={T} {cdn} at (V, U) = ({v}, {u}), {wf.mode}: "
        f"launches {launches}, plan {plan} | kernel {ms:.2f} ms = {ms * 1e3 / T:.1f} us/step, "
        f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}) | two launches bit-equal | "
        f"tokens vs the plain version: agreement {agree:.6f}, {forked} rows fork (all at "
        f"near-ties) | teacher-forced T={WIDE_TF_STEPS}: tokens equal, h max abs err {err:.3g}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, plan=str(plan))


def wide_engine_cell(tag, name, params, n_slots, inner, sampled, rng):
    """A ``DecodeEngine`` of ``n_slots`` x ``inner`` at bf16 on its default
    route (the fused tick: the route asks the kernel's plan), greedy (each
    request equal to the offline decode) or sampled (temperature 0.8, top-k
    20, top-p 0.9), its tick launches counted; then one tick of the same
    rule through the kernel and its plain version from one state, under the
    near-tie rule, two launches bit-equal, each timed. Returns the
    kernels-line entry."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.engine import init_state

    dev = params.device
    bf16 = torch.bfloat16
    wf = fused._prep_weights(params)
    v, u = wf.v, wf.u
    rule = dict(temperature=0.8, top_k=20, top_p=0.9) if sampled else {}
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=16, inner_steps=inner,
                       compute_dtype=bf16, seed=1, **rule)
    check(eng.use_fused_tick, f"{tag}: {name}: the engine took the scan tick")
    prompts = [rng.integers(0, v, int(n)).astype(np.int32) for n in rng.integers(1, 17, n_slots)]
    new = [int(x) for x in rng.integers(inner, 2 * inner, n_slots)]
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, nt) for p, nt in zip(prompts, new)]
    eng.run_until_idle(timeout_s=300)
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    launches = port.kernel_launches()["fused_slot_tick"]
    check(launches > 0, f"{tag}: {name}: no tick launch")
    res = [r.result(timeout=0) for r in reqs]
    check(all(len(x) == p.size + nt and int(x.max()) < v for x, p, nt in zip(res, prompts, new)),
          f"{tag}: {name}: request output length/range")
    if not sampled:
        ids, lens = pad_batch(prompts, 16)
        offline = fused.fused_gru_decode(params, ids, lens, 16 + 2 * inner,
                                         compute_dtype=bf16).cpu()
        for i, (x, p, nt) in enumerate(zip(res, prompts, new)):
            check(np.array_equal(x, offline[i, :p.size + nt].numpy()),
                  f"{tag}: {name}: request {i} differs from the offline decode")
    st = init_state(params, n_slots, 16)
    ids, lens = pad_batch(prompts, 16)
    st.prompt, st.plen = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    st.total = st.plen + inner
    st.temp = torch.full((n_slots,), 0.8 if sampled else 0.0, device=dev)
    kw = dict(enable_sampling=sampled, seed=12345, top_k=20 if sampled else None,
              top_p=0.9 if sampled else None)
    s_k, t_k = fused.fused_slot_tick(params, st, inner, compute_dtype=bf16, **kw)
    again = fused.fused_slot_tick(params, st, inner, compute_dtype=bf16, **kw)
    check(torch.equal(t_k, again[1]) and torch.equal(s_k.h, again[0].h),
          f"{tag}: {name}: two tick launches differ")
    check(t_k.dtype == torch.int32, f"{tag}: {name}: tokens {t_k.dtype}, want int32 past V=255")
    ref_kw = dict(temp=st.temp, seed=12345, top_k=20, top_p=0.9) if sampled else {}
    t_p, _, _, pos_p, gaps = fused.gru_loop_reference(
        wf, st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner, bf16, margins=True,
        **ref_kw)
    check(torch.equal(s_k.pos, pos_p), f"{tag}: {name}: cursors differ")
    agree, forked = first_divergence_near_ties(t_k, t_p, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: {name} tick")
    ms = cuda_ms(lambda: fused.fused_slot_tick(params, st, inner, compute_dtype=bf16, **kw), n=3,
                 warmup=1)
    plain_ms = cuda_ms(lambda: fused.gru_loop_reference(
        wf, st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner, bf16, **ref_kw),
        n=1, warmup=0)
    tf_st = init_state(params, n_slots, WIDE_TF_STEPS)
    tf_st.prompt = torch.from_numpy(rng.integers(0, v, (n_slots, WIDE_TF_STEPS)).astype(
        np.int32)).to(dev)
    tf_st.plen = torch.full((n_slots,), WIDE_TF_STEPS, dtype=torch.int32, device=dev)
    tf_st.total = tf_st.plen.clone()
    s_tf, t_tf = fused.fused_slot_tick(params, tf_st, WIDE_TF_STEPS, compute_dtype=bf16)
    t_tp, h_tp, *_ = fused.gru_loop_reference(wf, tf_st.prompt, tf_st.plen, tf_st.total,
                                              tf_st.prev, tf_st.pos, tf_st.h, WIDE_TF_STEPS, bf16)
    err = float((s_tf.h - h_tp).abs().max())
    check(torch.equal(t_tf, t_tp) and err <= TF_BF16_H_MAX,
          f"{tag}: {name} teacher-forced tick: h err {err:.3g}")
    b_ms, b_by = gru_loop_bound(wf, n_slots, inner, ids.nbytes + n_slots * (4 * 4 + 4 * u)
                                + n_slots * (4 * 2 + 4 * u) + n_slots * inner * 4)
    log(f"[{tag}] {name}: engine {n_slots} x {inner} bf16 at (V, U) = ({v}, {u}), "
        f"{'sampled (0.8, top-k 20, top-p 0.9)' if sampled else 'greedy'}: {len(reqs)} requests "
        f"in {eng_s:.2f} s{'' if sampled else ', each equal to the offline decode'}, tick "
        f"launches {launches}, plan {fused.LAST_PLAN.get('fused_slot_tick')} | one tick: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), int32 tokens, "
        f"agreement {agree:.6f} ({forked} rows fork, at near-ties), two launches bit-equal | "
        f"teacher-forced T={WIDE_TF_STEPS}: h max abs err {err:.3g}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                plan=str(fused.LAST_PLAN.get("fused_slot_tick")))


def wide_corpus(seed, n_chars, n_distinct):
    """A text of ``n_chars`` characters over ``n_distinct`` distinct CJK code
    points (U+4E00 on), each at least once, the rest drawn Zipf-like: a
    corpus whose vocabulary is past what the kernel held before."""
    import numpy as np

    rng = np.random.default_rng(seed)
    points = 0x4E00 + rng.permutation(20000)[:n_distinct]
    weights = 1.0 / np.arange(1, n_distinct + 1)
    draws = rng.choice(n_distinct, n_chars - n_distinct, p=weights / weights.sum())
    order = np.concatenate([np.arange(n_distinct), draws])
    rng.shuffle(order)
    return "".join(chr(int(points[i])) for i in order)


def wide_gru_phase(tag, dev):
    """Phase 31: the persistent kernel past its old limits, at the reference
    width (E = 256) with random weights made from a seed. V = 5000:
    ``decode()`` on each plan (slot-owned bf16 at B = 4096, unit-owned bf16
    at 1024, unit-owned f32 at 256) and a 512 x 128 engine greedy and
    sampled; V = 257 on the slot-owned plan (two vocabulary tiles, the
    logits scratch, the walk in memory); U = 1000 (padded to 1024) on the
    unit-owned plan; U = 2048 on the scan path with no launch. Then
    ``train-gru`` and ``generate`` on a corpus of WIDE_VOCAB distinct
    characters made from a seed, and the same corpus's own vocabulary
    trained through the API, quantized, decoded through the kernel. Last
    the bf16 vision shapes past their kernels' plans on the unfused
    chain. Returns the kernels-line entries."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params, save_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.training import TrainConfig, train
    from ggml_experiments_tpu_torch.training.data import DataConfig, batches, make_examples
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(31)
    out = {}
    p5k = wide_gru_params(5000, 1024)
    for name, (b, t, cd, decomp) in WIDE_DECODE.items():
        out[f"fused_gru_decode_v5000{name}"] = wide_decode_cell(
            tag, f"V=5000{name}", p5k, b, t, getattr(torch, cd), decomp, rng)
    n_slots, inner = ENGINE_SHAPE
    out["fused_slot_tick_v5000"] = wide_engine_cell(tag, "V=5000 greedy", p5k, n_slots, inner,
                                                    False, rng)
    out["fused_slot_tick_v5000_sampled"] = wide_engine_cell(tag, "V=5000 sampled", p5k, n_slots,
                                                            inner, True, rng)
    del p5k
    out["fused_gru_decode_v257"] = wide_decode_cell(tag, "V=257", wide_gru_params(257, 1024),
                                                    4096, 64, bf16, "slot", rng)
    out["fused_gru_decode_u1000"] = wide_decode_cell(tag, "U=1000", wide_gru_params(66, 1000),
                                                     1024, 64, bf16, "unit", rng)
    # U = 2048: no plan holds it; decode() and the engine keep the scan path
    p2k = wide_gru_params(66, 2048)
    ids = torch.from_numpy(rng.integers(0, 66, (64, 8)).astype(np.int32)).to(dev)
    lens = torch.full((64,), 8, dtype=torch.int32, device=dev)
    why = fused.loop_refusal(64, 2048, 66, bf16, *fused.device_limits(dev))
    port.reset_kernel_launches()
    got = gru_textgen.decode(p2k, ids, lens, 64)
    eng = DecodeEngine(p2k, n_slots=16, inner_steps=16, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = port.kernel_launches()
    check(why and launches["fused_gru_decode"] == 0 and launches["qmatmul_q8_0"] > 0
          and not eng.use_fused_tick, f"{tag}: U=2048 took the kernel: {launches}")
    check(torch.equal(got, gru_textgen.generate(p2k, ids, lens, 64, compute_dtype=bf16)),
          f"{tag}: U=2048 decode() differs from generate()")
    log(f"[{tag}] U=2048: decode() B=64 T=64 on the scan path ({launches['qmatmul_q8_0']} "
        f"qmatmul launches, no persistent-kernel launch; equal to generate()), the engine's "
        f"default tick the scan tick: the kernel's reason: {why}")
    del p2k, eng

    # a corpus of ~5,000 distinct characters: train-gru and generate through the CLI
    # (its tokenizer is the 66-character Shakespeare one, in both packages, so
    # unknown characters train as id 0), then the corpus's own vocabulary
    # through the API, quantized and decoded on the persistent kernel
    text = wide_corpus(31, WIDE_CORPUS_CHARS, WIDE_VOCAB)
    with tempfile.TemporaryDirectory() as tmp:
        path, bin_ = os.path.join(tmp, "corpus.txt"), os.path.join(tmp, "gru.bin")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        t0 = time.perf_counter()
        check(cli.main(["train-gru", "--corpus", path, "--epochs", "1", "--log-every", "1",
                        "--output", bin_]) == 0, f"{tag}: train-gru failed")
        check(cli.main(["generate", "--weights", bin_, "--prompt", text[:8], "--steps", "32",
                        "--qtype", "q8_0"]) == 0, f"{tag}: generate failed")
        cli_s = time.perf_counter() - t0
        tok = CharTokenizer.from_corpus(text)
        v = tok.vocab_size
        check(v == WIDE_VOCAB + 2, f"{tag}: the corpus has {v - 2} distinct characters")
        dcfg = DataConfig(seq_length=100, batch_size=64)
        params = gru_textgen.init_params(gru_textgen.GRUConfig(vocab_size=v),
                                         torch.Generator().manual_seed(0), device=dev)
        t0 = time.perf_counter()
        params, hist = train(params, batches(make_examples(text, tok, dcfg), dcfg, seed=0),
                             TrainConfig(epochs=1, log_every=1), device=dev)
        train_s = time.perf_counter() - t0
        check(len(hist) >= 1 and all(math.isfinite(h["loss"]) for h in hist),
              f"{tag}: training at V={v}: {hist}")
        save_gru_params(bin_, params)
        q = load_gru_params(bin_, qtype="q8_0", device=dev)
    ids, lens = tok.encode_batch([text[i * 97:i * 97 + 12] for i in range(64)])
    port.reset_kernel_launches()
    toks = gru_textgen.decode(q, ids, lens, 64)
    torch.cuda.synchronize()
    n = port.kernel_launches()["fused_gru_decode"]
    check(n == 1 and toks.shape == (64, 64) and int(toks.max()) < v,
          f"{tag}: decode() of the trained V={v} model: {n} launches")
    wf = fused._prep_weights(q)
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    want, _, _, _, gaps = fused.gru_loop_reference(
        wf, torch.nn.functional.pad(ids_t, (0, 52)), lens_t,
        torch.full((64,), 64, dtype=torch.int32, device=dev), z, z, torch.zeros(64, 1024, device=dev),
        64, bf16, margins=True)
    agree, forked = first_divergence_near_ties(toks, want, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: trained V={v} decode()")
    sampled = gru_textgen.generate(q, ids, lens, 64, temperature=0.8, top_k=20, top_p=0.9,
                                   generator=torch.Generator(device=dev).manual_seed(0))
    check(int(sampled.max()) < v, f"{tag}: sampled generate() past the vocabulary")
    log(f"[{tag}] corpus of {len(text):,} characters, {WIDE_VOCAB} distinct: train-gru (1 epoch, "
        f"the CLI's 66-character vocabulary) and generate in {cli_s:.1f} s | the corpus's own "
        f"vocabulary (V={v}) through train(): {len(hist)} steps in {train_s:.1f} s, loss "
        f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; quantized q8_0, decode() B=64 T=64 "
        f"bf16: {n} launch, plan {fused.LAST_PLAN.get('fused_gru_decode')}, tokens vs the "
        f"plain version: agreement {agree:.6f}, {forked} rows fork (at near-ties); sampled "
        f"generate(): {tok.decode(sampled[0, 12:40].tolist())!r}")
    del q, params
    torch.cuda.empty_cache()
    wide_vision_check(tag, dev)
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= WIDE_PHASE_BUDGET_S, f"{tag}: {phase_s:.1f} s, past its budget of "
                                          f"{WIDE_PHASE_BUDGET_S} s")
    log(f"[{tag}] phase time {phase_s:.1f} s (budget {WIDE_PHASE_BUDGET_S} s)")
    return out


def wide_vision_check(tag, dev):
    """The bf16 vision shapes past their kernels' plans: a stride-1 block at
    C = 1600, layers at C = 1280 and at heads of 80, flash attention at
    heads of 80. On the card the routes say no before any launch, none of
    their kernels launches, and the unfused chain meets the CPU's output
    (the JAX model's route there) within VIT_BF16_MAX of the largest
    value. The unfused C = 1280 layer's attention (heads of 64) takes flash
    attention: its one launch."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl
    from ggml_experiments_tpu_torch.ops.attention import AttentionParams, multi_head_attention
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    def twins(build):
        made = []
        for d in (dev, torch.device("cpu")):
            rng = np.random.default_rng(17)

            def t(*s, off=0.0, d=d, rng=rng):
                return torch.from_numpy((rng.standard_normal(s) * 0.1 + off).astype(
                    np.float32)).to(d)
            made.append(build(t))
        return made

    def block(t):
        def conv(cin, co, kh=1, dw=False, act="silu"):
            return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co, off=1.0), t(co)),
                             activation=act, depthwise=dw)
        return tmv.InvertedResidualParams(expand_1x1=conv(1600, 64), conv_3x3=conv(1, 64, 3, True),
                                          reduce_1x1=conv(64, 64, act="none"), fused=True)

    def layer(c, h):
        def build(t):
            return tmv.TransformerLayerParams(
                attention=AttentionParams(wq=t(c, c), bq=t(c), wk=t(c, c), bk=t(c), wv=t(c, c),
                                          bv=t(c), wo=t(c, c), bo=t(c), num_heads=h, flash=True),
                ln_before_gamma=t(c, off=1.0), ln_before_beta=t(c), ln_after_gamma=t(c, off=1.0),
                ln_after_beta=t(c), intermediate_kernel=t(c, 2 * c), intermediate_bias=t(2 * c),
                output_kernel=t(2 * c, c), output_bias=t(c), fused=True)
        return build

    def close(what, got, want):
        err, scale = float((got.float() - want.float()).abs().max()), float(want.abs().max())
        check(err <= VIT_BF16_MAX["layer"] * scale,
              f"{tag}: {what}: max err {err:.3g} of {scale:.3g}")
        return err / scale

    bf = torch.bfloat16
    before = (dict(fir.LAUNCHES), dict(ftl.LAUNCHES), dict(fa.LAUNCHES))
    rel = {}
    card, cpu = twins(block)
    x = torch.randn((2, 12, 10, 1600), generator=torch.Generator().manual_seed(1))
    check(not card.fused_route(bf, dev, (12, 10)), f"{tag}: the C=1600 block took a kernel")
    rel["block C=1600"] = close("block C=1600", card(x.to(dev), compute_dtype=bf).cpu(),
                                cpu(x, compute_dtype=bf))
    for c, h in ((1280, 20), (160, 2)):
        card, cpu = twins(layer(c, h))
        x = torch.randn((3, 16, c), generator=torch.Generator().manual_seed(c))
        check(not card.fused_route(bf, dev, 16), f"{tag}: the layer at C={c}, H={h} took a kernel")
        rel[f"layer C={c} H={h}"] = close(f"layer C={c}", card(x.to(dev), compute_dtype=bf).cpu(),
                                          cpu(x, compute_dtype=bf))
        if c == 160:
            rel["attention heads of 80"] = close(
                "attention heads of 80",
                multi_head_attention(card.attention, x.to(dev), compute_dtype=bf).cpu(),
                multi_head_attention(cpu.attention, x, compute_dtype=bf))
    torch.cuda.synchronize()
    # the C = 1280 layer's heads of 64 are flash attention's: its one launch
    check((fir.LAUNCHES, ftl.LAUNCHES) == before[:2]
          and fa.LAUNCHES["flash_mha"] == before[2]["flash_mha"] + 1,
          f"{tag}: a vision kernel launched on a shape past its plans: {fa.LAUNCHES}")
    log(f"[{tag}] bf16 past the vision plans, unfused on the card, no kernel launch: max err "
        f"against the CPU / largest value: "
        + ", ".join(f"{k} {r:.3g}" for k, r in rel.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import ggml_experiments_tpu_torch as port
    except ImportError as ex:
        print(f"chip_smoke: the port's package is not beside this script ({ex})",
              file=sys.stderr)
        return 2
    import numpy as np

    # the committed decode thresholds, whatever calibration file the machine has
    dispatch_dir = tempfile.TemporaryDirectory()
    os.environ["GXT_TORCH_DECODE_DISPATCH"] = os.path.join(dispatch_dir.name, "none.json")

    from ggml_experiments_tpu_torch import _build, cli
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize, quantize, to_numpy_blocks
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(0)
    tok = CharTokenizer()
    kernels = {}

    # ---- 1. device and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | kernel build {build_s:.1f} s")
    for name in _build.SOURCES:
        log(f"[1 device] ptxas {name}: {_build.ptxas_report(name)}")

    # ---- 2. qmatmul q8_0 kernel vs plain ----------------------------------------
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    qmm = {"q8_0": qmatmul_phase("2 qmatmul", params.cell.recurrent_kernel, dev)}

    # ---- 3. generate (scan path) ----------------------------------------------
    B, T = GENERATE_SHAPE
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 40), 40)
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    out32 = gru_textgen.generate(params, ids, lens, T, compute_dtype=f32)
    out16 = gru_textgen.generate(params, ids, lens, T, compute_dtype=bf16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = port.kernel_launches()
    check(gen_launches["qmatmul_q8_0"] > 0, f"generate launched no qmatmul: {gen_launches}")
    for out in (out32, out16):
        check(out.shape == (B, T) and int(out.min()) >= 0 and int(out.max()) < 66,
              "generate output shape/range")
    params_cpu = load_gru_params(CKPT, qtype="q8_0", device="cpu")
    ref32 = gru_textgen.generate(params_cpu, ids, lens, T, compute_dtype=f32)
    z = torch.zeros(B, dtype=torch.int32)
    tf = torch.full((B,), T, dtype=torch.int32)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(params_cpu), ref32, tf, tf, z, z,
                                        torch.zeros(B, 1024), T, f32, margins=True)
    agree, forked = first_divergence_near_ties(out32.cpu(), ref32, gaps, NEAR_TIE["float32"],
                                               "generate f32 cuda vs cpu")
    log(f"[3 generate] B={B} T={T} q8_0 f32+bf16 in {gen_s:.2f} s | qmatmul launches "
        f"{gen_launches['qmatmul_q8_0']} | f32 tokens vs the CPU run: agreement {agree:.6f}, "
        f"{forked} rows fork (all at near-ties) | sample: {tok.decode(out16[0].tolist())[:60]!r}")
    kernels["qmatmul_q8_0"] = qmatmul_entry(qmm["q8_0"], gen_launches["qmatmul_q8_0"])
    del params_cpu

    # ---- 4. persistent fused decode -------------------------------------------
    kernels["fused_gru_decode"] = decode_phase("4 fused decode", params, *DECODE_SHAPE,
                                               TF_F32_SHAPE, rng, tok)
    forced_plan_phase("4 fused decode", params, rng)

    # ---- 5. continuous-batching engine on the fused tick -----------------------
    n_slots, inner = ENGINE_SHAPE
    tick_run = engine_phase("5 engine", params, REQUESTS, n_slots, inner, rng, tok)
    seng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                        compute_dtype=bf16, temperature=0.8, top_k=20, top_p=0.9,
                        use_fused_tick=True, seed=1)
    sprompts = corpus_prompts(tok, rng, REQUESTS_SAMPLED, 4, 64)
    t0 = time.perf_counter()
    sreqs = [seng.submit(p, 200) for p in sprompts]
    seng.run_until_idle(timeout_s=600)
    seng_s = time.perf_counter() - t0
    for r, p in zip(sreqs, sprompts):
        res = r.result(timeout=0)
        check(len(res) == p.size + 200 and np.array_equal(res[:p.size], p)
              and res.max() < 66, "sampled request output")
    log(f"[5 engine] sampling engine (temperature 0.8, top-k 20, top-p 0.9): {len(sreqs)} "
        f"requests complete in {seng_s:.3f} s, {seng.stats.tokens_per_s:,.0f} tokens/s | "
        f"sample: {tok.decode(sreqs[0].result(timeout=0)[sprompts[0].size:].tolist())[:60]!r}")
    kernels["fused_slot_tick"] = tick_phase("5 engine", params, n_slots, inner, tick_run,
                                            rng, tok)

    # ---- 7. qmatmul, every other format ---------------------------------------------
    float_params = load_gru_params(CKPT, device="cpu")
    w_rec = float_params.cell.recurrent_kernel.numpy()
    B, T = GENERATE_SHAPE
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 40), 40)
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    prompt_pad = torch.nn.functional.pad(ids_t, (0, T - ids_t.shape[1]))
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.full((B,), T, dtype=torch.int32, device=dev)
    params_q4_0 = None
    for qtype in ("q4_0", "q4_1", "q5_0", "q5_1", "q4_k"):
        t0 = time.perf_counter()
        qt = quantize(w_rec, qtype, device=dev)
        quant_s = time.perf_counter() - t0
        log(f"[7 qmatmul] {qtype}: recurrent kernel {qt.shape} quantized on the host in "
            f"{quant_s:.1f} s, {qt.nbytes:,} plane bytes ({qt.stored_bits_per_weight:.3f} "
            f"stored bits/weight)")
        qmm[qtype] = qmatmul_phase("7 qmatmul", qt, dev)
        if qtype == "q4_k":
            continue    # its main path is phase 8's generate from the calibrated checkpoint
        # the format's main path: generate from the checkpoint quantized on load
        p_q = load_gru_params(CKPT, qtype=qtype, device=dev)
        port.reset_kernel_launches()
        out32 = gru_textgen.generate(p_q, ids, lens, T, compute_dtype=f32)
        out16 = gru_textgen.generate(p_q, ids, lens, T, compute_dtype=bf16)
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        name = f"qmatmul_{qtype}"
        check(launches[name] > 0, f"generate {qtype} launched no {name}: {launches}")
        check(all(o.shape == (B, T) and int(o.min()) >= 0 and int(o.max()) < 66
                  for o in (out32, out16)), f"generate {qtype} output shape/range")
        want, _, _, _, gaps = fused.gru_loop_reference(
            fused._prep_weights(p_q), prompt_pad, lens_t, tb, zb, zb,
            torch.zeros(B, 1024, device=dev), T, f32, margins=True)
        agree, forked = first_divergence_near_ties(out32, want, gaps, NEAR_TIE["float32"],
                                                   f"generate {qtype} f32 vs the plain loop")
        log(f"[7 qmatmul] generate B={B} T={T} {qtype} f32+bf16: {name} launches "
            f"{launches[name]} | f32 tokens vs the plain loop: agreement {agree:.6f}, {forked} "
            f"rows fork (all at near-ties)")
        kernels[name] = qmatmul_entry(qmm[qtype], launches[name])
        if qtype == "q4_0":
            params_q4_0 = p_q
    del float_params

    # ---- 8. the calibrated q4_k_m checkpoint, full width --------------------------------
    params_km = load_gru_any(CKPT_Q4KM, device=dev)
    launches, kernels["fused_gru_decode_dense"], kernels["fused_slot_tick_dense"] = \
        calibrated_gru_phase("8 q4_k_m", "gru_synth_q4km.gxt", params_km,
                             load_gru_any(CKPT_Q4KM, device="cpu"), ids, lens, rng, tok,
                             n_slots, inner)
    kernels["qmatmul_q4_k"] = qmatmul_entry(qmm["q4_k"], launches["qmatmul_q4_k"])
    del params_km

    # ---- 9. the q4_0 weight route -------------------------------------------------------
    check(fused._prep_weights(params_q4_0).mode == "q4_0", "q4_0 params took another route")
    kernels["fused_gru_decode_q4_0"] = decode_phase("9 q4_0", params_q4_0, *DECODE_SHAPE_Q4_0,
                                                    DECODE_SHAPE_Q4_0, rng, tok)
    tick_run = engine_phase("9 q4_0", params_q4_0, REQUESTS_ROUTE, n_slots, inner, rng, tok)
    kernels["fused_slot_tick_q4_0"] = tick_phase("9 q4_0", params_q4_0, n_slots, inner,
                                                 tick_run, rng, tok)
    del params_q4_0

    # ---- 10. checkpoint round trip and engine snapshot on the card ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        gxt = os.path.join(tmp, "gru_shakespeare_q5_1.gxt")
        check(cli.main(["quantize", "--input", CKPT, "--output", gxt, "--qtype", "q5_1",
                        "--device", "cuda"]) == 0, "quantize command failed")
        p51 = load_gru_any(gxt, device=dev)
        mem = load_gru_params(CKPT, qtype="q5_1", device=dev)
        for name, a, b in (("cell/kernel", p51.cell.kernel, mem.cell.kernel),
                           ("cell/recurrent_kernel", p51.cell.recurrent_kernel,
                            mem.cell.recurrent_kernel),
                           ("dense_kernel", p51.dense_kernel, mem.dense_kernel)):
            check(a.qtype == b.qtype == "q5_1" and a.shape == b.shape
                  and a.codes.device.type == dev.type, f"{name}: loaded as {a.qtype} {a.shape}")
            for pa, pb in zip(to_numpy_blocks(a), to_numpy_blocks(b)):
                check(np.array_equal(pa, pb), f"{name}: a stored plane differs after the "
                                              f"round trip")
            check(torch.equal(dequantize(a), dequantize(b)), f"{name}: dequantized values "
                                                             f"differ after the round trip")
        for a, b in ((p51.embeddings, mem.embeddings), (p51.cell.bias, mem.cell.bias),
                     (p51.dense_bias, mem.dense_bias)):
            check(torch.equal(a, b), "a float tensor differs after the round trip")
        size = os.path.getsize(gxt)
        log(f"[10 checkpoint] quantize -> {os.path.basename(gxt)} ({size:,} bytes, "
            f"{os.path.getsize(CKPT) / size:.2f}x smaller than gru.bin) -> loaded on the card: "
            f"every plane equal to the in-memory q5_1 quantization")

        prompts = corpus_prompts(tok, rng, REQUESTS_ROUTE, 1, 64)
        new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
        keys = [request_key(p, nt) for p, nt in zip(prompts, new_toks)]
        check(len(set(keys)) == len(keys), "snapshot workload has duplicate requests")
        # a quarter of the slots, so that the snapshot also catches a backlog
        ekw = dict(n_slots=max(1, n_slots // 4), max_prompt=64, inner_steps=inner,
                   compute_dtype=bf16, use_fused_tick=True)
        whole = DecodeEngine(p51, **ekw)
        wreqs = [whole.submit(p, nt) for p, nt in zip(prompts, new_toks)]
        whole.run_until_idle(timeout_s=600)
        want = {k: r.result(timeout=0) for k, r in zip(keys, wreqs)}
        eng = DecodeEngine(p51, **ekw)
        reqs = [eng.submit(p, nt) for p, nt in zip(prompts, new_toks)]
        eng._tick()
        eng._tick()
        snap = os.path.join(tmp, "engine.gxt")
        eng.snapshot(snap)
        got = {k: r.result(timeout=0) for k, r in zip(keys, reqs) if r._done.is_set()}
        done_before = len(got)
        eng2 = DecodeEngine.restore(snap, p51, inner_steps=inner, compute_dtype=bf16,
                                    use_fused_tick=True)
        partial = sum(1 for r in eng2.restored_requests
                      if 0 < len(r._tokens) < r.prompt_ids.size + r.max_new_tokens)
        queued = sum(1 for r in eng2.restored_requests if not r._tokens)
        check(partial > 0 and queued > 0, f"snapshot caught {partial} requests mid-way and "
                                          f"{queued} queued: not an interrupted run")
        eng2.run_until_idle(timeout_s=600)
        torch.cuda.synchronize()
        for r in eng2.restored_requests:
            got[request_key(r.prompt_ids, r.max_new_tokens)] = r.result(timeout=0)
        check(set(got) == set(keys), f"{len(set(keys) - set(got))} requests lost by the restore")
        ids10, lens10 = pad_batch(prompts, 64)
        offline = fused.fused_gru_decode(p51, ids10, lens10, 64 + 256, compute_dtype=bf16).cpu()
        for i, (k, p, nt) in enumerate(zip(keys, prompts, new_toks)):
            check(np.array_equal(got[k], want[k]),
                  f"request {i}: restored run differs from the uninterrupted engine")
            check(np.array_equal(got[k], offline[i, :p.size + nt].numpy()),
                  f"request {i}: restored run differs from the offline decode")
        log(f"[10 checkpoint] engine of {eng2.n_slots} slots: snapshot after 2 ticks ({os.path.getsize(snap):,} bytes; "
            f"{done_before} requests done, {partial} mid-way, {queued} queued) -> restore -> "
            f"all {len(keys)} requests equal to the uninterrupted engine and to the offline "
            f"decode (q5_1, dense weight route, on the card)")

    # ---- 11. the fused training pair against its plain versions ------------------------
    del p51, mem
    torch.cuda.empty_cache()
    fparams = load_gru_params(CKPT, device=dev)
    train_k = train_kernel_phase("11 train kernels", fparams, dev, tok)
    torch.cuda.empty_cache()
    train32_k = train_f32_kernel_phase("11 train kernels", fparams, dev, tok)
    del fparams
    torch.cuda.empty_cache()

    # ---- 12. training at full width ----------------------------------------------------
    main_k, main32_k = train_k[TRAIN_SHAPES[0]], train32_k[TRAIN_SHAPES[0]]
    train_launches, bf16_run = train_phase("12 training", dev, tok,
                                           (main_k["fwd"]["ms"], main_k["bwd_total_ms"]))
    train32_launches = train_f32_phase("12 training", dev, tok,
                                       (main32_k["fwd"]["ms"], main32_k["bwd_total_ms"]),
                                       bf16_run)
    for part in ("fwd", "bwd", "dwr"):
        name = f"fused_gru_train_{part}"
        kernels[name] = dict(main_k[part], launches=train_launches[name])
        kernels[f"{name}_f32"] = dict(main32_k[part], launches=train32_launches[f"{name}_f32"])

    # ---- 13. the vision kernels against their plain versions -------------------------
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.training.image_task import (
        FULL_AMP_FACTOR,
        HELDOUT_SEED,
        make_dataset,
    )

    torch.cuda.empty_cache()
    vit = load_mobilevit(VIT_CKPT, device=dev)
    vision = vision_kernel_phase("13 vision kernels", vit, dev)
    del vit
    torch.cuda.empty_cache()

    # ---- 14. MobileViT through the entry points ----------------------------------------
    t0 = time.perf_counter()
    images, labels = make_dataset(VIT_IMAGES, seed=HELDOUT_SEED, image_size=256,
                                  amp_factor=FULL_AMP_FACTOR)
    log(f"[14 mobilevit] {VIT_IMAGES} held-out images (256 px, task rev 4) made in "
        f"{time.perf_counter() - t0:.1f} s")
    vit_launches, vit, vit_logits = vision_model_phase("14 mobilevit", dev, images, labels)
    for name in ("fused_transformer_layer", *LAYER_KERNELS, "flash_mha",
                 "fused_inverted_residual"):
        kernels[name] = dict(vision[name], launches=vit_launches[name])
    for name in ("inverted_residual_wide",) + WIDE_LAYER_KERNELS:
        kernels[name] = vision[name]   # launches: phase 13's run of the ops' entry points

    # ---- 15. the vision engine ---------------------------------------------------------
    vision_engine_phase("15 vision engine", vit, images)
    del vit
    torch.cuda.empty_cache()

    # ---- 16. GRU calibration on the card ----------------------------------------------
    gru_calibration_phase("16 gru calibration", dev, rng, tok, n_slots, inner)
    torch.cuda.empty_cache()

    # ---- 17. the MobileViT remainders on the card --------------------------------------
    vision_remainders_phase("17 vision remainders", dev, images, labels, vit_logits)
    del vit_logits
    torch.cuda.empty_cache()

    # ---- 18-20. HTTP serving, the dispatch gates and bench --------------------------------
    http_text_phase("18 http text", dev, rng, tok)
    torch.cuda.empty_cache()
    http_vision_phase("19 http vision", dev, images)
    torch.cuda.empty_cache()
    gates_phase("20 gates", dev, rng, tok)
    torch.cuda.empty_cache()

    # ---- 21. multi-device serving ---------------------------------------------------------
    kernels["fused_slot_tick_sharded"], kernels["qmatmul_q8_0_column_shard"] = \
        multidevice_phase("21 multi-device", dev, rng, tok, images, smi)
    torch.cuda.empty_cache()

    # ---- 22. training on a mesh ---------------------------------------------------------
    mesh_launches = train_mesh_phase("22 mesh training", dev, images, smi)
    for name, counts in mesh_launches.items():
        kernels[name]["mesh_launches"] = counts
    torch.cuda.empty_cache()

    # ---- 23. the f32 fused inverted residual ---------------------------------------------
    kernels["inverted_residual_f32"] = ir_f32_phase("23 f32 fused block", dev)

    # ---- 24. AOT artifacts through the CLI ----------------------------------------------
    aot_launches = aot_phase("24 aot", dev, tok, images)

    # ---- 25. the trace report and the native host runtime -----------------------------
    trace_phase("25 trace report", dev)

    # ---- 26. the stride-2 fused inverted residual ----------------------------------------
    kernels.update(ir_s2_phase("26 stride-2 fused block", dev,
                               torch.from_numpy(images[:VIT_BATCH]).to(dev)))
    for name, n in aot_launches.items():
        if name not in F32_LAYER_KERNELS:   # measured in phase 28
            kernels[name]["aot_launches"] = n

    # ---- 27. the port's serving tools ---------------------------------------------------
    tools_phase("27 tools")

    # ---- 28. the f32 fused layer -----------------------------------------------------------
    f32_layer = layer_f32_phase(
        "28 f32 fused layer", dev, torch.from_numpy(images[:VIT_BATCH]).to(dev))
    del images
    torch.cuda.empty_cache()
    for name in F32_LAYER_KERNELS:
        # the main path: phase 14's f32 classify on the default route
        kernels[name] = dict(f32_layer[name], launches=vit_launches[name])
        for key, n in aot_launches.items():
            if key == name:
                kernels[name]["aot_launches"] = n

    # ---- 29. the examples and the three tools ------------------------------------------------
    torch.cuda.empty_cache()
    example_runs = examples_phase("29 examples and tools", dev)

    # ---- 30. MobileViT-small at 512 px: attention past shared memory -------------------------
    torch.cuda.empty_cache()
    kernels.update(long_sequence_phase("30 512 px", dev))

    # ---- 31. the persistent kernel past V = 256 and at U off 32 ------------------------------
    torch.cuda.empty_cache()
    kernels.update(wide_gru_phase("31 wide gru", dev))

    # ---- 6. kernels ---------------------------------------------------------------
    src = "ggml_experiments_tpu_torch/csrc/"
    qmm_at = "ggml_experiments_tpu/quant/pallas_kernels.py:253"
    dec_at = "ggml_experiments_tpu/ops/fused_gru_decode.py:227"
    tick_at = "ggml_experiments_tpu/ops/fused_gru_decode.py:774"
    meta = {f"qmatmul_{q}": (src + "qmatmul.cu", qmm_at)
            for q in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k")}
    for route in ("", "_q4_0", "_dense"):
        meta["fused_gru_decode" + route] = (src + "gru_persistent.cu", dec_at)
        meta["fused_slot_tick" + route] = (src + "gru_persistent.cu", tick_at)
    meta["fused_gru_train_fwd"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:186")
    meta["fused_gru_train_bwd"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:285")
    meta["fused_gru_train_dwr"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:285")
    for part, at in (("fwd", 186), ("bwd", 285), ("dwr", 285)):
        meta[f"fused_gru_train_{part}_f32"] = (src + "gru_train_f32.cu",
                                               f"ggml_experiments_tpu/ops/fused_gru_train.py:{at}")
    for name in ("fused_transformer_layer",) + LAYER_KERNELS:
        meta[name] = (src + "transformer_layer.cu",
                      "ggml_experiments_tpu/ops/fused_transformer_layer.py:184")
    for name in F32_LAYER_KERNELS:
        meta[name] = (src + "transformer_layer_f32.cu",
                      "ggml_experiments_tpu/ops/fused_transformer_layer.py:184")
    meta["flash_mha"] = (src + "flash_attention.cu",
                         "ggml_experiments_tpu/ops/flash_attention.py:104")
    # phase 30: the three kernels that stream a head's keys, at L = 1024 (512 px)
    layer_at = "ggml_experiments_tpu/ops/fused_transformer_layer.py:184"
    meta["transformer_attention_512px"] = (src + "transformer_layer.cu", layer_at)
    meta["transformer_attention_f32_512px"] = (src + "transformer_layer_f32.cu", layer_at)
    meta["flash_mha_512px"] = (src + "flash_attention.cu",
                               "ggml_experiments_tpu/ops/flash_attention.py:104")
    # phase 13: the wide kernels, through the ops' entry points at the widths past
    # MobileViT-small's
    for name in WIDE_LAYER_KERNELS:
        meta[name] = (src + "transformer_layer.cu", layer_at)
    meta["inverted_residual_wide"] = (src + "inverted_residual_wide.cu",
                                      "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    meta["fused_inverted_residual"] = (src + "inverted_residual.cu",
                                       "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    meta["inverted_residual_f32"] = (src + "inverted_residual_f32.cu",
                                     "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    for name in ("inverted_residual_s2", "inverted_residual_s2_f32"):
        meta[name] = (src + "inverted_residual_s2.cu",
                      "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    # phase 31: the persistent kernel at V = 5000 and 257 and at U = 1000
    for name in ("fused_gru_decode_v5000", "fused_gru_decode_v5000_unit",
                 "fused_gru_decode_v5000_f32", "fused_gru_decode_v257", "fused_gru_decode_u1000"):
        meta[name] = (src + "gru_persistent.cu", dec_at)
    for name in ("fused_slot_tick_v5000", "fused_slot_tick_v5000_sampled"):
        meta[name] = (src + "gru_persistent.cu", tick_at)
    # phase 21: the tick on one rank's slot shard, the qmatmul kernel on a column shard
    meta["fused_slot_tick_sharded"] = (src + "gru_persistent.cu", tick_at)
    meta["qmatmul_q8_0_column_shard"] = (src + "qmatmul.cu", qmm_at)
    line = []
    for name, (source, replaces) in meta.items():
        check(name in kernels, f"{name} was not measured")
        kd = kernels[name]
        check(kd["launches"] > 0, f"{name} was not launched on its main path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": kd["launches"], "max_abs_err": kd["max_abs_err"],
                 "ms": kd["ms"], "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
                 "bound_by": kd["bound_by"], "library_ms": kd["library_ms"]}
        if "bfloat16" in kd:     # qmatmul: the main path's bf16 cell beside its f32 one
            entry["bfloat16"] = kd["bfloat16"]
        if "plan" in kd:         # the persistent kernel, the train pair: the plan its run took
            entry["plan"] = kd["plan"]
        if "mesh_launches" in kd:   # the train kernels: phase 22's launches by run and rank
            entry["mesh_launches"] = kd["mesh_launches"]
        if "aot_launches" in kd:    # qmatmul q8_0, flash or the f32 layer, f32 blocks: phase 24
            entry["aot_launches"] = kd["aot_launches"]
        if "shapes" in kd:          # the stride-2 kernel, the 512 px kernels: each shape's readings
            entry["shapes"] = kd["shapes"]
        if "graph_ms" in kd:        # the f32 and stride-2 blocks: a CUDA graph's time a call
            entry["graph_ms"] = kd["graph_ms"]
        on_examples = {run: r["launches"][name] for run, r in example_runs.items()
                       if r["launches"].get(name)}
        if on_examples:             # phase 29: the launches of each example and tool run
            entry["example_launches"] = on_examples
        line.append(entry)
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
