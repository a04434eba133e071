"""Chip smoke of the PyTorch + CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py [--parent CHECKOUT]

runs every phase below on one card; on a machine with two or more, the
tp = 2 phase gives each rank a card of its own over NCCL. With
``--parent``, the sources of CHECKOUT (another commit's tree) whose
kernels the recent slices redesigned (``xent.cu``, ``softmax.cu``,
``decode_attention.cu``, ``layer_norm.cu``, ``attention_bwd.cu``,
``qmatmul.cu``, ``multi_tensor.cu``) are built too, and their K7, K7p,
K10, K10L, K2 and K2q, K5/K6 and K5d/K6d at head dims 80 and 256, K3 and
K4 at every width the smoke times and K23 at its five decode shapes are
timed in turns beside this tree's (``parent_ms``, ``parent_ms_turns``;
through this tree's wrappers, so those C entries must be this tree's),
and so are K14 and K15, through the parent's own wrappers
(``PARENT_WRAPPERS``, loaded from CHECKOUT and run on its library: a
launch a group of 95 tensors, before they took a whole list). For
example, from the root of this checkout::

    git archive <parent commit> apex_tpu_torch | tar -x -C build/parent
    python3 chip_smoke.py --parent build/parent

Needs one CUDA card and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. It imports nothing of JAX
and nothing of ``apex_tpu``. Phases, in order (any failure raises and
exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, the SM clock's maximum
   (the INT32 rate assumes it), torch and CUDA versions; TF32 is
   switched off for fp32 matmuls and convolutions.
2. build: the ten CUDA sources compile from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` each, all in parallel) into ``build/apex_tpu_torch/``; ptxas's
   registers and spills are printed, and, where the toolkit has
   ``cuobjdump``, the tensor-core instructions (``HGMMA``: wgmma;
   ``HMMA``: mma.sync) of each bf16 instantiation of K5/K6 (d 64, 128
   and 256, with and without dropout: twelve) and K1/K1d (d 64, 128 and
   256), of the tensor-core K8/K9 (32- and 16-row streamed tiles) and of
   the tensor-core first stage of K7/K7p (``xent_fwd_tc``), which must
   hold ``HGMMA``, and of each bf16 and fp16 instantiation of K23's
   tensor-core body (twelve), which must hold ``HMMA``; ptxas must report
   no spill in a tensor-core K5/K6 instantiation at d = 256 and no
   serialized wgmma in any.
3. one phase per kernel at its main path's shapes: K1 and K2 at the
   serving shapes, K3/K4 (layer norm, x ``[8192, 768]`` bf16), K5/K6
   (attention backward, ``[8, 12, 1024, 64]`` bf16, causal), K1d, K5d
   and K6d (attention with dropout 0.1, same shape; two K5d/K6d runs
   must give the same bits) and K7-K9 (the fused LM head, x ``[8192,
   768]`` x E ``[50304, 768]`` bf16) at the training shapes; K2q (decode
   over the int8 KV tier's pages, the serving shape; also against K2
   over the unquantized pages within the int8 band, 0.12) and K10/K11
   (the scores path's softmax, ``[8, 12, 1024, 1024]`` bf16, K10 causal
   and with an explicit ``[8, 1, 1024, 1024]`` mask); K10L/K11L (the
   generic softmax's rows over 4096 keys, ``[1, 12, 1024, 8192]`` and the
   ragged 5000 keys, bf16; K10L also at 32768 and 200000 keys and each
   length in fp32, so that each of its bodies runs, two runs giving the
   same bits, ``by_length``); K7p with K8 and K9 on the two vocabulary
   shards of the tp = 2 head (x ``[8192, 768]``, E ``[50432, 768]``
   split into 25216-row shards, bf16): each kernel against its plain
   version, and the shards' partials combined in torch, their dX summed
   and their dE stacked against K7-K9 on the whole table, at label
   smoothing 0 and 0.1 (``XENT_PARTIAL_TOL``, ``XENT_SHARD_DX_L2_TOL``).
   Then the long-row kernels' path: ``GenericFusedScaleMaskSoftmax`` on
   ``[1, 12, 1024, 8192]`` bf16 scores, forward and backward, must launch
   K10L and K11L once each and nothing else. K1d's mask
   is also recovered exactly from its output (q = k = 0, V the identity,
   fp32: O = mscale / 128) and must equal the plain mask in every
   element; in bf16 (the tensor-core body, whose O is a rounding of
   mscale / 128) O must be non-zero exactly where the plain mask keeps.
   Each kernel is held against its plain PyTorch
   version on the card with a stated tolerance (the training-shape bf16
   outputs also by relative L2, ``BF16_L2_TOL``; K1 is held at the
   training shape too, within ``K1_L2_TOL``, before its output feeds the
   backward; K7's fp32 loss and lse within ``XENT_LOSS_TOL`` and
   ``XENT_LOSS_L2_TOL``; two K8 runs and two K9 runs must each give
   the same bits); its
   time, the plain version's and one PyTorch call's (``library_ms``:
   SDPA, ``F.layer_norm``, the materialized head ``x @ E.T`` then
   ``F.cross_entropy``, or their backward through ``torch.autograd.grad``
   on a graph built outside the timed region; SDPA over pre-gathered,
   pre-dequantized K/V for K2q; ``torch.softmax`` over the fp32-upcast,
   pre-masked scores for K10 and K10L and ``torch._softmax_backward_data``
   for K11 and K11L; for K7p ``x @ E_shard.T`` then the row max,
   ``torch.logsumexp`` and the gathered target — timed here, never used
   by the port), each over launches that
   find the 50 MB L2 cache flushed
   (the kernel's own launches also give their [min, median, max],
   ``ms_spread``; K1, K1d, K5/K6, K5d/K6d, K7, K7p, K8/K9 and K10 in
   both modes are timed in turns with their library call, kernel,
   library, kernel, ``ms`` the mean of the two turns, ``ms_turns``
   each; two K10 runs in each mode must give the same bits); and the
   least time an H100 SXM could take for the same work (``bound_ms``:
   bytes each input read and output written once over 3.35 TB/s, or
   the work this run's masks leave over 989
   TFLOP/s bf16 — 67 TFLOP/s fp32 for layer norm's elementwise math —
   or, for the dropout variants, the hash's 11 integer operations per
   live pair over 132 x 64 INT32 lanes at 1.98 GHz, whichever is
   largest; NVIDIA's data-sheet rates). K2 and K2q (split-KV, the last
   block of a slot-head combining) must give the same bits twice, with
   ptxas's registers and spills; both also run at head dims 80 and 256 at
   the serving lengths (``by_head_dim``). Then the other widths: K1, K1d,
   K5/K6 and K5d/K6d at
   head dim 80 (``[2, 32, 1024, 80]``, GPT-3 2.7B's heads, zero-padded to
   128) and 256 (``[2, 16, 1024, 256]``, GPT-J-6B's heads; K5 with two
   warpgroups a block, K6 with one for dk and one for dv), bf16, causal,
   with and without dropout, two runs of K5/K6 (K5d/K6d) giving the same
   bits, the backward kernels timed in turns around SDPA's backward
   (and the parent's, with ``--parent``), fp32 K5/K6 at 256 (the CUDA
   cores) against their plain version within ``FP32_L2_TOL`` and timed
   (``by_head_dim`` in the kernel's row). K3/K4 run at 768 and then at
   widths 100, 12288 and a ``(64, 200)`` normalized shape through
   ``fused_layer_norm`` (rows of 12800), rows = 8192 (``by_width``):
   each against its plain version, two runs giving the same bits, timed
   in turns around its library call and the parent's body (with
   ``--parent``), K4 with its second stage, the plan and ptxas's
   registers and spills of the instantiation it launches beside it.
   Last the multi-tensor kernels (``phase_multi_tensor_kernels``) on
   GPT-2-small's 148 fp32 leaves (124.4 M elements; gradients scaled by
   2^16) and on a ragged list (1, 3, 767, 768, 4099 elements and a view 4
   bytes off a 16-byte boundary): K12 (the loss scaler's unscale and
   found-inf flag, also with an inf planted) and K14 (Adam, two steps and
   a step with the flag set) bit for bit against their plain versions,
   K13 (norms) and K15 (a LAMB step) within ``MT_NORM_TOL`` /
   ``MT_LAMB_TOL``, two runs the same bits; each timed in turns with its
   library call (K12 ``torch._amp_foreach_non_finite_check_and_unscale_``,
   K13 ``torch._foreach_norm``, K14 ``torch.optim.Adam(fused=True)``'s
   step; K15 none), bounds by bytes. K14 and K15 take the whole list in
   one launch: each reports its plan (grid, blocks an SM),
   ptxas's registers and spills and its launches a call; K15 also runs at
   BERT-large's 302 leaves (within ``MT_LAMB_TOL``, two runs the same
   bits), reports its 40-byte two-pass floor, and both run captured in a
   CUDA graph, each replay the eager step's bits. With ``--parent`` K14
   and K15 are timed in turns with the parent's (its group launches,
   ``PARENT_WRAPPERS``) and held to the parent's bits, and the host
   time of a call of each wrapper is taken in turns with the parent's
   wrapper. Then BERT-large's
   kernel modes
   (``phase_bert_kernel_modes``, ``bert_large`` in the kernel rows): K1d,
   K5d and K6d non-causal with padding segment ids at ``[16, 16, 512,
   64]`` bf16 (seeded valid lengths over [128, 512], one row all valid,
   one of a single token; SDPA with a boolean key-padding mask and
   dropout 0.1 the library call), K10 with the ``[16, 1, 512, 512]``
   extended mask of those lengths at scale 24 (its fully masked rows
   exact zeros) and K11, each against its plain version, timed in turns
   and bounded over the live pairs (for K1d/K5d/K6d a query's segment,
   for K10/K11 the mask's unmasked pairs); and K1d's mask on that route
   recovered from its output (q = k = 0, V the identity in column blocks
   of the head dim) where the plain mask keeps and the segments agree,
   bit for bit, at head dims 64 (BERT-large's) and 128, fp32 and bf16.
   Then ResNet-50's kernels: K17 (the batch-norm forward) and K18 (the
   backward) in their one-launch forms against their plain versions at
   ResNet-50's twelve shapes at b = 256 (``BN_STEP_SHAPES``, bf16, NHWC
   rows, the 64-channel ones with the fused ReLU) and ``[32, 256, 56,
   56]`` fp32, their two-launch forms at ``BN_MAIN_SHAPE`` and the fp32
   shape: the sums and saved statistics within ``BN_STAT_TOL``, y and dx
   by relative L2 within ``BN_L2_TOL``, each launch twice the same bits;
   timed in turns with cuDNN's ``F.batch_norm`` (training, the
   channels_last view) and its backward and, with ``--parent``, the
   parent's two launches, after the standard and a clean flush, with
   each shape's one-pass bound and two-pass floor and the step's sum
   (``by_shape``, ``step_ms``); their registers and resident blocks; a
   CUDA graph capturing the one-launch forms; and K16 (SGD,
   the O2 four-list form writing the bf16 copy) on ResNet-50's 161
   leaves in turns with ``torch.optim.SGD(fused=True).step``, bound 22
   bytes a parameter. Then the scale-out kernels
   (``phase_scale_out_kernels``): K19 (the int8 block quantizer with error
   feedback) on BERT-large's padded flat gradient as the reduce-scatter's
   rows ``[2, P / 2]`` and K20 (dequantize and sum of two ranks' payloads)
   bit for bit against their plain versions, K21 (the ZeRO Adam shard
   update) on GPT-2-small's shard at world 2 bit for bit and in turns with
   ``torch.optim.Adam(fused=True).step`` over one fp32 tensor of the
   shard's size, K22 (the ZeRO LAMB shard update, both stages) on
   BERT-large's shard 0 of 2 with its real segments within ``ZERO_TOL``;
   bounds by bytes (13, W + 4, 32 and 44 an element).
4. serving end to end: ``ServingEngine`` at GPT-2-small width (12 x 768,
   12 heads, vocab 50304, 1024 positions, bf16; 8 slots, page size 128,
   72 pages, 512-token packed prefill) with random weights from seed 0
   serves a seeded synthetic trace to completion, timed, its decode
   program captured once as a CUDA graph (the engine's default on the
   card), then the same trace again under ``torch.profiler``. The
   wrappers' counts, zeroed before the engine is built, must be K1 =
   every prefill batch x 12 and K2 = 2 x 12 (the decode program's
   warm-up and capture: a replay calls no wrapper); the kernels the
   device ran in the traced run, counted by name (``TRACED_KERNELS``),
   must be K1 = its ``prefill_batches x 12`` and K2 = its
   ``decode_steps x 12``. Then one packed
   prefill batch and 4 decode steps run through the kernel path and the
   plain path on the card, and their logits must agree within 0.35 (the
   bf16 band of the JAX package's serving tests); a second short trace
   replays under ``torch.profiler`` (busy share, kernel time by kind).
   Then the same trace, checks and profile with ``kv_quant=True`` (the
   int8 KV tier, the same 72 pages): K2q must run ``decode_steps x 12``
   times in the traced run and K2 never, null page 0 must stay zero, and
   the int8
   codec's launches and device time for one decode step's and one
   prefill batch's cache writes are read by replaying them alone; the
   two engines' numbers and cache bytes side by side. Then the decode
   program's variants (``phase_serving_variants``): the same trace
   served greedy and sampled (temperature 0.8, top-k 50, top-p 0.95, the
   seed the request id), over bf16 and int8 pages, by eager K = 1,
   graphed K = 1 and graphed K = 4 (``decode_block``), each pair once
   (``VARIANT_TURNS`` names any to repeat in turns), one prompt
   a prefill batch (``VARIANT_ENGINE``): the runs of a pair must give the
   same tokens bit for bit, K2 (K2q) must be
   called through its wrapper (``_decode_calls``) x K x 12 times, and, in
   each graphed variant's profiled short trace, run on the device
   dispatches x K x 12 times; each variant's tokens/s, TTFT and
   TPOT p50/p99, decode-round ms and busy share, the sampler's device ms
   a step, and how many requests keep equal tokens between graphed K = 1
   and K = 4 at the packed prefill. Then int8 weights
   (``phase_weight_quant_serving``): ``TRACE`` on the graphed bf16-KV
   engine with ``weight_quant=False`` and ``True`` in turns (off, on, on,
   off): tokens/s, TTFT and TPOT p50/p99, decode-round ms; K23 counted
   on the device in a traced rerun, 49 a decode step (12 layers x 4 + the
   logits) with int8 weights and none without, and 2 x 49 at its wrapper
   (the warm-up and the capture); the int8 engine's decode logits, kernel
   path against plain path, within 0.35. Before the serving phases, K23
   at GPT-2-small's five decode shapes at 8 rows, bf16, fp16 and fp32, on
   the launch ``ops/qmatmul_cuda.plan`` picks (``phase_qmatmul_kernel``):
   relative L2 within ``QMM_L2_TOL``, the all-zero weight row's outputs
   0, two runs equal bit for bit; its time in turns with cuBLAS over a
   pre-dequantized weight (and, with ``--parent``, the parent's K23),
   the plain version's and the bound, summed over a decode step's 49
   launches for the row, beside one launch that moves 4 bytes timed the
   same way; the tensor-core instantiations hold ``HMMA`` (phase 2); then
   K23 at K 8, 24, 100 and 770 and an int8-weight engine at hidden 100
   against its plain path (``phase_qmatmul_any_k``), and K19/K20 at
   blocks 32, 64 and 256 bit for bit (``_codec_blocks``).
5. training end to end: ``make_one_step`` over ``GPTModel`` at GPT-2-small
   width, b=8, s=1024, bf16, ``LossScaler()`` and
   ``fused_adam(learning_rate=1e-4)``, ids and labels from
   ``np.random.RandomState(0)`` (as ``bench.py`` makes them), the same
   batch every step; first with the materialized LM head, then with
   ``fused_lm_head=True`` (this slice's main path), each model built and
   freed on its own. 2 warm-up steps, then the timed steps (host clock
   ending in ``synchronize``): step ms, tokens/s, MFU = 6 N b s / step /
   989e12, peak memory, side by side for the two heads; the fused
   step's peak must be the lower. The loss must be finite and lower
   after the window than at step 1, and the launches per step must be
   K1 = K5 = K6 = 12, K3 = K4 = 25 and K7 = K8 = K9 = 1 with the fused
   head (0 with the materialized one, whose cross entropy must then run
   once per step and never with the fused head), and the optimizer's K12
   once and K14 once a list (one at 148 leaves). Then
   the fused head trained by pretrain.py's LAMB (``LAMB``: decay 0.01,
   clip 1.0, the warm-up + cosine schedule computed on the device count):
   K12 once, K13 twice a group and K15 once a step, the same checks.
   After the paths-agree steps, the optimizer against its plain version in
   the window (``phase_optimizer_paths_agree``: Adam bit for bit after each
   of 7 steps on the same real gradients; LAMB's 7-step losses within
   ``TRAIN_LOSS_BAND``) and the optimizer region alone
   (``phase_optimizer_region``: unscale, scaler update, optimizer, selects
   on one step's real gradients, kernel and plain path in turns: host ms,
   device ms, launches; with ``--parent`` the parent's K14/K15 wrappers
   take turns too, and the window's step ms is taken in turns with
   theirs). For each head a forced
   overflow (loss scale 3e38, one gradient made non-finite) must leave
   every parameter and the Adam state bitwise unchanged, halve the scale
   and reset ``unskipped``, and a profiled window gives the device's
   busy share and time by kind. Then GPT-2's published dropout (hidden
   and attention 0.1, ``benchmarks/profile_gpt.py:401-425``) with the
   materialized head and a seeded ``dropout_generator``: the same
   window, forced overflow and profile, with K1d = K5d = K6d = 12 and K1
   = K5 = K6 = 0 launches per step; and the same window and profile with
   ``recompute_granularity="full"`` (K1d = 24, K3 = 49: the backward
   recomputes each layer's forward), whose peak memory must be the
   lower. At b=2 on the card, within the stated bf16 bands in the loss
   and every gradient: each head's kernel path against its plain path
   (with dropout too, the same masks on both paths), the fused model
   against the materialized one on the same weights, and
   ``"selective"`` and ``"full"`` recompute against none with dropout on
   the kernel path (and whether bit for bit). Then the scores path
   (``benchmarks/profile_gpt.py:401-425`` row 10: dropout 0.1,
   ``fused_attention_dropout=False``, ``softmax_use_pallas=True``, the
   materialized head): the same window and profile with K10 = K11 = 12,
   K3 = K4 = 25 and no attention kernel launched per step, side by side
   with the in-kernel dropout window, and its kernel path against its
   plain path at b=2 on the same masks. Then BERT-large (``BERT_LARGE``:
   24 x 1024, 16 heads, s = 512, vocab 30592, bf16, random weights from
   torch seed 0, no depth cut) trained by ``make_one_step`` with
   ``fused_lamb(1e-4)`` at b = 16: window A (dropout 0, an all-ones
   mask: the scores path, K10 = K11 = 24 a step) and window B (valid
   lengths seeded over [128, 512], dropout 0.1: the segment-id route,
   K1d = K5d = K6d = 24 and no K10), each with K3 = K4 = 50 and K12 once,
   K13 and K15 twice a group a step, 2 warm-up and 5 timed steps: step
   ms, tokens/s, MFU, peak memory, the losses of steps 1-7 (finite,
   falling) and a profiled two-step window; then at 2 of its layers, b =
   2, each window's kernel path against its plain path within the
   training bands, and the pooler's and binary head's parameters after
   one LAMB step on each path within ``MT_LAMB_TOL``. Then ResNet-50
   (BASELINE configs 1-2; ``RESNET``: 224^2 synthetic images from a seed,
   1000 classes, b = 256, ``fused_sgd`` lr 0.1 on the ImageNet example's
   ``make_lr_schedule``, momentum 0.9, decay 1e-4, random weights from
   seed 0, no depth cut) trained by ``examples/imagenet.build_train_step``:
   R-O2 (bf16 parameters over fp32 masters, JAX's batch-norm predicate:
   only ``bn_init``'s two fp32; K12, K16 writing the bf16 copy) and R-O1
   (fp32 parameters, bf16 convolutions, no masters; K12, K16), each
   SyncBatchNorm on K17/K18: 2 warm-up and 5 timed steps, step ms,
   images/s, MFU = 3 x the forward FLOPs of the convolutions and fc (8.18
   GFLOP an image) x b / step / 989 TFLOP/s, peak memory, the losses of
   steps 1-7, the launches a step (K17's and K18's stages 53 each, K12 and
   K16 once a group, nothing else), one step with each of its 212 K17/K18
   calls held against the plain version on the same activations (y and
   dx within ``BN_L2_TOL``, the sums and statistics within
   ``BN_STAT_TOL``), a profiled two-step window (busy share, device ms by
   kind: conv, batch_norm, elementwise, optimizer, sgd, matmul, other)
   whose K17/K18 stages the device ran 106 times each; then the kernel
   path against the plain path at b = 8 (``RESNET_AGREE``: one O0 step's
   loss and gradients, one O2 step's loss, within the larger of the
   training bands and twice the move under ``NUDGE``) and K16 against the
   plain SGD bit for bit over 7 steps of real gradients, step 4's loss
   scale infinite; then R-DDP (``RESNET_DDP``): two ranks started with
   ``spawn``, NCCL with a card each or gloo on one, O2 with SyncBatchNorm
   over the group at b = 32 a rank, three steps, every rank's masters,
   bf16 parameters and running stats bit-equal after each (checksums,
   all-reduce MAX against MIN); in step 1 each rank's K17/K18 calls held
   as above, with the all-reduced sums against the whole batch's, and
   the averaged gradients against the mean of the ranks' own; rank 0's
   loss against one process on the 64 images with local batch norm; step
   ms and all-reduces a step recorded; the ResNet phases' seconds against
   the ~120 s they were given. Last, this slice's main path:
   GPT-2-small at tensor-parallel size 2 (the vocabulary padded to 50432
   = ``pad_vocab_size(50257, 2)``, the fused head, no dropout) trained by
   ``make_one_step`` with the ``GradScaler`` in two ranks started with
   ``spawn`` through a ``file://`` store: over NCCL, a card each, where
   the machine has two or more cards, else both on the one card over
   gloo (which stages the all-reduces of CUDA tensors through the host).
   One step at b=2 must agree with a tp = 1 step on the same seed within
   the training bands (the loss; each gradient, the shards'); then the
   window at b=8, s=1024 per rank: step ms, tokens/s, MFU, peak memory,
   launches per step (K7p = K8 = K9 = 1 and no K7; K1 = K5 = K6 = 12; K3 =
   K4 = 25), the losses of steps 1-7 equal on the two ranks and falling,
   rank 0's profiled window, and the all-reduces a step makes (count,
   bytes) with the time of one of a ``[1024, 8, 768]`` bf16 activation.
   Before it, GPT-3 2.7B's widths (``GPT3_2P7B``: hidden 2560, 32 heads
   of 80, ffn 10240, vocab 50304; depth cut from 32 layers to 2 for the
   smoke's time; random weights from torch seed 0): ``ServingEngine``
   serves 6 seeded greedy requests (K1 and K2 counted at their wrappers
   and, in a traced rerun, on the device), the
   kernel and plain paths' logits agree within 0.35, and one training step
   at b = 2, s = 1024 agrees with the plain path within the training
   bands; K1, K2, K3, K4, K5 and K6 must each have launched. Then GPT-J-6B's
   attention widths (``GPTJ_6B``: hidden 4096, 16 heads of 256, ffn
   16384, vocab 50400, the port's GPT-2-style blocks; depth cut from 28
   layers to 2) at b = 2, s = 1024, bf16, the materialized head, without
   and with dropout 0.1: ``WIDE_WINDOW``'s timed steps (step ms, peak
   memory, the launches a step: K1 = K5 = K6 = 2, or K1d = K5d = K6d = 2)
   and one step through the kernel path against the plain path within
   the training bands. Last before tp = 2, heads past the attention
   kernels (``HD320``: 2 layers of hidden 1280 over 4 heads of 320): the
   same windows and comparisons, K10 = K11 = 2 a step and no attention
   kernel (the scores route; with dropout the scores path), then
   ``ServingEngine`` serves ``GPT3_TRACE``'s requests, K10 once a layer a
   prefill batch, K2 at its 512 bucket once a layer a decode step and K1
   never, the kernel and plain paths' logits within 0.35. Then heads past
   the decode kernels (``HD576``: 2 layers of hidden 1152 over 2 heads of
   576): ``ServingEngine`` serves the same requests, K10 once a layer a
   prefill batch and a decode step (decode's scores route), K1, K2 and
   K2q never, the kernel and plain paths' logits within 0.35. Each of
   these serving runs is counted as phase 4's is: at the wrappers from
   the engine's construction on, and on the device in a traced rerun.
   Last, the scale-out slice: Z-BERT, BERT-large at data-parallel
   world 2 (each rank 8 of window A's 16 sequences) trained by
   ``make_one_step`` with a ``GradScaler`` over the group and
   ``distributed_fused_lamb`` (ZeRO-2, window A's LAMB recipe), three
   steps with the codec off and three from the same weights with int8
   and error feedback, in two ranks started with ``spawn`` (NCCL with a
   card each, else gloo with both on cuda:0: correctness only); step 1's
   K19-K22 calls each held against the plain version on their own
   inputs (``_zero_held``), step 2's collectives clocked on the host,
   step 3 profiled on rank 0; the ranks' parameters bit-equal after each
   step; step 1's loss against window A's unsharded one (the band four
   times the move between its two halves and it); the codec-off run's
   parameter move in step 1 against window A's unsharded FusedLAMB step
   (K13, K15) on the same 16 sequences through ``allreduce_gradients``,
   within ``ZERO_MOVE_BAND`` times that step's own move under a learning
   rate nudged by ``ZERO_LR_NUDGE``; the int8 losses of steps 2 and 3
   within ``CODEC_MOVE_SHARE`` of the codec-off run's move since step 1;
   each int8 step's residuals read by the next step's K19 calls; the
   launches (K22 3 a step, with int8 K19 and K20 2 a step). Z-GPT in the
   same ranks:
   GPT-2-small on ``distributed_fused_adam`` (K21, held in step 1)
   against ``allreduce_gradients`` + ``fused_adam`` (K14), parameters bit
   for bit after each of three steps. R-DDP-int8: three more R-DDP steps
   in its ranks with ``DistributedDataParallel(compress="int8")`` and its
   residual, every K19/K20 call held, ranks bit-equal. HIER: world 4 as
   (2, 2) (four ranks), GPT-2-small's width at 2 layers, the fp32
   gradients all-reduced flat, hierarchically (within ``HIER_TOL`` of
   flat) and hierarchically with int8 (K19/K20 held), every rank the same
   bits. LARC: ResNet-50 R-O2 at world 1, b = 64, three steps with
   ``larc`` before ``fused_sgd``, each step's scaled gradients (K13's
   norms) within ``ZERO_TOL`` of the plain LARC path's.
   After the ResNet phases, DCGAN (``DCGAN``, BASELINE config 5: the
   upstream example's defaults, nz 100, ngf = ndf = 64, 64^2, b = 64;
   ``examples/dcgan.build_train_step``, the three-loss step) under O1 and
   O2: 2 warm-up and 5 timed steps (step ms, images/s, peak memory, the
   losses finite), the launches a step (K17 17 and K18 13 a stage, K14
   2); one step with every K17/K18 call held against its plain version
   (``_bn_held``); K12 and K14 bit for bit against their plain versions on
   one D pass's real gradients; one step through the kernel path against
   the plain path from the same state, within twice the kernel path's own
   move when the images and z move by ``DCGAN_NUDGE``; a profiled
   two-step window. Then the ImageNet example's ``--resume``
   (``IMAGENET_RESUME``: resnet18 at width 16, synthetic, deterministic):
   two straight epochs twice, one epoch and a resumed second, the
   checkpoints bit for bit (or, where the straight runs differ, within 10
   x their distance).
6. one JSON line per kernel (K1-K23), each phase's seconds, the wall, the
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
   {...}}``.
"""

import contextlib
import copy
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 off the tensor cores
# 32-bit integer operations on the CUDA cores: 132 SMs x 64 INT32 lanes
# (Hopper white paper) at the 1980 MHz boost clock (the card's
# clocks.max.sm, printed in phase 1)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the dropout hash per live (query, key) pair: an xor, fmix32's 8
# operations, the compare and the select or multiply
HASH_OPS_PER_PAIR = 11
DROPOUT_P = 0.1               # GPT-2's attn_pdrop and resid_pdrop
L2_FLUSH_BYTES = 128 << 20    # > the 50 MB L2 cache
LOGITS_BAND = 0.35
# a bf16 kernel output against its plain version, ||out - ref|| / ||ref||.
# K3-K6 and their plain versions round at the same points, so most
# elements round to the same value (on an H100: 1e-5 for layer norm,
# 5e-5 to 8e-5 for the attention gradients at the training shape).
# K1 rounds P to bf16 as exp(s - m_running) in one pass and its plain
# version rounds the normalized P: one rounding each, at different scales,
# which costs ~2.9e-3 at the training shape on the same card.
BF16_L2_TOL = 1e-3
K1_L2_TOL = 1e-2
# K7 against its plain version: fp32 loss and lse (~11 at init) from
# logits summed in another order; an H100 measured 3.8e-6 max |diff| (four
# ulps) and 7.4e-8 relative L2, on wmma and again on wgmma. K8 and K9 are
# held to BF16_L2_TOL: their coefficients round to bf16 on both sides, and
# at the training shape dX measured 5.4e-4 and dE 1.9e-4, on wmma and again
# on wgmma
XENT_LOSS_TOL = 3e-5
XENT_LOSS_L2_TOL = 1e-6
# kernel path vs plain path of one training step (bf16): |loss diff| and
# each gradient's relative L2 difference. The two paths share every bf16
# rounding point (P and dS rounded before the products, layer-norm output
# in bf16); they differ in fp32 summation order and exp, and a one-ulp
# flip of a bf16 intermediate moves a gradient by ~2^-8 of its scale.
TRAIN_LOSS_BAND = 2e-2
TRAIN_GRAD_BAND = 5e-2
# K10 and K11 against their plain versions (fp32 inside both; the outputs
# round to bf16 from values a few fp32 ulps apart): relative L2 (the card
# tests' bf16 band; an H100 measured at most 7.9e-5 there) and, for K10's
# probabilities (at most 1), one bf16 ulp at 1
SOFTMAX_L2_TOL = 5e-4
SOFTMAX_Y_TOL = 2.0 ** -8
# K2q against its plain version (fp32 inside both, the same dequantized
# products in another order): relative L2 (the card tests' bf16 band; an
# H100 measured at most 1.8e-5 there, in fp16)
K2Q_L2_TOL = 1e-4
TRAIN = dict(batch=8, seq=1024, warmup=2, timed=5, lr=1e-4)
# the LAMB window: examples/transformer/pretrain.py's make_optimizer for
# "lamb" (fused_lamb with its defaults, decay 0.01 and clip 1.0, and the
# lr group's eps 1e-8) and make_lr_schedule's warmup + cosine decay (2
# warm-up steps, decay over 100 to a tenth), computed on the device count
LAMB = dict(lr=5e-3, min_lr=5e-4, warmup_iters=2, decay_iters=100,
            weight_decay=0.01, max_grad_norm=1.0, eps=1e-8)
# K13 and K15 against their plain versions at GPT-2-small's 148 leaves:
# the largest error over a tensor's largest magnitude (the card tests'
# bands, tests/port/test_torch_kernels_cuda.py MT_NORM_TOL, MT_LAMB_TOL;
# an H100 measured 9.9e-8 and 1.2e-7 here)
MT_NORM_TOL = 2e-6
MT_LAMB_TOL = 5e-6
# the spin before a timed K12 launch (~2 ms): its wrapper allocates an
# output a leaf (148 at GPT-2-small), ~0.3 ms of host
MT_SPIN = 4_000_000
# and before a timed K14 or K15 launch (~20 ms): their wrappers check and
# table the whole list before their one launch, which at BERT-large's 302
# leaves took longer than MT_SPIN on an H100's host and leaked into K15's
# time there
MT_LIST_SPIN = 40_000_000
# the head dims the attention kernels run at besides the main path's 64,
# each at a training shape of a model that has it, (batch, heads, seq),
# bf16, causal: 80 (GPT-3 2.7B: 32 heads; zero-padded to the kernels' 128)
# and 256 (GPT-J-6B's 16 heads; K1 and, since PR 12, K5/K6 on the tensor
# cores; fp32 K5/K6 there are timed too, on the CUDA cores)
ATTN_HEAD_DIM_SHAPES = {80: (2, 32, 1024), 256: (2, 16, 1024)}
# K5/K6 in fp32 against their plain version (the card tests' fp32 band,
# tests/port/test_torch_kernels_cuda.py L2_TOL)
FP32_L2_TOL = 5e-6
# decode's other head dims at the serving lengths (the kernels' buckets
# 128 and 256 run them unpadded)
DECODE_HEAD_DIMS = (80, 256)
# layer-norm widths beside the main path's 768, at rows = 8192: 100 (not a
# multiple of 8: the rows body's 8-byte vectors), 12288 (GPT-3 175B's
# d_model: the wide body) and 12800, the row of a (64, 200) normalized
# shape (past the wide body's registers)
LN_WIDTHS = (100, 12288, (64, 200))
# GPT-3 2.7B's widths (Brown et al. 2020, "Language Models are Few-Shot
# Learners", Table 2.1, "GPT-3 2.7B": n_layers 32, d_model 2560, n_heads 32,
# d_head 80, d_ff = 4 d_model, context 2048) over GPT-2's vocabulary padded
# to 50304, random weights from a torch seed; depth cut from 32 layers to 2
# to stay within the smoke's time
GPT3_2P7B = dict(hidden_size=2560, num_layers=2, num_attention_heads=32,
                 ffn_hidden_size=10240, vocab_size=50304,
                 max_position_embeddings=2048, hidden_dropout=0.0,
                 attention_dropout=0.0, apply_query_key_layer_scaling=False,
                 bf16=True)
GPT3_ENGINE = dict(num_slots=4, page_size=128, num_pages=72, max_seq=2048,
                   prefill_len=512)
GPT3_TRACE = dict(seed=1, n_requests=6, prompt_lo=16, prompt_hi=300,
                  new_lo=8, new_hi=24, mean_interarrival=0.5)
# GPT-J-6B's attention widths (EleutherAI's GPT-J-6B config: n_embd 4096,
# n_head 16, n_layer 28, rotary_dim 64, n_inner 4 x n_embd, vocab 50400)
# over the port's GPT-2-style blocks: learned positions instead of GPT-J's
# rotary embedding, the sequential block instead of its parallel one;
# random weights from a torch seed; depth cut from 28 layers to 2 for the
# smoke's time. Heads of 256: K1, K5/K6 (K1d, K5d/K6d with dropout) at
# their D = 256 bodies
GPTJ_6B = dict(hidden_size=4096, num_layers=2, num_attention_heads=16,
               ffn_hidden_size=16384, vocab_size=50400,
               max_position_embeddings=2048, hidden_dropout=0.0,
               attention_dropout=0.0, apply_query_key_layer_scaling=False,
               bf16=True)
# a model past the attention kernels' head dims: 2 layers of hidden 1280
# over 4 heads of 320, GPT-2's vocabulary padded to 50304; attention takes
# the scores route (K10/K11) in training and serving prefill, decode K2 at
# its 512 bucket
HD320 = dict(hidden_size=1280, num_layers=2, num_attention_heads=4,
             vocab_size=50304, max_position_embeddings=1024,
             hidden_dropout=0.0, attention_dropout=0.0,
             apply_query_key_layer_scaling=False, bf16=True)
# past the decode kernels' head dims (512): 2 layers of hidden 1152 over 2
# heads of 576 (no public model; the shape of the repair), GPT-2's
# vocabulary padded to 50304; prefill and decode both take the scores
# route (K10)
HD576 = dict(HD320, hidden_size=1152, num_attention_heads=2)
# the timed window of these two models: one warm-up step, then three
WIDE_WINDOW = dict(batch=2, warmup=1, timed=3)
# K7p's row partials against its plain version: the largest |diff| over
# max(1, the largest |value|) of each partial; the shards' dX (each
# rounded to bf16, then summed in bf16 as the ranks' all-reduce does)
# against K8's one rounding on the whole table, relative L2. An H100
# measured 3.2e-6 and 2.9e-3 at this phase's shape (the card tests' cases
# at most 3.6e-6 and 3.4e-3 in bf16)
XENT_PARTIAL_TOL = 1e-5
XENT_SHARD_DX_L2_TOL = 8e-3
# the long-row softmax kernels' key lengths (K10L/K11L; a ragged one and
# the longest the phase times)
LONG_SOFTMAX_KEYS = (5000, 8192)
# K10L's lengths with the leading dims of their bf16 scores (each ~100 M
# elements, or 5000's 63 M; fp32 runs on half the queries), at least one
# on each body of softmax_cuda.long_plan: in bf16 5000 and 8192 on the
# register body, 32768 on the shared-memory body, 200000 walking; in fp32
# 5000 and 8192 on the shared-memory body, 32768 and 200000 walking
LONG_SOFTMAX_BODIES = {5000: (1, 12, 1024), 8192: (1, 12, 1024),
                       32768: (1, 12, 256), 200000: (1, 1, 500)}
# K10L's fp32 bands, the card tests' (tests/port/test_torch_kernels_cuda.py
# SOFTMAX_TOL, SOFTMAX_L2_TOL): the largest |y diff| and relative L2
SOFTMAX_FP32_Y_TOL = 1e-6
SOFTMAX_FP32_L2_TOL = 5e-7
# tensor-parallel training: the size, GPT-2's vocabulary padded to a
# multiple of 128 x tp (pad_vocab_size(50257, 2)), so that each shard is
# whole 128-row tiles and the sharded fused head applies; the ranks' time
# limit
TP_SIZE = 2
TP_VOCAB = 50432
TP_TIMEOUT_S = 600

# BERT-large (Devlin et al. 2019, "BERT", BERT_LARGE: L 24, H 1024, A 16),
# BASELINE config 3 as benchmarks/profile_pretrain.py:143-162 trains it:
# vocab 30592 (30522 padded to a multiple of 128), s = 512, b = 16, bf16,
# query-key layer scaling on (the default), fused_lamb(1e-4) with its
# defaults; random weights from torch seed 0, no depth cut. Window A is that
# config (dropout 0, an all-ones attention mask, as pretrain.py:157 and
# profile_pretrain.py:69 pass it): the scores path, K10 in mask mode. Window
# B pads each row to a seeded valid length, uniform over [128, 512] (mask 0
# and token 0 at the tail), with BERT's dropout 0.1 on both
# (arguments.py:81-82): the in-kernel segment-id route, K1d/K5d/K6d
BERT_LARGE = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
                  vocab_size=30592, max_position_embeddings=512, bf16=True)
BERT_TRAIN = dict(batch=16, seq=512, warmup=2, timed=5, lr=1e-4,
                  min_valid=128)
# the paths-agree steps at BERT-large's width: 2 of its 24 layers, b = 2
BERT_AGREE = dict(layers=2, batch=2)

# the serving configuration the repo benchmarks (GPT-2 small)
# ResNet-50 (BASELINE configs 1-2: examples/imagenet/main_amp.py's recipe,
# fused_sgd lr 0.1 on make_lr_schedule over ImageNet's 5004 steps an epoch
# at b = 256, momentum 0.9, weight decay 1e-4), synthetic 224^2 images
RESNET = dict(batch=256, image=224, classes=1000, warmup=2, timed=5, lr=0.1,
              momentum=0.9, weight_decay=1e-4, len_epoch=1281167 // 256)
# config 2 at world 2: b = 32 a rank, O2, SyncBatchNorm over the group
RESNET_DDP = dict(world=2, batch=32, steps=3, seed=3, timeout_s=420)
# relative L2 of R-DDP's averaged gradients against the mean of the ranks'
# own: at world 2 one fp32 add and a halving, the same bits in any order
DDP_GRAD_TOL = 1e-6
# kernel vs plain path at full width: b = 8, one O0 and one O2 step; K16
# against the plain SGD over 7 steps of real gradients, step 4's loss
# scale inf
RESNET_AGREE = dict(batch=8, sgd_steps=7, overflow_step=3)
# K17 / K18 against their plain versions at ResNet-50's twelve batch-norm
# shapes at b = 256, 224^2 (NCHW, as rows [N H W, C] in channels_last;
# models/resnet.py: the stride on conv2, 3/4/6/3 blocks), bf16, each with
# the norms a step holds at it (53 in all), and one fp32 shape; the
# 64-channel ones take the fused ReLU (bn_init's and the bn1/bn2 of a
# stage-0 block)
BN_STEP_SHAPES = (((256, 64, 112, 112), 1), ((256, 256, 56, 56), 4),
                  ((256, 128, 56, 56), 1), ((256, 512, 28, 28), 5),
                  ((256, 64, 56, 56), 6), ((256, 256, 28, 28), 1),
                  ((256, 1024, 14, 14), 7), ((256, 128, 28, 28), 7),
                  ((256, 512, 14, 14), 1), ((256, 2048, 7, 7), 4),
                  ((256, 256, 14, 14), 11), ((256, 512, 7, 7), 5))
BN_MAIN_SHAPE = (256, 256, 56, 56)
BN_FP32_SHAPE = (32, 256, 56, 56)
# relative L2 of K17's y and K18's dx against the plain versions, and the
# sums, saved mean and rstd over their largest magnitude (the card tests'
# bands, tests/port/test_torch_kernels_cuda.py BN_L2_TOL, BN_STAT_TOL; an
# H100 measured at most 8.9e-6 / 4.2e-8 for y, 0 for dx, 5.6e-7 for the
# sums at these shapes)
BN_L2_TOL = {torch.bfloat16: 5e-5, torch.float32: 3e-7}
BN_STAT_TOL = 3e-6
MODEL = dict(hidden_size=768, num_layers=12, num_attention_heads=12,
             vocab_size=50304, max_position_embeddings=1024,
             hidden_dropout=0.0, attention_dropout=0.0,
             apply_query_key_layer_scaling=False, bf16=True)
ENGINE = dict(num_slots=8, page_size=128, num_pages=72, max_seq=1024,
              prefill_len=512)
TRACE = dict(seed=0, n_requests=24, prompt_lo=16, prompt_hi=320,
             new_lo=16, new_hi=96, mean_interarrival=0.5)


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, flush, reps=20, spread=None, clean=False,
             spin=1_000_000):
    """Mean device time of ``fn`` over ``reps`` launches, each after an
    L2 flush, timed with CUDA events. A spin of ``spin`` cycles (~0.5 ms)
    on the stream before each timed launch lets the host queue all of
    ``fn``'s work first, so host overhead does not land inside the events
    (a wrapper with more host work than that takes a longer spin). A list
    passed as ``spread`` receives the launches' [min, median, max]. The
    flush writes its 128 MB, so the launch finds L2 full of dirty lines to
    write back as it streams; with ``clean`` it reads them instead, and
    the launch finds L2 cold and clean."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if spread is not None:
        spread[:] = [min(times), statistics.median(times), max(times)]
    return sum(times) / reps


def _time_in_turns(fn, lib_fn, flush, spread=None, spin=1_000_000):
    """``fn`` and one library call timed in turns, kernel, library,
    kernel (the library's time moves from call to call): the kernel's mean
    over its two turns, each turn's time, and the library's time."""
    turns = [_time_ms(fn, flush, spread=spread, spin=spin)]
    lib_ms = _time_ms(lib_fn, flush)
    turns.append(_time_ms(fn, flush, spin=spin))
    return statistics.mean(turns), turns, lib_ms


# with --parent DIR: the parent checkout's libraries of the sources whose
# kernels a slice redesigned, built with this build's flags
PARENT_SOURCES = ("xent", "softmax", "decode_attention", "layer_norm",
                  "attention_bwd", "qmatmul", "multi_tensor")
PARENT = {}
# the sources whose C entries differ from the parent's, and the parent's
# own wrapper module of each (loaded from its checkout; its K14 and K15
# take a group of capacity(4) tensors a launch, K15 two launches a group):
# its calls run on the parent's library, and its signatures load it
PARENT_WRAPPERS = {"multi_tensor": "apex_tpu_torch/ops/multi_tensor_cuda.py"}
PARENT_MODULES = {}


def _start_parent_build(root):
    """Start one ``nvcc`` per redesigned source of the parent checkout at
    ``root`` into ``build/apex_tpu_torch/parent/``, and load the parent's
    wrapper modules of ``PARENT_WRAPPERS``."""
    import importlib.util

    from apex_tpu_torch.ops import _build

    for name, rel in PARENT_WRAPPERS.items():
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(root, rel))
        PARENT_MODULES[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(PARENT_MODULES[name])

    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in PARENT_SOURCES:
        src = os.path.join(root, "apex_tpu_torch", "csrc", f"{name}.cu")
        lib = out / f"{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.flags(name), "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _finish_parent_build(procs):
    """Wait for the parent's builds and load each library with its
    wrapper's signatures, or with the parent's own where its C entries
    differ (``PARENT_WRAPPERS``)."""
    import ctypes

    from apex_tpu_torch.ops import (attention_bwd_cuda,
                                    decode_attention_cuda, layer_norm_cuda,
                                    qmatmul_cuda, softmax_cuda, xent_cuda)

    sigs = {"xent": xent_cuda._SIGNATURES,
            "qmatmul": qmatmul_cuda._SIGNATURES,
            "softmax": softmax_cuda._SIGNATURES,
            "decode_attention": decode_attention_cuda._SIGNATURES,
            "attention_bwd": attention_bwd_cuda._SIGNATURES,
            "layer_norm": layer_norm_cuda._SIGNATURES}
    for name, module in PARENT_MODULES.items():
        sigs[name] = module._SIGNATURES
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the parent's {name}.cu did not build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn_name, (argtypes, restype) in sigs[name].items():
            fn = getattr(cdll, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        PARENT[name] = cdll
    _log(f"parent build: {', '.join(PARENT)}")


def _as_parent(fn, name):
    """``fn`` run on the parent's library of source ``name``, through the
    same wrappers (the parent's wrappers, its grid rules included, are
    this tree's)."""
    from apex_tpu_torch.ops import _build

    def run():
        with mock.patch.dict(_build._libs, {name: PARENT[name]}):
            return fn()
    return run


def _turns(fn, lib_fn, flush, source, spread=None, parent_fn=None,
           spin=1_000_000):
    """``fn`` timed in turns around one library call, kernel, library,
    kernel, and, with ``--parent``, the parent's kernel (``parent_fn``, by
    default ``fn`` on the parent's library where its C entries are this
    tree's, not in ``PARENT_WRAPPERS``) before and after them: ``{"ms":
    the kernel's mean, "ms_turns", "library_ms", "parent_ms",
    "parent_ms_turns"}``."""
    parent = None
    if source in PARENT:
        parent = parent_fn or (None if source in PARENT_WRAPPERS
                               else _as_parent(fn, source))
    out = {}
    if parent:
        out["parent_ms_turns"] = [_time_ms(parent, flush, spin=spin)]
    out["ms"], out["ms_turns"], out["library_ms"] = _time_in_turns(
        fn, lib_fn, flush, spread=spread, spin=spin)
    if parent:
        out["parent_ms_turns"].append(_time_ms(parent, flush, spin=spin))
        out["parent_ms"] = statistics.mean(out["parent_ms_turns"])
    return out


def _bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S, int_ops=0):
    """The least time (ms) for the work and what sets it: the bytes over
    the memory rate, the floating-point operations over their peak rate,
    or (the dropout kernels) the hash's integer operations over the INT32
    rate, whichever is largest."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / flops_per_s * 1e3,
             "hash": int_ops / INT32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def _rel_err(out, ref):
    """max |out - ref| over ref's largest magnitude (at least 1)."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return ((out - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


def _max_err(out, ref):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out - ref).abs().max().item()


def _rel_l2(out, ref):
    """||out - ref|| / ||ref||: an error the size of the typical element
    shows here even where a few elements are much larger."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return ((out - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def phase_prefill_kernel(dev, flush):
    """K1 at S=512, H=12, d=64 with 3 packed segments plus padding."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention, attention_cuda

    H, S, D = 12, 512, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(1, H, S, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seg = torch.zeros(1, S, dtype=torch.int32, device=dev)
    for sid, (lo, hi) in enumerate(((0, 200), (200, 330), (330, 471)), 1):
        seg[0, lo:hi] = sid           # 471..511 is padding on segment 0
    scale = D ** -0.5
    tol = 5e-2  # bf16 outputs (half ulp 7.8e-3 at |o| < 4, each side) and
    #             both sides round the probabilities to bf16 before the
    #             value product, at different scales (up to 2^-8 relative
    #             of sum p|v| each)
    before = attention_cuda.prefill_attention.launches
    out = attention_cuda.prefill_attention(
        q, k, v, causal=True, sm_scale=scale, segment_ids=(seg, seg))
    if attention_cuda.prefill_attention.launches != before + 1:
        raise AssertionError("prefill kernel launch was not counted")
    ref = attention._dense_attention(q, k, v, True, scale, (seg, seg))
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    _log(f"prefill_attention: max_abs_err {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"prefill kernel disagrees: {err} > {tol}")

    pos = torch.arange(S, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (seg[0][None, :]
                                                == seg[0][:, None])
    spread = []
    mask = allowed[None, None]
    ms, turns, lib_ms = _time_in_turns(
        lambda: attention_cuda.prefill_attention(
            q, k, v, causal=True, sm_scale=scale, segment_ids=(seg, seg)),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=scale),
        flush, spread=spread)
    plain_ms = _time_ms(lambda: attention._dense_attention(
        q, k, v, True, scale, (seg, seg)), flush)
    nbytes = 4 * q.numel() * q.element_size() + 2 * seg.numel() * 4
    flops = 4 * H * D * int(allowed.sum().item())   # QK^T and PV, live pairs
    bound_ms, bound_by = _bound(nbytes, flops)
    return {
        "name": "prefill_attention", "route": "cuda",
        "source": "apex_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "apex_tpu/ops/attention_pallas.py:230",
        "shape": f"q,k,v [1,{H},{S},{D}] bf16, 3 segments + padding",
        "max_abs_err": err, "tol": tol, "ms": ms, "ms_turns": turns,
        "kernel_ms": ms, "ms_spread": spread, "plain_ms": plain_ms,
        "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention, boolean mask",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops}


# the serving shape of the decode phases: 8 slots at these lengths, 12
# heads, page size 128, 72 pages, 8 pages a slot
DECODE_LENGTHS = [0, 1, 127, 128, 129, 1024, 513, 300]


def _decode_inputs(dev, d, seed):
    """q [8, 12, d] and bf16 pages [12, 72, 128, d] drawn from ``seed``,
    and a fragmented page table (never page 0) for ``DECODE_LENGTHS``."""
    B, H, PS, P, MAXP = len(DECODE_LENGTHS), 12, 128, 72, 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, d, generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(H, P, PS, d, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
    pt = torch.zeros(B, MAXP, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(DECODE_LENGTHS):
        for j in range(-(-n // PS)):
            pt[i, j] = int(perm[nxt]) + 1     # fragmented, never page 0
            nxt += 1
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    return q, kp, vp, pt.to(dev), lengths


def _quantized(kp, vp):
    """The int8 tier's codes and bf16 [h, pages] scales of bf16 pages, by
    the tier's own codec."""
    from apex_tpu_torch.serving import kv_tier

    scales = [(t.float().abs().amax(dim=(-2, -1)) / kv_tier.QMAX).to(
        torch.bfloat16) for t in (kp, vp)]
    k8, v8 = (kv_tier.quantize(t, sc) for t, sc in zip((kp, vp), scales))
    return k8, v8, scales[0], scales[1]


def _decode_bound(q, pt, lengths, page_bytes, scale_bytes=0):
    """The bytes bound of one decode call: the live K and V rows (and, for
    K2q, the live pages' scales), q read, out written, the table and the
    lengths; the operations two products (and two dequantizations) a
    live element."""
    H, d = q.shape[1], q.shape[2]
    tokens = int(lengths.sum().item())
    live_pages = sum(-(-int(n) // 128) for n in lengths.tolist())
    nbytes = (2 * tokens * H * d * page_bytes
              + 2 * live_pages * H * scale_bytes
              + 2 * q.numel() * q.element_size()
              + 4 * (pt.numel() + lengths.numel()))
    flops = (6 if scale_bytes else 4) * H * d * tokens
    return nbytes, flops, _bound(nbytes, flops)


def _repeatable(fn, name):
    """Two runs of one decode kernel give the same bits (the fixed-order
    combine, no floating-point atomics; the tickets reset by the run
    before)."""
    outs = [fn(), fn()]
    torch.cuda.synchronize()
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{name}: two runs do not give the same bits")


def _decode_head_dims(dev, flush, quant):
    """K2 (or K2q over the tier's codes) at ``DECODE_HEAD_DIMS`` on the
    serving lengths against the plain version (the K2 phase's bands):
    errors, the kernel's time, its bound and SDPA's over pre-gathered
    (and pre-dequantized) K/V."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attention, decode_attention_cuda
    from apex_tpu_torch.serving import kv_tier

    out_rows = {}
    for d in DECODE_HEAD_DIMS:
        q, kp, vp, pt, lengths = _decode_inputs(dev, d, 40 + d)
        scale = d ** -0.5
        if quant:
            k8, v8, ks, vs = _quantized(kp, vp)
            run = lambda: decode_attention_cuda.decode_attention_quant(  # noqa
                q, k8, v8, ks, vs, pt, lengths, sm_scale=scale)
            ref = decode_attention.decode_attention_reference(
                q, k8, v8, pt, lengths, scale, ks, vs)
            kd, vd = (kv_tier.dequantize(c, sc, torch.bfloat16)
                      for c, sc in ((k8, ks), (v8, vs)))
        else:
            run = lambda: decode_attention_cuda.decode_attention(  # noqa
                q, kp, vp, pt, lengths, sm_scale=scale)
            ref = decode_attention.decode_attention_reference(
                q, kp, vp, pt, lengths, scale)
            kd, vd = kp, vp
        out = run()
        torch.cuda.synchronize()
        err, l2 = _max_err(out, ref), _rel_l2(out, ref)
        if err > 2e-2 or l2 > K2Q_L2_TOL:
            raise AssertionError(f"decode kernel (int8 {quant}) at head dim "
                                 f"{d} disagrees: {err}, relative L2 {l2}")
        B, H, MAXP = q.shape[0], q.shape[1], pt.shape[1]
        kg = kd[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * 128, d)
        vg = vd[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * 128, d)
        live = (torch.arange(MAXP * 128, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        ms = _time_ms(run, flush)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kg, vg, attn_mask=live, scale=scale), flush)
        _, _, (bound_ms, bound_by) = _decode_bound(
            q, pt, lengths, 1 if quant else 2, 2 if quant else 0)
        out_rows[d] = {"max_abs_err": err, "rel_l2": l2, "tol": 2e-2,
                       "rel_l2_tol": K2Q_L2_TOL, "ms": ms,
                       "library_ms": lib_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        _log(f"decode (int8 {quant}) at head dim {d}: "
             + json.dumps(out_rows[d]))
    return out_rows


def _ptxas(source, *needles):
    """Registers and spill bytes ptxas reported for the kernels of one
    source's build whose mangled names hold every needle."""
    from apex_tpu_torch.ops import _build

    found, fn = {}, ""
    for line in _build.build_log.get(source, "").splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if entry:
            fn = entry.group(1)
        elif fn and all(n in fn for n in needles):
            if spill:
                found.setdefault(fn, {}).update(
                    spill_stores=int(spill.group(1)),
                    spill_loads=int(spill.group(2)))
            if used:
                found.setdefault(fn, {})["registers"] = int(used.group(1))
    return found


def phase_decode_kernel(dev, flush):
    """K2 at B=8, H=12, ps=128, 72 pages, mixed lengths incl. 0/1/127/
    128/129/1024: against the plain version, two runs bit for bit, timed
    in turns around SDPA over pre-gathered K/V (and, with ``--parent``,
    around the parent's kernel); then at the other head dims."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attention, decode_attention_cuda

    D, PS, MAXP = 64, 128, 8
    lengths_l = DECODE_LENGTHS
    q, kp, vp, pt, lengths = _decode_inputs(dev, D, 2)
    B, H = q.shape[:2]
    scale = D ** -0.5
    tol = 2e-2  # fp32 inside both; bf16 output, one ulp at |o| < 4
    before = decode_attention_cuda.decode_attention.launches
    out = decode_attention_cuda.decode_attention(q, kp, vp, pt, lengths,
                                                 sm_scale=scale)
    if decode_attention_cuda.decode_attention.launches != before + 1:
        raise AssertionError("decode kernel launch was not counted")
    ref = decode_attention.decode_attention_reference(q, kp, vp, pt,
                                                      lengths, scale)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    _log(f"decode_attention: max_abs_err {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"decode kernel disagrees: {err} > {tol}")
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("an inactive slot (length 0) must give 0")

    l2 = _rel_l2(out, ref)
    if l2 > K2Q_L2_TOL:
        raise AssertionError(f"decode kernel disagrees: relative L2 {l2}")

    def run():
        return decode_attention_cuda.decode_attention(q, kp, vp, pt, lengths,
                                                      sm_scale=scale)

    _repeatable(run, "decode_attention")
    spread = []
    # the yardstick attends over K/V gathered beforehand (gather excluded)
    kg = kp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    vg = vp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    live = (torch.arange(MAXP * PS, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    timed = _turns(run, lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=live, scale=scale), flush, "decode_attention",
        spread=spread)
    plain_ms = _time_ms(lambda: decode_attention.decode_attention_reference(
        q, kp, vp, pt, lengths, scale), flush)
    nbytes, flops, (bound_ms, bound_by) = _decode_bound(q, pt, lengths, 2)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "apex_tpu_torch/csrc/decode_attention.cu",
        "replaces": "apex_tpu/ops/decode_attention_pallas.py:142",
        "shape": (f"q [{B},{H},{D}] bf16, pages [{H},{kp.shape[1]},{PS},"
                  f"{D}], lengths {lengths_l}"),
        "max_abs_err": err, "tol": tol, "rel_l2": l2,
        "rel_l2_tol": K2Q_L2_TOL, **timed, "kernel_ms": timed["ms"],
        "ms_spread": spread, "plain_ms": plain_ms,
        "library": ("F.scaled_dot_product_attention over pre-gathered "
                    "contiguous K/V (gather excluded)"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
        "ptxas": _ptxas("decode_attention", "13__nv_bfloat16", "Li64E"),
        "by_head_dim": _decode_head_dims(dev, flush, quant=False)}


def phase_int8_decode_kernel(dev, flush):
    """K2q at the serving shape over the int8 KV tier: the K2 phase's
    lengths and fragmented page tables, the pages quantized by the tier's
    own codec under per-(page, head) bf16 scales. Held against its plain
    version, against K2 over the same pages before quantization (within
    the int8 tier's band), and a length-0 slot must give exact zeros."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attention, decode_attention_cuda
    from apex_tpu_torch.serving import kv_tier

    D, PS, MAXP = 64, 128, 8
    lengths_l = DECODE_LENGTHS
    q, kp, vp, pt, lengths = _decode_inputs(dev, D, 9)
    B, H, P = q.shape[0], q.shape[1], kp.shape[1]
    k8, v8, ks, vs = _quantized(kp, vp)
    scale = D ** -0.5
    tol = 2e-2  # fp32 inside both; bf16 output, one ulp at |o| < 4
    # the int8 tier against the unquantized pages: the JAX package's band
    # for this comparison (tests/test_kv_tier.py:197, d = 64, unit-normal
    # pages)
    tier_band = 0.12
    before = (decode_attention_cuda.decode_attention_quant.launches,
              decode_attention_cuda.decode_attention.launches)
    out = decode_attention_cuda.decode_attention_quant(
        q, k8, v8, ks, vs, pt, lengths, sm_scale=scale)
    if (decode_attention_cuda.decode_attention_quant.launches,
            decode_attention_cuda.decode_attention.launches) \
            != (before[0] + 1, before[1]):
        raise AssertionError("int8 decode kernel launch was not counted")
    ref = decode_attention.decode_attention_reference(q, k8, v8, pt, lengths,
                                                      scale, ks, vs)
    unq = decode_attention_cuda.decode_attention(q, kp, vp, pt, lengths,
                                                 sm_scale=scale)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    l2 = _rel_l2(out, ref)
    tier_err = _max_err(out, unq)
    _log(f"decode_attention_quant: max_abs_err {err:.3e} (tol {tol}), "
         f"relative L2 {l2:.3e} (tol {K2Q_L2_TOL}); against K2 over the "
         f"unquantized pages {tier_err:.3e} (band {tier_band})")
    if err > tol or l2 > K2Q_L2_TOL or tier_err > tier_band:
        raise AssertionError(f"int8 decode kernel disagrees: {err} > {tol}, "
                             f"{l2} > {K2Q_L2_TOL} or {tier_err} > "
                             f"{tier_band}")
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("an inactive slot (length 0) must give 0")

    def run():
        return decode_attention_cuda.decode_attention_quant(
            q, k8, v8, ks, vs, pt, lengths, sm_scale=scale)

    _repeatable(run, "decode_attention_quant")
    spread = []
    # the yardstick attends over K/V gathered and dequantized beforehand
    # (gather and dequantization excluded)
    kd, vd = (kv_tier.dequantize(c, sc, torch.bfloat16)
              for c, sc in ((k8, ks), (v8, vs)))
    kg = kd[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    vg = vd[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    live = (torch.arange(MAXP * PS, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    timed = _turns(run, lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=live, scale=scale), flush, "decode_attention",
        spread=spread)
    k2_ms = _time_ms(lambda: decode_attention_cuda.decode_attention(
        q, kp, vp, pt, lengths, sm_scale=scale), flush)
    plain_ms = _time_ms(lambda: decode_attention.decode_attention_reference(
        q, k8, v8, pt, lengths, scale, ks, vs), flush)
    # QK^T, PV and the two dequantizations
    nbytes, flops, (bound_ms, bound_by) = _decode_bound(q, pt, lengths, 1,
                                                        2)
    return {
        "name": "decode_attention_quant", "route": "cuda",
        "source": "apex_tpu_torch/csrc/decode_attention.cu",
        "replaces": "apex_tpu/ops/decode_attention_pallas.py:163",
        "shape": (f"q [{B},{H},{D}] bf16, int8 pages [{H},{P},{PS},{D}] "
                  f"with bf16 scales [{H},{P}], lengths {lengths_l}"),
        "max_abs_err": err, "tol": tol, "rel_l2": l2,
        "rel_l2_tol": K2Q_L2_TOL, "vs_unquantized_max_abs_err": tier_err,
        "vs_unquantized_band": tier_band, **timed,
        "kernel_ms": timed["ms"],
        "ms_spread": spread, "k2_ms_same_call": k2_ms, "plain_ms": plain_ms,
        "library": ("F.scaled_dot_product_attention over pre-gathered, "
                    "pre-dequantized contiguous K/V (gather and "
                    "dequantization excluded)"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
        "ptxas": _ptxas("decode_attention", "13__nv_bfloat16a", "Li64E"),
        "by_head_dim": _decode_head_dims(dev, flush, quant=True)}


def phase_softmax_kernels(dev, flush):
    """K10 and K11 at the scores path's training shape: x, g [8, 12, 1024,
    1024] bf16 (scores of unit-normal q, k at head_dim 64 have a standard
    deviation near 1; x is drawn at 3 to reach the far tail of exp), scale
    2.0 (layer 2's query-key layer scaling). K10 causal (the main path),
    with an explicit [8, 1, 1024, 1024] mask and with a key-padding [8, 1,
    1, 1024] mask, K11 on K10's causal y; each against its plain version
    by relative L2 (``SOFTMAX_L2_TOL``) and by the largest element error.
    ``FusedScaleMaskSoftmax`` with the key-padding mask must launch K10
    (it has no plain fallback on the card)."""
    from apex_tpu_torch.ops import softmax, softmax_cuda
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    B, H, S = TRAIN["batch"], 12, TRAIN["seq"]
    gen = torch.Generator(device=dev).manual_seed(10)
    x = (torch.randn(B, H, S, S, generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    g = torch.randn(B, H, S, S, generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.rand(B, 1, S, S, generator=gen, device=dev) < 0.3
    pad = torch.arange(S, device=dev)[None, None, None, :] >= torch.tensor(
        [S - 97 * i for i in range(B)], device=dev)[:, None, None, None]
    scale = 2.0
    y = softmax_cuda.softmax_fwd(x, None, scale, True)
    ym = softmax_cuda.softmax_fwd(x, mask, scale, False)
    fused = FusedScaleMaskSoftmax(False, True, AttnMaskType.padding, True,
                                  None, True, scale)
    before = softmax_cuda.softmax_fwd.launches
    yp = fused(x, pad)
    if softmax_cuda.softmax_fwd.launches != before + 1:
        raise AssertionError("FusedScaleMaskSoftmax with a key-padding mask "
                             "did not launch K10")
    dx = softmax_cuda.softmax_bwd(y, g, scale)
    errs = {}
    for name, out, ref_fn in (
            ("causal", y, lambda: softmax.scaled_masked_softmax_reference(
                x, None, scale, True)),
            ("mask", ym, lambda: softmax.scaled_masked_softmax_reference(
                x, mask, scale, False)),
            ("key_padding", yp,
             lambda: softmax.scaled_masked_softmax_reference(
                 x, pad, scale, False)),
            ("bwd", dx, lambda: softmax.scaled_masked_softmax_backward_reference(
                y, g, scale))):
        ref = ref_fn()
        torch.cuda.synchronize()
        # masked positions are exact zeros in y, and dx is zero wherever
        # y is (elsewhere a tiny dx may round to 0 on one side only)
        zero = (ref == 0) if name != "bwd" else (y == 0)
        errs[name] = {"max_abs_err": _max_err(out, ref),
                      "rel_l2": _rel_l2(out, ref),
                      "zeros_agree": bool(torch.equal(out == 0, zero)
                                          if name != "bwd"
                                          else (out[zero] == 0).all())}
        del ref, zero
    _log(f"softmax kernels: {errs} (tol relative L2 {SOFTMAX_L2_TOL}, max "
         f"|y diff| {SOFTMAX_Y_TOL})")
    for name, e in errs.items():
        if e["rel_l2"] > SOFTMAX_L2_TOL or not e["zeros_agree"] or (
                name != "bwd" and e["max_abs_err"] > SOFTMAX_Y_TOL):
            raise AssertionError(f"softmax kernel ({name}) disagrees with its "
                                 f"plain version: {e}")
    above = torch.arange(S, device=dev)[None, :] > torch.arange(
        S, device=dev)[:, None]
    if (y[..., above] != 0).any():
        raise AssertionError("K10 left a nonzero above the diagonal")

    # two runs of K10 in each mode give the same bits
    repeatable = {
        "causal": torch.equal(y, softmax_cuda.softmax_fwd(x, None, scale,
                                                          True)),
        "mask": torch.equal(ym, softmax_cuda.softmax_fwd(x, mask, scale,
                                                         False))}
    if not all(repeatable.values()):
        raise AssertionError(f"two K10 runs on the same inputs differ: "
                             f"{repeatable}")

    spreads = [[], [], []]
    bwd_ms = _time_ms(lambda: softmax_cuda.softmax_bwd(y, g, scale), flush,
                      spread=spreads[2])
    fwd_plain = _time_ms(lambda: softmax.scaled_masked_softmax_reference(
        x, None, scale, True), flush, reps=5)
    mask_plain = _time_ms(lambda: softmax.scaled_masked_softmax_reference(
        x, mask, scale, False), flush, reps=5)
    bwd_plain = _time_ms(
        lambda: softmax.scaled_masked_softmax_backward_reference(y, g, scale),
        flush, reps=5)
    # yardsticks: torch.softmax over the fp32-upcast input with the causal
    # or the explicit mask already applied (masking excluded), timed in
    # turns with K10 in that mode (and the parent's K10, with --parent),
    # and the softmax backward on the same y and g
    xm = torch.where(above, float("-inf"), x.float() * scale)
    fwd = _turns(lambda: softmax_cuda.softmax_fwd(x, None, scale, True),
                 lambda: torch.softmax(xm, dim=-1), flush, "softmax",
                 spread=spreads[0])
    xm = torch.where(mask, float("-inf"), x.float() * scale)
    masked = _turns(lambda: softmax_cuda.softmax_fwd(x, mask, scale, False),
                    lambda: torch.softmax(xm, dim=-1), flush, "softmax",
                    spread=spreads[1])
    del xm
    _log(f"softmax_fwd turns: causal {fwd}, mask {masked}")
    bwd_lib = _time_ms(lambda: torch._softmax_backward_data(
        g, y, -1, torch.bfloat16), flush)
    elems = B * H * S * S
    live = B * H * S * (S + 1) // 2
    # K10 causal reads only the live triangle of x (what this run's mask
    # needs) and writes every y; K11 reads y and g and writes dx
    fwd_bytes, mask_bytes = 2 * live + 2 * elems, 2 * elems + B * S * S + 2 * elems
    bwd_bytes = 3 * 2 * elems
    fwd_bound = _bound(fwd_bytes, 5 * live, FP32_FLOPS_PER_S)
    mask_bound = _bound(mask_bytes, 5 * elems, FP32_FLOPS_PER_S)
    bwd_bound = _bound(bwd_bytes, 4 * elems, FP32_FLOPS_PER_S)
    common = {"route": "cuda", "source": "apex_tpu_torch/csrc/softmax.cu",
              "shape": f"x, g [{B},{H},{S},{S}] bf16, scale {scale}",
              "rel_l2_tol": SOFTMAX_L2_TOL}
    return [
        dict(common, name="softmax_fwd",
             replaces="apex_tpu/ops/softmax_pallas.py:185",
             mode="causal (the scores path's)", **errs["causal"],
             tol=SOFTMAX_Y_TOL, **fwd, kernel_ms=fwd["ms"],
             ms_spread=spreads[0], plain_ms=fwd_plain,
             library=("torch.softmax over the fp32-upcast, pre-masked "
                      "scores (masking excluded)"),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], bytes=fwd_bytes,
             bound_fraction=fwd_bound[0] / fwd["ms"], flops=5 * live,
             bitwise_repeatable=repeatable,
             mask_mode={"mask": f"[{B},1,{S},{S}] bool, 30% masked",
                        **errs["mask"], **masked,
                        "ms_spread": spreads[1], "plain_ms": mask_plain,
                        "bound_ms": mask_bound[0],
                        "bound_by": mask_bound[1], "bytes": mask_bytes,
                        "bound_fraction": mask_bound[0] / masked["ms"]},
             key_padding_mode={"mask": f"[{B},1,1,{S}] bool, rows of "
                               f"{S} to {S - 97 * (B - 1)} live keys",
                               **errs["key_padding"]}),
        dict(common, name="softmax_bwd",
             replaces="apex_tpu/ops/softmax_pallas.py:212", **errs["bwd"],
             ms=bwd_ms, kernel_ms=bwd_ms, ms_spread=spreads[2],
             plain_ms=bwd_plain, library_ms=bwd_lib,
             library="torch._softmax_backward_data on the same y and g",
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], bytes=bwd_bytes,
             flops=4 * elems)]


def _long_softmax_fwd_at(dev, flush, sk, dtype, causal=False):
    """K10L at ``sk`` keys (``LONG_SOFTMAX_BODIES``), no mask (or the
    causal triangle, whose rows' tails are only written), scale 2.0:
    against its plain version (relative L2 and the largest element error,
    the bf16 or fp32 bands), two runs giving the same bits, and timed in
    turns around ``torch.softmax`` on the fp32-upcast scores and, with
    ``--parent``, the parent's K10L."""
    from apex_tpu_torch.ops import softmax, softmax_cuda

    lead = LONG_SOFTMAX_BODIES[sk]
    if dtype == torch.float32:
        lead = (*lead[:2], lead[2] // 2)
    scale = 2.0
    gen = torch.Generator(device=dev).manual_seed(sk)
    x = (torch.randn(*lead, sk, generator=gen, device=dev) * 3).to(dtype)
    run = lambda: softmax_cuda.softmax_fwd_long(  # noqa: E731
        x, None, scale, causal)
    y, again = run(), run()
    ry = softmax.scaled_masked_softmax_reference(x, None, scale, causal)
    torch.cuda.synchronize()
    y_tol, l2_tol = ((SOFTMAX_Y_TOL, SOFTMAX_L2_TOL) if dtype != torch.float32
                     else (SOFTMAX_FP32_Y_TOL, SOFTMAX_FP32_L2_TOL))
    out = {"shape": f"x [{','.join(map(str, lead))},{sk}] "
                    f"{str(dtype).split('.')[-1]}, "
                    f"{'causal' if causal else 'no mask'}, scale {scale}",
           "plan": softmax_cuda.long_plan(sk, x.element_size())._asdict(),
           "max_abs_err": _max_err(y, ry), "rel_l2": _rel_l2(y, ry),
           "tol": y_tol, "rel_l2_tol": l2_tol,
           "same_bits_twice": torch.equal(y, again)}
    del y, again, ry
    if out["max_abs_err"] > y_tol or out["rel_l2"] > l2_tol \
            or not out["same_bits_twice"]:
        raise AssertionError(f"K10L at {sk} keys ({dtype}) disagrees with "
                             f"its plain version or repeats unequal: {out}")
    xs = x.float() * scale
    spread = []
    out.update(_turns(run, lambda: torch.softmax(xs, dim=-1), flush,
                      "softmax", spread=spread))
    del xs
    elems = x.numel()
    # what the function needs: the live keys read (under the causal
    # triangle query row i has min(sk, i + 1)) and the whole row written,
    # the arithmetic over the live keys
    sq = lead[-1]
    live = elems if not causal else elems // (sq * sk) * sum(
        min(sk, i + 1) for i in range(sq))
    nbytes = (live + elems) * x.element_size()
    bound = _bound(nbytes, 5 * live, FP32_FLOPS_PER_S)
    out.update(ms_spread=spread, plain_ms=_time_ms(
        lambda: softmax.scaled_masked_softmax_reference(x, None, scale,
                                                        causal), flush, reps=5),
        bound_ms=bound[0], bound_by=bound[1], bytes=nbytes, flops=5 * live,
        live_keys=live)
    _log(f"K10L at {sk} keys, {dtype}{', causal' if causal else ''}: "
         + json.dumps(out))
    del x
    torch.cuda.empty_cache()
    return out


def phase_long_softmax_kernels(dev, flush):
    """K10L and K11L, the generic softmax's rows over 4096 keys. K10L at
    every length of ``LONG_SOFTMAX_BODIES`` (each body of its plan) in
    bf16 and fp32, and at 8192 keys causal (``_long_softmax_fwd_at``); its
    row is [1, 12, 1024, 8192] bf16, the others under ``by_length``. K11L on x, g [1, 12,
    1024, 8192] bf16 (16-byte vectors) and the ragged [1, 12, 1024, 5000],
    no mask, scale 2.0, against its plain version by relative L2
    (``SOFTMAX_L2_TOL``) and the largest element error, timed against
    ``torch._softmax_backward_data``."""
    from apex_tpu_torch.ops import softmax, softmax_cuda

    dtypes = (("bf16", torch.bfloat16), ("fp32", torch.float32))
    by_length = {f"{sk} {name}": _long_softmax_fwd_at(dev, flush, sk, dtype)
                 for sk in LONG_SOFTMAX_BODIES for name, dtype in dtypes}
    sk = LONG_SOFTMAX_KEYS[-1]
    for name, dtype in dtypes:
        by_length[f"{sk} {name} causal"] = _long_softmax_fwd_at(
            dev, flush, sk, dtype, causal=True)
    main = by_length.pop(f"{LONG_SOFTMAX_KEYS[-1]} bf16")
    fwd_row = dict(
        main, name="softmax_fwd_long", route="cuda",
        source="apex_tpu_torch/csrc/softmax.cu",
        replaces="apex_tpu/ops/softmax_pallas.py:185", kernel_ms=main["ms"],
        library="torch.softmax over the fp32-upcast scores",
        ragged_5000=by_length[f"{LONG_SOFTMAX_KEYS[0]} bf16"],
        by_length=by_length)

    H, S = 12, TRAIN["seq"]
    scale = 2.0
    rows = []
    for sk in LONG_SOFTMAX_KEYS:
        gen = torch.Generator(device=dev).manual_seed(sk)
        x = (torch.randn(1, H, S, sk, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        g = torch.randn(1, H, S, sk, generator=gen, device=dev).to(
            torch.bfloat16)
        y = softmax_cuda.softmax_fwd_long(x, None, scale, False)
        dx = softmax_cuda.softmax_bwd_long(y, g, scale)
        rdx = softmax.scaled_masked_softmax_backward_reference(y, g, scale)
        torch.cuda.synchronize()
        errs = {"max_abs_err": _max_err(dx, rdx), "rel_l2": _rel_l2(dx, rdx)}
        del rdx
        _log(f"K11L, sk={sk}: {errs} (tol relative L2 {SOFTMAX_L2_TOL})")
        if errs["rel_l2"] > SOFTMAX_L2_TOL:
            raise AssertionError(f"K11L disagrees with its plain version at "
                                 f"sk={sk}: {errs}")
        spread = []
        bwd_ms = _time_ms(lambda: softmax_cuda.softmax_bwd_long(
            y, g, scale), flush, spread=spread)
        bwd_plain = _time_ms(
            lambda: softmax.scaled_masked_softmax_backward_reference(
                y, g, scale), flush, reps=5)
        bwd_lib = _time_ms(lambda: torch._softmax_backward_data(
            g, y, -1, torch.bfloat16), flush)
        elems = H * S * sk
        bwd_bound = _bound(3 * 2 * elems, 4 * elems, FP32_FLOPS_PER_S)
        rows.append(dict(
            name="softmax_bwd_long", route="cuda",
            source="apex_tpu_torch/csrc/softmax.cu",
            shape=f"x, g [1,{H},{S},{sk}] bf16, no mask, scale {scale}",
            rel_l2_tol=SOFTMAX_L2_TOL,
            replaces="apex_tpu/ops/softmax_pallas.py:212", **errs, ms=bwd_ms,
            kernel_ms=bwd_ms, ms_spread=spread, plain_ms=bwd_plain,
            library_ms=bwd_lib,
            library="torch._softmax_backward_data on the same y and g",
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1], bytes=6 * elems,
            flops=4 * elems))
        del x, g, y, dx
        torch.cuda.empty_cache()
    # the main row is the longest; the ragged length rides along in it
    bwd_row, ragged = rows[-1], rows[0]
    bwd_row["ragged_5000"] = {k: ragged[k] for k in (
        "max_abs_err", "rel_l2", "ms", "ms_spread", "plain_ms",
        "library_ms", "bound_ms", "bound_by")}
    return [fwd_row, bwd_row]


def phase_generic_softmax_path(dev):
    """The path the long-row kernels serve: ``GenericFusedScaleMaskSoftmax``
    (bf16 input, fp32 softmax, scale 2.0) forward and backward on scores
    ``[1, 12, 1024, 8192]``, a user's call at its default
    ``use_pallas=True``. It must launch K10L and K11L once each and no
    other counted kernel; the counts are read around this call alone."""
    from apex_tpu_torch.transformer.functional import (
        GenericFusedScaleMaskSoftmax)

    sk = LONG_SOFTMAX_KEYS[-1]
    gen = torch.Generator(device=dev).manual_seed(17)
    x = (torch.randn(1, 12, TRAIN["seq"], sk, generator=gen, device=dev)
         * 3).to(torch.bfloat16).requires_grad_()
    g = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    module = GenericFusedScaleMaskSoftmax(False, True, None, True, 2.0)
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    y = module(x, None)
    y.backward(g)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    want = dict.fromkeys(counts, 0)
    want.update(softmax_fwd_long=1, softmax_bwd_long=1)
    _log(f"generic softmax over {sk} keys: launches {launches}")
    if launches != want or not torch.isfinite(x.grad.float()).all():
        raise AssertionError(f"the generic softmax over {sk} keys launched "
                             f"{launches}, want {want}")
    return launches


def _xent_combine(parts, eps, v_total):
    """The shards' row partials combined in rank order, as the
    cross-rank combine of ``linear_cross_entropy_sharded`` does it:
    ``(loss, lse)``."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    total = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    t = sum(p[2] for p in parts)
    lse = m + torch.log(total)
    if eps:
        u = sum(p[3] for p in parts)
        return lse - (1.0 - eps) * t - eps * u / v_total, lse
    return lse - t, lse


def phase_xent_shard_kernels(dev, flush):
    """K7p with K8 and K9 on the two vocabulary shards of the tp = 2
    training shape: x [8192, 768] bf16, E [50432, 768] (GPT-2's
    vocabulary padded for tp = 2) split into shards of 25216 rows,
    shard-local labels. K7p on each shard against its plain version
    (``XENT_PARTIAL_TOL``); the shards' partials combined in rank order in
    torch against K7 on the whole table (``XENT_LOSS_TOL``,
    ``XENT_LOSS_L2_TOL``); K8 and K9 on each shard with ``v_total`` =
    50432, at label smoothing 0 and 0.1, the shards' dX summed against K8
    and their dE stacked against K9 on the whole table
    (``XENT_SHARD_DX_L2_TOL``, ``BF16_L2_TOL``). K7p is timed on one
    shard, as a rank launches it, in turns around its library calls."""
    from apex_tpu_torch.ops import xent, xent_cuda

    n = TRAIN["batch"] * TRAIN["seq"]
    V, h, tp = TP_VOCAB, MODEL["hidden_size"], 2
    vs = V // tp
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    e = (torch.randn(V, h, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    dl = (torch.rand(n, generator=gen, device=dev) + 0.5) * (2.0 ** 16 / n)
    shards = [(e[r * vs:(r + 1) * vs], labels - r * vs) for r in range(tp)]
    errs = {"partials": 0.0}
    for eps in (0.0, 0.1):
        loss, lse = xent_cuda.xent_fwd(x, e, labels, eps)
        parts = []
        for es, local in shards:
            p = xent_cuda.xent_fwd_partials(x, es, local, eps)
            ref = torch.stack(xent.linear_cross_entropy_partials(
                x, es, local, eps))
            torch.cuda.synchronize()
            if not torch.isfinite(p).all():
                raise AssertionError("K7p partials are not finite")
            errs["partials"] = max(errs["partials"], (
                (p - ref).abs().amax(dim=1)
                / ref.abs().amax(dim=1).clamp(min=1.0)).max().item())
            parts.append(p)
        sloss, slse = _xent_combine(parts, eps, V)
        dx = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl, eps)
        de = xent_cuda.xent_bwd_de(x, e, labels, lse, dl, eps)
        dx_sum, de_parts = None, []
        for es, local in shards:
            d = xent_cuda.xent_bwd_dx(x, es, local, slse, dl, eps, v_total=V)
            dx_sum = d if dx_sum is None else dx_sum + d
            de_parts.append(xent_cuda.xent_bwd_de(x, es, local, slse, dl, eps,
                                                  v_total=V))
        torch.cuda.synchronize()
        errs[f"eps_{eps}"] = {
            "loss_max_abs_err": max(_max_err(sloss, loss),
                                    _max_err(slse, lse)),
            "loss_rel_l2": max(_rel_l2(sloss, loss), _rel_l2(slse, lse)),
            "dx_sum_rel_l2": _rel_l2(dx_sum, dx),
            "de_cat_rel_l2": _rel_l2(torch.cat(de_parts), de)}
        del dx, de, dx_sum, de_parts
    _log(f"xent shards (tp=2, V={V}): {errs} (tol partials "
         f"{XENT_PARTIAL_TOL}, loss {XENT_LOSS_TOL} / {XENT_LOSS_L2_TOL}, "
         f"dX summed {XENT_SHARD_DX_L2_TOL}, dE {BF16_L2_TOL})")
    if errs["partials"] > XENT_PARTIAL_TOL:
        raise AssertionError(f"K7p disagrees with its plain version: {errs}")
    for eps in (0.0, 0.1):
        err = errs[f"eps_{eps}"]
        if (err["loss_max_abs_err"] > XENT_LOSS_TOL
                or err["loss_rel_l2"] > XENT_LOSS_L2_TOL
                or err["dx_sum_rel_l2"] > XENT_SHARD_DX_L2_TOL
                or err["de_cat_rel_l2"] > BF16_L2_TOL):
            raise AssertionError(f"the shards combined disagree with K7-K9 "
                                 f"on the whole table (eps {eps}): {err}")

    es, local = shards[0]
    spread = []
    plain_ms = _time_ms(lambda: xent.linear_cross_entropy_partials(
        x, es, local), flush, reps=3)
    hit = (local >= 0) & (local < vs)
    idx = local.clamp(0, vs - 1).long()[:, None]

    def library():
        logits = x @ es.t()
        return (logits.amax(dim=1), torch.logsumexp(logits.float(), dim=1),
                torch.where(hit, logits.gather(1, idx)[:, 0].float(), 0.0))

    # in turns: K7p, the library's calls, K7p (and the parent's K7p)
    turns = _turns(lambda: xent_cuda.xent_fwd_partials(x, es, local),
                   library, flush, "xent", spread=spread)
    _log(f"xent_fwd_partials turns: {turns}")
    nbytes = n * h * 2 + vs * h * 2 + n * 4 + 4 * n * 4
    flops = 2 * n * vs * h
    bound_ms, bound_by = _bound(nbytes, flops)
    err0 = errs["eps_0.0"]
    return {"name": "xent_fwd_partials", "route": "cuda",
            "source": "apex_tpu_torch/csrc/xent.cu",
            "replaces": "apex_tpu/ops/xent_pallas.py:339",
            "shape": f"x [{n},{h}] bf16, E shard [{vs},{h}] bf16 (tp={tp} "
                     f"of V={V}), shard-local int32 labels",
            "max_abs_err": err0["loss_max_abs_err"],
            "partials_max_err": errs["partials"], **errs,
            "tol": XENT_LOSS_TOL, "rel_l2_tol": XENT_LOSS_L2_TOL,
            **turns, "kernel_ms": turns["ms"], "ms_spread": spread,
            "plain_ms": plain_ms,
            "library": ("x @ E_shard.T, then the row max, "
                        "torch.logsumexp and the gathered target"),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for t in cache.values())


def _drive_trace(engine, reqs):
    """Serve ``reqs`` to completion, each submitted when its arrival tick
    (counted from now) is due, round by round; returns the wall seconds
    (ending in a synchronize) and the wall of each round that decoded
    and prefilled nothing."""
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    tick0 = engine.tick
    settled = len(engine.scheduler.completed)
    decode_round_s = []
    t0 = time.perf_counter()
    while len(engine.scheduler.completed) - settled < len(reqs):
        if engine.tick - tick0 > 5000:
            raise AssertionError("trace did not drain")
        due = [r for r in pending if r.arrival <= engine.tick - tick0]
        pending = pending[len(due):]
        r0 = time.perf_counter()
        res = engine.step(arrivals=due)
        if not res["prefilled"] and res["decoded_slots"]:
            decode_round_s.append(time.perf_counter() - r0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, decode_round_s


# every profiled window opens on PRIMER_LAUNCHES throwaway kernels
# (torch.cuda._sleep(0)'s, which _device_events leaves out of every count)
# and runs again, up to PROFILE_ATTEMPTS times in all, while the profiler
# lost a kernel record after them (see _profiled)
PRIMER_LAUNCHES = 256
PRIMER_KERNEL = re.compile(r"\bspin_kernel\(")
LAUNCH_API = re.compile(r"LaunchKernel|GraphLaunch")
PROFILE_ATTEMPTS = 3


def _profiled(fn, cpu=True, attempts=PROFILE_ATTEMPTS):
    """Run ``fn()`` under torch.profiler over the device (and the host's
    ops with ``cpu``); returns the profiler, ``fn``'s result and the
    kernel records that the window lost.

    Late in this smoke, after the serving phases, the profiler loses the
    first kernel records of a window: their launches are in its trace,
    their kernels are not. Mostly a few are lost, now and then more than
    64; a training window then saw 23 of its 24 K1 or K10 kernels, a
    traced serve now and then 7 of its 8 K1. A pause before the work does
    not help. So each window opens on ``PRIMER_LAUNCHES`` throwaway
    kernels, waited for, to absorb the loss; a window that still lost a
    record after them (a launch whose kernel is not in the trace) is
    logged and run again, ``fn`` called anew, up to ``attempts`` times in
    all."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(PRIMER_LAUNCHES):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        lost = _lost_records(prof)
        if not lost:
            break
        _log(f"profiled window, attempt {attempt + 1} of {attempts}: the "
             f"profiler lost {lost} kernel records after the primer")
    return prof, out, lost


def _lost_records(prof):
    """The kernel launches of a profiled window, the primer's left out,
    whose kernels are missing from its trace (a graph's launch counts
    as one, with its kernels)."""
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = sorted((e for e in events
                       if e.device_type() == torch.autograd.DeviceType.CPU
                       and LAUNCH_API.search(e.name())),
                      key=lambda e: e.start_ns())
    return sum(1 for e in launches[PRIMER_LAUNCHES:]
               if e.correlation_id() not in kernels)


def _device_events(prof):
    """A profiled window's device events by name (``key_averages()``),
    the user annotations and the primer's kernels left out."""
    return [evt for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.is_user_annotation
            and not PRIMER_KERNEL.search(evt.key)]


def _fresh_copies(reqs):
    """A function that returns ``reqs`` at its first call and a new copy
    of them at each later one, the rids moved on by 10**5 a call, so that
    a profiled serve run again serves requests the engine has not seen."""
    pristine = copy.deepcopy(reqs)
    calls = itertools.count()

    def make():
        n = next(calls)
        return _offset_rids(copy.deepcopy(pristine), 10**5 * n) if n else reqs

    return make


# the counted wrappers' kernels by their names in a device trace, so that
# the kernels a CUDA graph replays (which call no wrapper) can be counted:
# K1 is prefill_attention_{tc,simt} with DROPOUT = false, K2 and K2q the
# QUANT = false / true instantiations of decode_attention_split
TRACED_KERNELS = {
    "prefill_attention": r"prefill_attention_(tc|simt)<[^>]*\bfalse>",
    "decode_attention": r"decode_attention_split<[^>]*\bfalse>",
    "decode_attention_quant": r"decode_attention_split<[^>]*\btrue>",
    "softmax_fwd": r"softmax_fwd_kernel<",
    "softmax_fwd_long": r"softmax_fwd_long_(regs|smem|walk)<",
    "batch_norm_fwd_one": r"bn_fwd_kernel<",
    "batch_norm_bwd_one": r"bn_bwd_kernel<",
    "batch_norm_fwd_stats": r"bn_stats_kernel<[^>]*\bfalse>",
    "batch_norm_fwd_apply": r"bn_fwd_apply_kernel<",
    "batch_norm_bwd_stats": r"bn_stats_kernel<[^>]*\btrue>",
    "batch_norm_bwd_apply": r"bn_bwd_apply_kernel<",
    "multi_tensor_sgd": r"\bsgd_kernel<",
    "qmatmul": r"\bqmatmul_kernel<",
}


def _count_traced(prof):
    """The device kernels of each ``TRACED_KERNELS`` wrapper in a
    profiled window, counted by name."""
    out = dict.fromkeys(TRACED_KERNELS, 0)
    for evt in _device_events(prof):
        for name, pattern in TRACED_KERNELS.items():
            if re.search(pattern, evt.key):
                out[name] += evt.count
    return out


def _traced_serve(engine, reqs):
    """Serve ``reqs`` (arrival ticks counted from now) under
    torch.profiler: the kernels the device ran, by name
    (``_count_traced``: a graph's replayed kernels included), and the
    prefill batches and decode dispatches of that run. Raises if the
    profiler saw no device kernel."""
    make = _fresh_copies(reqs)

    def serve():
        base = (engine.prefill_batches, engine.decode_steps)
        _drive_trace(engine, make())
        return (engine.prefill_batches - base[0],
                engine.decode_steps - base[1])

    prof, rounds, _ = _profiled(serve)
    traced = _count_traced(prof)
    if not any(traced.values()):
        raise AssertionError("the profiler saw none of the counted kernels "
                             "run on the device")
    return traced, rounds


def _decode_calls(engine):
    """The decode steps that went through the kernel wrappers since the
    engine was built: a graphed engine calls its decode program eagerly
    twice (the warm-up and the capture; a replay calls no wrapper), an
    eager one once a dispatch; K steps a call."""
    calls = 2 if engine._graph is not None else engine.decode_steps
    return calls * engine.decode_k


def _offset_rids(reqs, by):
    for r in reqs:
        r.rid += by     # rids stay unique in the engine's event log
    return reqs


def phase_end_to_end(dev, kv_quant=False):
    """Serve the synthetic trace through ServingEngine (over the int8 KV
    tier with ``kv_quant``), timed, then the same trace again under
    torch.profiler; returns the engine, the wrappers' launch counts from
    the engine's construction on (its graphed decode program calls the
    decode wrapper at its warm-up and its capture only), and the numbers
    of the timed run with the traced run's kernel counts, which must be
    ``prefill_batches x 12`` (K1) and ``decode_steps x 12`` (K2 or K2q)
    of that run."""
    from apex_tpu_torch.ops import attention_cuda, decode_attention_cuda
    from apex_tpu_torch.serving import (ServingEngine, lifecycle,
                                        synthetic_trace)
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**MODEL)
    counted = {"prefill_attention": attention_cuda.prefill_attention,
               "decode_attention": decode_attention_cuda.decode_attention,
               "decode_attention_quant":
                   decode_attention_cuda.decode_attention_quant}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, seed=0, device=dev, kv_quant=kv_quant,
                           **ENGINE)
    torch.cuda.synchronize()
    _log(f"engine (kv_quant={kv_quant}) built in "
         f"{time.perf_counter() - t0:.2f} s")
    # warm-up (cuBLAS handles, allocator) on requests outside the trace
    engine.run_trace(_warmup_requests())

    reqs, trace_id = synthetic_trace(vocab=cfg.vocab_size, **TRACE)
    base = (engine.prefill_batches, engine.decode_steps,
            engine.tokens_generated)
    wall, decode_round_s = _drive_trace(engine, reqs)
    prefills = engine.prefill_batches - base[0]
    decodes = engine.decode_steps - base[1]
    tokens = engine.tokens_generated - base[2]
    traced, (t_prefills, t_decodes) = _traced_serve(
        engine, _offset_rids(synthetic_trace(vocab=cfg.vocab_size,
                                             **TRACE)[0], 3000))
    launches = {k: fn.launches for k, fn in counted.items()}

    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                isinstance(t, int) and 0 <= t < cfg.vocab_size
                for t in r.out_tokens):
            raise AssertionError(f"request {r.rid} did not complete with "
                                 f"{r.max_new_tokens} in-vocab tokens")
    problems = engine.events.validate_order()
    if problems:
        raise AssertionError(f"lifecycle order: {problems[:5]}")
    # int8 pages never reach K2, and bf16 pages never reach K2q
    decode, idle = (("decode_attention_quant", "decode_attention")
                    if kv_quant else
                    ("decode_attention", "decode_attention_quant"))
    L = cfg.num_layers
    want = {"prefill_attention": engine.prefill_batches * L,
            decode: _decode_calls(engine) * L, idle: 0}
    if launches != want:
        raise AssertionError(
            f"launch counts {launches} != {want} (prefill_batches "
            f"{engine.prefill_batches}, decode calls "
            f"{_decode_calls(engine)}, {L} layers)")
    traced = {k: traced[k] for k in counted}
    want = {"prefill_attention": t_prefills * L, decode: t_decodes * L,
            idle: 0}
    if traced != want:
        raise AssertionError(
            f"traced kernel counts {traced} != {want} (prefill_batches "
            f"{t_prefills}, decode_steps {t_decodes}, {L} layers)")
    if kv_quant and (engine.cache["k"][:, :, 0] != 0).any():
        raise AssertionError("null page 0 of the int8 cache is not zero")
    lat = lifecycle.request_latencies(reqs)
    ttft = [x["ttft_s"] * 1e3 for x in lat if x["ttft_s"] is not None]
    tpot = [x["tpot_s"] * 1e3 for x in lat if x["tpot_s"] is not None]
    stats = {
        "kv_quant": kv_quant, "trace_id": trace_id, "requests": len(reqs),
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_batches": prefills, "decode_steps": decodes,
        "decode_round_ms_mean": (1e3 * sum(decode_round_s)
                                 / max(len(decode_round_s), 1)),
        "ttft_p50_ms": lifecycle.percentile(ttft, 50),
        "ttft_p99_ms": lifecycle.percentile(ttft, 99),
        "tpot_p50_ms": lifecycle.percentile(tpot, 50),
        "device_dispatch_s": engine.device_dispatch_s,
        "cuda_graph": engine._graph is not None,
        "traced_run": {"prefill_batches": t_prefills,
                       "decode_steps": t_decodes, "kernels": traced},
        "cache_bytes": _cache_bytes(engine.cache),
        "kv_tier_rates": engine.kv_tier_rates(),
    }
    _log("end to end: " + json.dumps(stats))
    return engine, launches, stats


# the serving variants (eager K = 1, graphed K = 1, graphed K = 4), each
# served greedy and sampled, over bf16 and int8 KV pages; the sampled
# requests' controls (the seed is the request id)
SERVE_VARIANTS = (("eager K=1", 1, False), ("graphed K=1", 1, True),
                  ("graphed K=4", 4, True))
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# one prompt a packed prefill batch in the variants' engines: a bf16 packed
# prefill rounds a request's attention by its offset in the batch (K1's
# 64-row tiles), and K = 4 admits at other ticks than K = 1, so only
# unpacked prefills let the variants' tokens be compared bit for bit
VARIANT_ENGINE = dict(ENGINE, prefill_requests=1)
# the (pages, mode) pairs whose variants run a second time in reverse, in
# turns with the first; the others run once. None repeats: bf16 greedy's
# second turn (~30 s) was cut to keep the smoke's wall under 812 s once
# the batch-norm phase timed twelve shapes
VARIANT_TURNS = ()


def _variant_run(dev, cfg, params, kv_quant, sampled, k, graph,
                 engine_kw=None, profile=False):
    """Serve ``TRACE`` through one engine variant: its tokens by request
    and its numbers (tokens/s, TTFT and TPOT p50/p99, decode-round ms,
    dispatches). The decode wrapper's launches from the engine's
    construction on must be ``_decode_calls x layers`` (a graphed engine
    calls it at its warm-up and capture only). With ``profile``, a short
    second trace under torch.profiler: its busy share, and the decode
    kernels the device ran there, counted by name, which must be that
    trace's dispatches x K x layers, replays included."""
    from apex_tpu_torch.ops import decode_attention_cuda
    from apex_tpu_torch.serving import (Request, ServingEngine, lifecycle,
                                        synthetic_trace)
    from apex_tpu_torch.serving.sampling import SamplingParams

    kernel = (decode_attention_cuda.decode_attention_quant if kv_quant
              else decode_attention_cuda.decode_attention)
    kernel.launches = 0
    engine = ServingEngine(cfg, params, device=dev, kv_quant=kv_quant,
                           sampling=sampled, decode_k=k, cuda_graph=graph,
                           **(engine_kw or VARIANT_ENGINE))
    engine.run_trace([Request(rid=10**6, prompt=[7] * 300, max_new_tokens=9),
                      Request(rid=10**6 + 1, prompt=[9] * 40,
                              max_new_tokens=9)])
    reqs, _ = synthetic_trace(vocab=cfg.vocab_size, **TRACE)
    if sampled:
        for r in reqs:
            r.sampling = SamplingParams(seed=r.rid, **SAMPLED)
    base = (engine.decode_steps, engine.tokens_generated)
    wall, rounds = _drive_trace(engine, reqs)
    dispatches = engine.decode_steps - base[0]
    if kernel.launches != _decode_calls(engine) * cfg.num_layers:
        raise AssertionError(f"{kernel.__name__} launched {kernel.launches} "
                             f"times through its wrapper, want "
                             f"{_decode_calls(engine)} decode calls x "
                             f"{cfg.num_layers} layers")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                isinstance(t, int) and 0 <= t < cfg.vocab_size
                for t in r.out_tokens):
            raise AssertionError(f"request {r.rid} did not complete with "
                                 f"{r.max_new_tokens} in-vocab tokens")
    lat = lifecycle.request_latencies(reqs)
    ttft = [x["ttft_s"] * 1e3 for x in lat if x["ttft_s"] is not None]
    tpot = [x["tpot_s"] * 1e3 for x in lat if x["tpot_s"] is not None]
    tokens = engine.tokens_generated - base[1]
    stats = {"tokens_per_s": tokens / wall, "tokens": tokens,
             "dispatches": dispatches,
             "decode_round_ms": 1e3 * sum(rounds) / max(len(rounds), 1),
             "ttft_p50_ms": lifecycle.percentile(ttft, 50),
             "ttft_p99_ms": lifecycle.percentile(ttft, 99),
             "tpot_p50_ms": lifecycle.percentile(tpot, 50),
             "tpot_p99_ms": lifecycle.percentile(tpot, 99)}
    if profile:
        short, _ = synthetic_trace(seed=1, n_requests=8, vocab=cfg.vocab_size,
                                   prompt_lo=16, prompt_hi=64, new_lo=32,
                                   new_hi=32, mean_interarrival=0.0)
        for r in short:
            r.rid += 2000
            if sampled:
                r.sampling = SamplingParams(seed=r.rid, **SAMPLED)
        make, decodes = _fresh_copies(short), []

        def serve_short():
            d0 = engine.decode_steps
            engine.run_trace(make())
            decodes.append(engine.decode_steps - d0)

        share = _profile(serve_short, ("decode_attention", "matmul", "other"),
                         top=0)
        want = decodes[-1] * k * cfg.num_layers
        ran = share and share["traced"][kernel.__name__]
        if ran != want:
            raise AssertionError(f"{kernel.__name__}: the device ran {ran} "
                                 f"in the profiled trace, want {want}")
        stats["device_busy_share"] = share["device_busy_share"]
    tokens_by = {r.rid: list(r.out_tokens) for r in reqs}
    del engine
    torch.cuda.empty_cache()
    return tokens_by, stats


def _sampler_device(dev, cfg):
    """The sampler's device cost a decode step: ``sample_tokens`` on [8,
    vocab] bf16 logits, every lane at ``SAMPLED``, once under
    torch.profiler: its kernels and their device ms (the sum of their
    times, so the host's launch cost is not in it)."""
    from apex_tpu_torch.serving import sampling

    B = ENGINE["num_slots"]
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn(B, cfg.vocab_size, generator=gen, device=dev).to(
        torch.bfloat16)
    lanes = (torch.full((B,), SAMPLED["temperature"], device=dev),
             torch.full((B,), SAMPLED["top_k"], dtype=torch.int32,
                        device=dev),
             torch.full((B,), SAMPLED["top_p"], device=dev),
             torch.stack([torch.zeros(B, dtype=torch.int64, device=dev),
                          torch.arange(B, device=dev)], 1),
             torch.arange(B, dtype=torch.int32, device=dev))
    active = torch.ones(B, dtype=torch.bool, device=dev)
    run = lambda: sampling.sample_tokens(logits, *lanes, active)  # noqa: E731
    run()
    launches, ms = _device_launches(run)
    return {"kernels": launches, "device_ms": ms}


def phase_serving_variants(dev):
    """The decode program's variants at GPT-2-small's width (``MODEL``,
    ``VARIANT_ENGINE``, random weights from torch seed 0): ``TRACE``'s 24
    requests served greedy and sampled (``SAMPLED``, the seed the request
    id), over bf16 and int8 KV pages, by eager K = 1, graphed K = 1 and
    graphed K = 4, in turns (each variant, then, for the pairs
    ``VARIANT_TURNS`` repeats, each again in reverse).
    The runs of a (pages, mode) pair must give the same tokens bit
    for bit. Each variant's tokens/s, TTFT and TPOT p50/p99, decode-round
    ms and dispatches (the mean of its turns), a graphed variant's busy
    share (a profiled short trace, first turn; the eager ones are not
    profiled, to keep the smoke's wall); the sampler's kernels and device
    ms a step.
    Then graphed K = 1 and K = 4 once more at ``ENGINE``'s packed prefill
    (8 prompts a batch): how many requests keep equal tokens there."""
    from apex_tpu_torch.serving import init_gpt_params
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**MODEL)
    params = init_gpt_params(cfg, 0, dev)
    out = {"sampler_a_step": _sampler_device(dev, cfg), "variants": {}}
    for kv_quant in (False, True):
        for sampled in (False, True):
            key = f"{'int8' if kv_quant else 'bf16'} " \
                  f"{'sampled' if sampled else 'greedy'}"
            runs = {name: [] for name, _, _ in SERVE_VARIANTS}
            tokens = []
            order = list(SERVE_VARIANTS) + (
                list(reversed(SERVE_VARIANTS)) if key in VARIANT_TURNS
                else [])
            for turn, (name, k, graph) in enumerate(order):
                toks, stats = _variant_run(dev, cfg, params, kv_quant,
                                           sampled, k, graph,
                                           profile=graph and turn < len(
                                               SERVE_VARIANTS))
                runs[name].append(stats)
                tokens.append((name, toks))
            diverged = [name for name, toks in tokens if toks != tokens[0][1]]
            if diverged:
                raise AssertionError(f"serving variants ({key}): tokens of "
                                     f"{diverged} differ from eager K=1's")
            merged = out["variants"][key] = {}
            for name, turns in runs.items():
                merged[name] = {m: statistics.mean(t[m] for t in turns)
                                for m in turns[0] if m != "device_busy_share"}
                merged[name]["turns_tokens_per_s"] = [t["tokens_per_s"]
                                                      for t in turns]
                merged[name]["device_busy_share"] = turns[0].get(
                    "device_busy_share")
            _log(f"serving variants, {key} (tokens equal in all "
                 f"{len(order)} runs): "
                 + json.dumps(merged))
    packed = [_variant_run(dev, cfg, params, False, False, k, True,
                           engine_kw=ENGINE)[0] for k in (1, 4)]
    out["packed_prefill_k1_vs_k4_equal_requests"] = sum(
        packed[0][rid] == packed[1][rid] for rid in packed[0])
    _log("serving variants: " + json.dumps(
        {k: v for k, v in out.items() if k != "variants"}))
    del params
    torch.cuda.empty_cache()
    return out


def _device_launches(fn):
    """Device kernels (and copies) that one call of ``fn`` launches, and
    their device time (ms), from torch.profiler; None where the profiler
    saw no device activity."""
    prof, _, _ = _profiled(fn)
    n, us = 0, 0.0
    for evt in _device_events(prof):
        n += evt.count
        us += evt.self_device_time_total
    return (n, us / 1e3) if n else (None, None)


def phase_codec_cost(engine, flush):
    """The int8 codec's device cost per serving round: the cache writes of
    one decode step (8 lanes, every layer, K and V) and of one 512-token
    prefill batch, replayed alone on the engine's cache (each wrapped
    call is the model's own), counted and timed."""
    from apex_tpu_torch.serving import kv_tier

    cfg, dev = engine.cfg, engine.device
    L, H, D = cfg.num_layers, cfg.num_attention_heads, cfg.head_dim
    B, S, ps = ENGINE["num_slots"], ENGINE["prefill_len"], ENGINE["page_size"]
    gen = torch.Generator(device=dev).manual_seed(12)
    cache = engine.cache
    val = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    write_page = torch.arange(1, B + 1, device=dev)
    write_page[-2:] = 0                            # two inactive lanes
    write_off = torch.tensor([5, 0, 127, 64, 1, 9, 0, 0], device=dev)
    rows = torch.randn(S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    dest_page = (torch.arange(S, device=dev) // ps) + 10
    dest_off = torch.arange(S, device=dev) % ps
    keep = torch.ones(engine.num_pages, device=dev)
    keep[10:10 + S // ps] = 0.0

    def decode_writes():
        for i in range(L):
            for part in ("k", "v"):
                kv_tier.decode_scatter_quant(cache, i, part, val, write_page,
                                             write_off)

    def prefill_writes():
        for i in range(L):
            for part in ("k", "v"):
                kv_tier.prefill_scatter_quant(cache, i, part, rows, dest_page,
                                              dest_off, keep)

    out = {}
    for name, fn in (("decode_step", decode_writes),
                     ("prefill_batch", prefill_writes)):
        launches, prof_ms = _device_launches(fn)
        out[name] = {"launches": launches, "profiler_device_ms": prof_ms,
                     "ms": _time_ms(fn, flush, reps=10)}
    _log("int8 codec per round (replayed alone): " + json.dumps(out))
    return out


def phase_device_share(engine):
    """Replay a second, short trace under torch.profiler: the device's
    busy share of that window and its kernel time by kind (the profiler
    adds host cost, so this window's wall is not a throughput number)."""
    from apex_tpu_torch.serving import synthetic_trace

    reqs, _ = synthetic_trace(seed=1, n_requests=8, vocab=MODEL["vocab_size"],
                              prompt_lo=16, prompt_hi=64, new_lo=32,
                              new_hi=32, mean_interarrival=0.0)
    for r in reqs:
        r.rid += 2000     # rids stay unique in the engine's event log
    make = _fresh_copies(reqs)
    return _profile(lambda: engine.run_trace(make()),
                    ("attention_fwd", "decode_attention", "layer_norm",
                     "matmul", "other"))


def phase_paths_agree(engine, dev):
    """One packed prefill batch + 4 decode steps through the kernel path
    and the plain path on the card; logits within the bf16 band (over the
    int8 KV tier when the engine serves it: the codec is the same plain
    PyTorch on both paths, the decode attention K2q or its plain
    version; on the engine's int8 weight records when it has them: K23 or
    its plain version). Returns the kernel path's logits."""
    from apex_tpu_torch.ops import attention, decode_attention, qmatmul
    from apex_tpu_torch.serving import init_cache
    from apex_tpu_torch.serving import model as smodel

    cfg = engine.cfg
    S, ps, maxp, slots = 512, 128, 8, 8
    gen = torch.Generator().manual_seed(4)
    lens = (200, 150, 100)
    ids = torch.zeros(S, dtype=torch.int64)
    pos = torch.zeros(S, dtype=torch.int64)
    seg = torch.zeros(S, dtype=torch.int32)
    rows = torch.full((S,), slots, dtype=torch.int64)
    pt = torch.zeros(slots + 1, maxp, dtype=torch.int32)
    cur = 0
    for r, n in enumerate(lens):
        ids[cur:cur + n] = torch.randint(0, cfg.vocab_size, (n,),
                                         generator=gen)
        pos[cur:cur + n] = torch.arange(n)
        seg[cur:cur + n] = r + 1
        rows[cur:cur + n] = r
        pt[r, :2] = torch.tensor([1 + 2 * r, 2 + 2 * r])
        cur += n
    last = torch.tensor([lens[0] - 1, lens[0] + lens[1] - 1, cur - 1],
                        dtype=torch.int64)
    args = [x.to(dev) for x in (ids, pos, seg, rows, pt, last)]

    def plain_fused(q, k, v, *, causal, sm_scale, segment_ids):
        return attention._dense_attention(q, k, v, causal, sm_scale,
                                          segment_ids)

    def plain_decode(q, kp, vp, page_table, lengths, *, sm_scale,
                     k_scale=None, v_scale=None):
        return decode_attention.decode_attention_reference(
            q, kp, vp, page_table, lengths, sm_scale, k_scale, v_scale)

    quant = engine.kv_quant
    # every page of this fresh cache is fresh: no scale survives
    keep = torch.zeros(72, device=dev) if quant else None

    def run(tokens_fed):
        cache = init_cache(cfg.num_layers, cfg.num_attention_heads, 72, ps,
                           cfg.head_dim, torch.bfloat16, kv_quant=quant,
                           device=dev)
        cache, logits = smodel.prefill(engine.params, cache, *args, keep,
                                       cfg=cfg)
        out = [logits.float()]
        lengths = torch.tensor(list(lens) + [0] * (slots - len(lens)),
                               device=dev)
        for step in range(4):
            lengths = lengths + (lengths > 0)
            toks = tokens_fed[step]
            cache, _, lg = smodel.decode_step(
                engine.params, cache, toks, lengths, args[4][:slots],
                cfg=cfg, qparams=engine.qparams)
            out.append(lg.float())
        return out

    # the kernel path picks the tokens; both paths are fed the same ones
    fed = [torch.randint(0, cfg.vocab_size, (slots,), generator=gen)
           .to(dev) for _ in range(4)]
    kernel_logits = run(fed)
    with mock.patch.object(smodel, "fused_attention", plain_fused), \
            mock.patch.object(smodel, "decode_attention", plain_decode), \
            mock.patch.object(smodel.quant_mod, "qmatmul",
                              qmatmul.qmatmul_reference):
        plain_logits = run(fed)
    worst, agree, total = 0.0, 0, 0
    for a, b in zip(kernel_logits, plain_logits):
        live = slice(0, len(lens))
        worst = max(worst, (a[live] - b[live]).abs().max().item())
        agree += int((a[live].argmax(-1) == b[live].argmax(-1)).sum())
        total += len(lens)
    _log(f"kernel vs plain path on the card (kv_quant={quant}, weight_quant="
         f"{engine.qparams is not None}): max |logit diff| {worst:.4f} (band "
         f"{LOGITS_BAND}), argmax agreement {agree}/{total}")
    if not worst <= LOGITS_BAND:
        raise AssertionError(f"kernel path logits off by {worst}")
    return kernel_logits


def _layer_norm_ptxas(p, hidden, backward):
    """ptxas's registers and spills of the bf16 instantiation that plan
    ``p`` launches at width ``hidden`` (K4's second stage beside K4's)."""
    if p.body == "rows":
        kernel, args = "rows", (p.vec, -(-(hidden // p.vec) // p.lanes))
    elif p.body == "wide":
        kernel, args = "wide", (p.vec, p.lanes)
    else:
        kernel, args = "kernel", (p.lanes, -(-(hidden // 8) // p.lanes))
    found = _ptxas("layer_norm", f"layer_norm_{'bwd' if backward else 'fwd'}"
                   f"_{kernel}I13__nv_bfloat16Li{args[0]}ELi{args[1]}EE")
    if backward:
        found.update(_ptxas("layer_norm", "layer_norm_partials_sum"))
    return found


def _layer_norm_at(dev, flush, rows, shape):
    """K3 and K4 on ``rows`` rows of ``shape`` (an int, or a tuple
    normalized through ``fused_layer_norm`` and autograd, which must
    launch K3 and K4 once each), bf16 with fp32 affine: against the plain
    versions within the bands (bf16 outputs 2^-7 of their largest
    magnitude, as each side may round one ulp the other way; the fp32
    statistics and affine gradients 1e-4, summation order; the outputs'
    relative L2 ``BF16_L2_TOL``); the same bits on two runs; then each
    timed in turns around its library call (``F.layer_norm``, and its
    backward through ``torch.autograd.grad`` on a graph built untimed)
    and, with ``--parent``, the parent's body (K4 with its second stage);
    the plain versions, the bound and the plan."""
    import torch.nn.functional as F

    from apex_tpu_torch.normalization import fused_layer_norm
    from apex_tpu_torch.ops import layer_norm, layer_norm_cuda

    norm = shape if isinstance(shape, tuple) else (shape,)
    hidden = int(np.prod(norm))
    gen = torch.Generator(device=dev).manual_seed(5 if hidden == 768
                                                  else hidden)
    x = (torch.randn(rows, hidden, generator=gen, device=dev) * 2 + 1).to(
        torch.bfloat16)
    dy = torch.randn(rows, hidden, generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.rand(hidden, generator=gen, device=dev) + 0.5
    b = torch.randn(hidden, generator=gen, device=dev)
    tol_out, tol_f32 = 2.0 ** -7, 1e-4
    k3 = lambda: layer_norm_cuda.layer_norm_fwd(x, w, b, 1e-5)  # noqa: E731
    first = k3()
    k4 = lambda: layer_norm_cuda.layer_norm_bwd(  # noqa: E731
        x, w, first[1], first[2], dy)
    if len(norm) > 1:
        # the module's path: one row of prod(norm) a leading index
        before = (layer_norm_cuda.layer_norm_fwd.launches,
                  layer_norm_cuda.layer_norm_bwd.launches)
        xg = x.reshape(rows, *norm).detach().requires_grad_()
        wg, bg = (t.reshape(norm).detach().requires_grad_() for t in (w, b))
        y = fused_layer_norm(xg, norm, wg, bg, 1e-5)
        y.backward(dy.reshape(rows, *norm))
        if (layer_norm_cuda.layer_norm_fwd.launches,
                layer_norm_cuda.layer_norm_bwd.launches) != (
                    before[0] + 1, before[1] + 1):
            raise AssertionError("fused_layer_norm over two axes did not "
                                 "launch K3 and K4 once each")
        y, mean, rstd = y.reshape(rows, hidden), first[1], first[2]
        dx, dw, db = (xg.grad.reshape(rows, hidden), wg.grad.reshape(-1),
                      bg.grad.reshape(-1))
        del xg, wg, bg
    else:
        y, mean, rstd = first
        dx, dw, db = k4()
    ry, rmean, rrstd = layer_norm.layer_norm_fwd(x, w, b, 1e-5)
    rdx, rdw, rdb = layer_norm.layer_norm_bwd(x, w, rmean, rrstd, dy)
    again = (*k3(), *k4())
    torch.cuda.synchronize()
    errs = {"y": _rel_err(y, ry) / tol_out, "mean": _rel_err(mean, rmean)
            / tol_f32, "rstd": _rel_err(rstd, rrstd) / tol_f32,
            "dx": _rel_err(dx, rdx) / tol_out,
            "dw": _rel_err(dw, rdw) / tol_f32,
            "db": _rel_err(db, rdb) / tol_f32}
    l2 = {"y": _rel_l2(y, ry), "dx": _rel_l2(dx, rdx)}
    same_bits = all(torch.equal(a, c) for a, c in zip(
        (*first, *k4()), again))
    _log(f"layer norm at width {shape}: error over its tolerance "
         f"{json.dumps(errs)}, relative L2 {json.dumps(l2)} (tol "
         f"{BF16_L2_TOL}); two runs {'the same' if same_bits else 'DIFFER'}")
    if max(errs.values()) > 1 or max(l2.values()) > BF16_L2_TOL:
        raise AssertionError(f"layer-norm kernels at width {shape} disagree "
                             f"with the plain versions")
    if not same_bits:
        raise AssertionError(f"layer-norm kernels at width {shape}: two "
                             f"runs do not give the same bits")
    y_abs, dx_abs = _max_err(y, ry), _max_err(dx, rdx)
    del y, dx, ry, rdx, again

    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    xg = x.detach().requires_grad_()
    wg, bg = wl.detach().requires_grad_(), bl.detach().requires_grad_()
    yg = F.layer_norm(xg, (hidden,), wg, bg, 1e-5)   # graph built untimed
    parent = "layer_norm" in PARENT
    fwd_spread, bwd_spread = [], []
    fwd = _turns(k3, lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5), flush,
                 "layer_norm", spread=fwd_spread)
    bwd = _turns(k4, lambda: torch.autograd.grad(
        yg, (xg, wg, bg), dy, retain_graph=True), flush, "layer_norm",
                 spread=bwd_spread)
    if hidden == 768:
        # the main path's width after a flush that leaves L2 clean: what
        # the kernels take without the dirty lines' write-back
        for timed, fn, lib in (
                (fwd, k3, lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5)),
                (bwd, k4, lambda: torch.autograd.grad(
                    yg, (xg, wg, bg), dy, retain_graph=True))):
            timed["clean_l2"] = {"ms": _time_ms(fn, flush, clean=True),
                                 "library_ms": _time_ms(lib, flush,
                                                        clean=True)}
            if parent:
                timed["clean_l2"]["parent_ms"] = _time_ms(
                    _as_parent(fn, "layer_norm"), flush, clean=True)
    reps = 20 if hidden < 4096 else 5
    fwd_plain = _time_ms(lambda: layer_norm.layer_norm_fwd(x, w, b, 1e-5),
                         flush, reps=reps)
    bwd_plain = _time_ms(lambda: layer_norm.layer_norm_bwd(
        x, w, rmean, rrstd, dy), flush, reps=reps)
    del xg, wg, bg, yg
    elems = rows * hidden
    fwd_bytes = 2 * elems * 2 + 2 * hidden * 4 + 2 * rows * 4
    bwd_bytes = 3 * elems * 2 + hidden * 4 + 2 * rows * 4 + 2 * hidden * 4
    fwd_bound = _bound(fwd_bytes, 8 * elems, FP32_FLOPS_PER_S)
    bwd_bound = _bound(bwd_bytes, 14 * elems, FP32_FLOPS_PER_S)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, backward, timed, spread, plain, bound, nbytes, flops, err in (
            ("layer_norm_fwd", False, fwd, fwd_spread, fwd_plain, fwd_bound,
             fwd_bytes, 8 * elems, y_abs),
            ("layer_norm_bwd", True, bwd, bwd_spread, bwd_plain, bwd_bound,
             bwd_bytes, 14 * elems, dx_abs)):
        p = layer_norm_cuda.plan(rows, hidden, torch.bfloat16, sm, backward)
        regs = _layer_norm_ptxas(p, hidden, backward)
        out[name] = dict(
            timed, shape=f"x [{rows},{hidden}] bf16, w/b fp32",
            plan=p._asdict(), ptxas=regs, max_abs_err=err,
            max_err_over_tol=max(errs.values()),
            rel_l2=l2["dx" if backward else "y"], same_bits_twice=same_bits,
            kernel_ms=timed["ms"], ms_spread=spread, plain_ms=plain,
            bound_ms=bound[0], bound_by=bound[1], bytes=nbytes, flops=flops)
        _log(f"{name} at width {shape} ({p}): " + json.dumps(
            {k: out[name][k] for k in ("ms", "ms_turns", "library_ms",
                                       "parent_ms", "parent_ms_turns",
                                       "clean_l2", "bound_ms", "ptxas")
             if k in out[name]}))
    torch.cuda.empty_cache()
    return out


def phase_layer_norm_kernels(dev, flush):
    """K3 and K4 at the training shape, x, dy [8192, 768] bf16 with fp32
    affine (every layer norm of the GPT-2-small step at b=8, s=1024), then
    at ``LN_WIDTHS`` on as many rows (``_layer_norm_at``): the two kernel
    rows, the other widths' numbers under ``by_width``."""
    rows = TRAIN["batch"] * TRAIN["seq"]
    main = _layer_norm_at(dev, flush, rows, 768)
    by_width = {name: {} for name in main}
    for shape in LN_WIDTHS:
        key = "x".join(map(str, shape)) if isinstance(shape, tuple) \
            else str(shape)
        for name, numbers in _layer_norm_at(dev, flush, rows, shape).items():
            by_width[name][key] = numbers
    common = {"route": "cuda", "source": "apex_tpu_torch/csrc/layer_norm.cu",
              "library": ("F.layer_norm with bf16 weight and bias (it "
                          "takes one dtype)")}
    return [
        dict(common, name="layer_norm_fwd",
             replaces="apex_tpu/ops/layer_norm_pallas.py:185",
             tol=2.0 ** -7, rel_l2_tol=BF16_L2_TOL, **main["layer_norm_fwd"],
             by_width=by_width["layer_norm_fwd"]),
        dict(common, name="layer_norm_bwd",
             replaces="apex_tpu/ops/layer_norm_pallas.py:222",
             tol=2.0 ** -7, rel_l2_tol=BF16_L2_TOL, **main["layer_norm_bwd"],
             by_width=by_width["layer_norm_bwd"],
             library=("backward of F.layer_norm via torch.autograd.grad "
                      "(graph built outside the timed region)"),
             partial_sum="K4's second stage (layer_norm_partials_sum), "
                         "timed with it")]


def phase_attention_bwd_kernels(dev, flush):
    """K5 and K6 at the training shape: q, k, v, dO [8, 12, 1024, 64]
    bf16, causal, o from K1; also K1's own numbers at that shape."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention, attention_bwd_cuda
    from apex_tpu_torch.ops import attention_cuda

    B, H, S, D = TRAIN["batch"], 12, TRAIN["seq"], 64
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    # K1 at this shape against the plain forward before its o feeds the
    # backward on both sides: max |o diff| within the serving check's 5e-2
    # and the relative L2 within K1_L2_TOL
    k1_tol = 5e-2
    o = attention_cuda.prefill_attention(q, k, v, causal=True,
                                         sm_scale=scale)
    ro = attention._dense_attention(q, k, v, True, scale, None)
    torch.cuda.synchronize()
    k1_err = {"max_abs_err": _max_err(o, ro), "rel_l2": _rel_l2(o, ro)}
    del ro
    _log(f"prefill_attention at the training shape: {k1_err} (tol "
         f"{k1_tol}, {K1_L2_TOL})")
    if k1_err["max_abs_err"] > k1_tol or k1_err["rel_l2"] > K1_L2_TOL:
        raise AssertionError(f"prefill kernel disagrees at the training "
                             f"shape: {k1_err}")

    # each gradient by its relative L2 against the plain split backward
    # (BF16_L2_TOL), and the largest element error within 5e-2 of the
    # largest gradient magnitude (the card tests' outlier band)
    tol = 5e-2
    dq, m, l, dcol = attention_bwd_cuda.attention_bwd_dq(
        q, k, v, o, do, causal=True, sm_scale=scale)
    dk, dv = attention_bwd_cuda.attention_bwd_dkv(
        q, k, v, do, m, l, dcol, causal=True, sm_scale=scale)
    rdq, rdk, rdv = attention._attention_bwd_split(q, k, v, o, do, True,
                                                   scale, None)
    torch.cuda.synchronize()
    pairs = {"dq": (dq, rdq), "dk": (dk, rdk), "dv": (dv, rdv)}
    l2 = {n: _rel_l2(a, b) for n, (a, b) in pairs.items()}
    errs = {n: _rel_err(a, b) for n, (a, b) in pairs.items()}
    abs_errs = {"dq": _max_err(dq, rdq),
                "dkv": max(_max_err(dk, rdk), _max_err(dv, rdv))}
    ref_rms = {n: b.float().square().mean().sqrt().item()
               for n, (_, b) in pairs.items()}
    del pairs, rdq, rdk, rdv
    _log(f"attention_bwd: relative L2 {l2} (tol {BF16_L2_TOL}); max error "
         f"over the largest magnitude {errs} (tol {tol}); max_abs_err "
         f"{abs_errs}; reference rms {ref_rms}")
    if max(l2.values()) > BF16_L2_TOL or max(errs.values()) > tol:
        raise AssertionError(f"attention backward kernels disagree: "
                             f"relative L2 {l2}, max {errs}")

    # K1 at the training shape (its row's own numbers are the serving
    # shape's): time, plain and SDPA forward, bound
    k1_spread, dq_spread, dkv_spread = [], [], []
    k1_ms, k1_turns, k1_lib = _time_in_turns(
        lambda: attention_cuda.prefill_attention(q, k, v, causal=True,
                                                 sm_scale=scale),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale),
        flush, spread=k1_spread)
    k1_plain = _time_ms(lambda: attention._dense_attention(
        q, k, v, True, scale, None), flush, reps=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        scale=scale)   # graph built untimed
    # in turns: kernels, library, kernels
    dq_turns, dkv_turns = [], []
    for turn in range(2):
        dq_turns.append(_time_ms(lambda: attention_bwd_cuda.attention_bwd_dq(
            q, k, v, o, do, causal=True, sm_scale=scale), flush,
            spread=dq_spread if turn == 0 else None))
        dkv_turns.append(_time_ms(
            lambda: attention_bwd_cuda.attention_bwd_dkv(
                q, k, v, do, m, l, dcol, causal=True, sm_scale=scale), flush,
            spread=dkv_spread if turn == 0 else None))
        if turn == 0:
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do, retain_graph=True), flush)
    del og, qg, kg, vg
    dq_ms, dkv_ms = statistics.mean(dq_turns), statistics.mean(dkv_turns)
    plain_ms = _time_ms(lambda: attention._attention_bwd_split(
        q, k, v, o, do, True, scale, None), flush, reps=5)
    live = B * H * S * (S + 1) // 2          # causal (query, key) pairs
    t_bytes = q.numel() * q.element_size()
    stats = 3 * B * H * S * 4
    dq_bytes = 6 * t_bytes + stats           # q k v o dO in, dq out
    dkv_bytes = 6 * t_bytes + stats          # q k v dO + stats in, dk dv out
    dq_flops, dkv_flops = 3 * 2 * D * live, 4 * 2 * D * live
    dq_bound, dkv_bound = _bound(dq_bytes, dq_flops), _bound(dkv_bytes,
                                                             dkv_flops)
    k1_bound = _bound(4 * t_bytes, 2 * 2 * D * live)
    k1_train = {"shape": f"q,k,v [{B},{H},{S},{D}] bf16, causal",
                **k1_err, "tol": k1_tol, "rel_l2_tol": K1_L2_TOL,
                "ms": k1_ms, "ms_turns": k1_turns, "ms_spread": k1_spread,
                "plain_ms": k1_plain,
                "library_ms": k1_lib,
                "library": "F.scaled_dot_product_attention(is_causal=True)",
                "bound_ms": k1_bound[0], "bound_by": k1_bound[1]}
    _log("prefill_attention at the training shape: " + json.dumps(k1_train))
    common = {"route": "cuda",
              "source": "apex_tpu_torch/csrc/attention_bwd.cu",
              "shape": f"q,k,v,dO [{B},{H},{S},{D}] bf16, causal",
              "plain": ("_attention_bwd_split computes dq, dk and dv "
                        "together; its time is the pair's"),
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "library": ("backward of F.scaled_dot_product_attention("
                          "is_causal=True) via torch.autograd.grad (graph "
                          "built outside the timed region), dq, dk and dv "
                          "together"), "tol": tol,
              "rel_l2_tol": BF16_L2_TOL}
    return [
        dict(common, name="attention_bwd_dq",
             replaces="apex_tpu/ops/attention_pallas.py:869",
             max_abs_err=abs_errs["dq"], rel_err=errs["dq"],
             rel_l2=l2["dq"], ms=dq_ms, ms_turns=dq_turns,
             kernel_ms=dq_ms, ms_spread=dq_spread, bound_ms=dq_bound[0],
             bound_by=dq_bound[1],
             bytes=dq_bytes, flops=dq_flops),
        dict(common, name="attention_bwd_dkv",
             replaces="apex_tpu/ops/attention_pallas.py:899",
             max_abs_err=abs_errs["dkv"],
             rel_err=max(errs["dk"], errs["dv"]),
             rel_l2=max(l2["dk"], l2["dv"]), ms=dkv_ms, ms_turns=dkv_turns,
             kernel_ms=dkv_ms, ms_spread=dkv_spread, bound_ms=dkv_bound[0],
             bound_by=dkv_bound[1], bytes=dkv_bytes,
             flops=dkv_flops)], k1_train


def phase_attention_head_dims(dev, flush):
    """K1, K1d, K5/K6 and K5d/K6d at ``ATTN_HEAD_DIM_SHAPES`` (bf16,
    causal; dropout 0.1, seed -123456789): each against its plain version
    (``K1_L2_TOL`` and 5e-2 for the outputs, ``BF16_L2_TOL`` and 5e-2 of
    the largest magnitude for the gradients), two runs of K5/K6 (K5d/K6d)
    giving the same bits, timed after an L2 flush beside SDPA (forward,
    and backward through ``torch.autograd.grad``, with and without
    dropout), with its bound. The backward kernels are timed in turns,
    this tree's, SDPA's backward, this tree's, and with ``--parent`` the
    parent's before and after them. The wrappers zero-pad d = 80 to 128;
    the backward kernels are timed on tensors padded once beforehand (as
    the autograd path pads once a forward), and the pad's own time is
    given beside them. At d = 256 fp32 K5/K6, which stay on the CUDA
    cores, are held to ``FP32_L2_TOL`` and timed too. Returns ``{kernel
    name: {d: numbers}}`` for the rows of K1, K1d, K5, K6, K5d and
    K6d."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention, attention_bwd_cuda
    from apex_tpu_torch.ops import attention_cuda

    out = {}
    for d, (B, H, S) in ATTN_HEAD_DIM_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(30 + d)
        q, k, v, do = (torch.randn(B, H, S, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        seed = torch.tensor([-123456789], dtype=torch.int32, device=dev)
        scale = d ** -0.5
        width = attention._kernel_head_dim(d)
        padded = [attention._pad_head_dim(t, width) for t in (q, k, v, do)]
        pad_ms = _time_ms(lambda: [attention._pad_head_dim(t, width)
                                   for t in (q, k, v)], flush)
        live = B * H * S * (S + 1) // 2
        t_bytes = q.numel() * q.element_size()
        stats = 3 * B * H * S * 4
        hash_ops = HASH_OPS_PER_PAIR * live
        for drop in (False, True):
            p = DROPOUT_P if drop else 0.0
            kw = dict(causal=True, sm_scale=scale)
            dkw = dict(kw, dropout_p=p, dropout_seed=seed) if drop else kw
            fwd = (attention_cuda.prefill_attention_dropout if drop
                   else attention_cuda.prefill_attention)
            o = fwd(q, k, v, **dkw)
            ro = attention._dense_attention(q, k, v, True, scale, None, p,
                                            seed if drop else None)
            torch.cuda.synchronize()
            f_err, f_l2 = _max_err(o, ro), _rel_l2(o, ro)
            del ro
            pq, pk, pv, pdo = padded
            po = attention._pad_head_dim(o, width)
            dq_fn = (attention_bwd_cuda.attention_bwd_dq_dropout if drop
                     else attention_bwd_cuda.attention_bwd_dq)
            dkv_fn = (attention_bwd_cuda.attention_bwd_dkv_dropout if drop
                      else attention_bwd_cuda.attention_bwd_dkv)
            dq, m, l, dcol = dq_fn(pq, pk, pv, po, pdo, **dkw)
            dk, dv = dkv_fn(pq, pk, pv, pdo, m, l, dcol, **dkw)
            again = (dq_fn(pq, pk, pv, po, pdo, **dkw)[0],
                     *dkv_fn(pq, pk, pv, pdo, m, l, dcol, **dkw))
            ref = attention._attention_bwd_split(q, k, v, o, do, True, scale,
                                                 None, p,
                                                 seed if drop else None)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(a, b)
                            for a, b in zip((dq, dk, dv), again))
            del again
            got = [t[..., :d] for t in (dq, dk, dv)]
            b_l2 = [_rel_l2(a, r) for a, r in zip(got, ref)]
            b_err = [_rel_err(a, r) for a, r in zip(got, ref)]
            del ref, got
            what = f"attention{' dropout' if drop else ''} at head dim {d}"
            _log(f"{what}: forward max_abs_err {f_err:.3e}, relative L2 "
                 f"{f_l2:.3e}; dq/dk/dv relative L2 {b_l2}, max over the "
                 f"largest magnitude {b_err}; two runs the same bits "
                 f"{same_bits}")
            if (f_err > 5e-2 or f_l2 > K1_L2_TOL or max(b_l2) > BF16_L2_TOL
                    or max(b_err) > 5e-2):
                raise AssertionError(f"{what} disagrees with the plain "
                                     f"versions")
            if not same_bits:
                raise AssertionError(f"{what}: two runs of the backward "
                                     f"kernels differ")
            sdpa = dict(is_causal=True, scale=scale, dropout_p=p)
            f_ms, f_turns, f_lib = _time_in_turns(
                lambda: fwd(q, k, v, **dkw),
                lambda: F.scaled_dot_product_attention(q, k, v, **sdpa),
                flush)
            f_plain = _time_ms(lambda: attention._dense_attention(
                q, k, v, True, scale, None, p, seed if drop else None),
                flush, reps=3)
            calls = {"dq": lambda: dq_fn(pq, pk, pv, po, pdo, **dkw),
                     "dkv": lambda: dkv_fn(pq, pk, pv, pdo, m, l, dcol,
                                           **dkw)}
            turns = {"dq": [], "dkv": [], "parent_dq": [], "parent_dkv": []}

            def turn(parent):
                for n, fn in calls.items():
                    if not parent:
                        turns[n].append(_time_ms(fn, flush))
                    elif "attention_bwd" in PARENT:
                        turns["parent_" + n].append(_time_ms(
                            _as_parent(fn, "attention_bwd"), flush))

            turn(parent=True)
            turn(parent=False)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            og = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
            b_lib = _time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do, retain_graph=True), flush)
            del og, qg, kg, vg
            turn(parent=False)
            turn(parent=True)
            b_plain = _time_ms(lambda: attention._attention_bwd_split(
                q, k, v, o, do, True, scale, None, p,
                seed if drop else None), flush, reps=3)
            ints = hash_ops if drop else 0
            f_bound = _bound(4 * t_bytes, 2 * 2 * d * live, int_ops=ints)
            dq_bound = _bound(6 * t_bytes + stats, 3 * 2 * d * live,
                              int_ops=ints)
            dkv_bound = _bound(6 * t_bytes + stats, 4 * 2 * d * live,
                               int_ops=ints)
            shape = f"[{B},{H},{S},{d}] bf16, causal"
            common = {"shape": shape, "kernel_head_dim": width,
                      "pad_ms": pad_ms if width != d else 0.0}
            suffix = "_dropout" if drop else ""
            out.setdefault("prefill_attention" + suffix, {})[d] = dict(
                common, max_abs_err=f_err, rel_l2=f_l2, ms=f_ms,
                ms_turns=f_turns, plain_ms=f_plain, library_ms=f_lib,
                bound_ms=f_bound[0], bound_by=f_bound[1])
            for name, key, bound, i in (("attention_bwd_dq", "dq", dq_bound,
                                         [0]),
                                        ("attention_bwd_dkv", "dkv",
                                         dkv_bound, [1, 2])):
                row = dict(
                    common, rel_l2=max(b_l2[j] for j in i),
                    rel_err=max(b_err[j] for j in i),
                    same_bits_two_runs=same_bits,
                    ms=statistics.mean(turns[key]), ms_turns=turns[key],
                    plain_ms=b_plain, library_ms=b_lib,
                    bound_ms=bound[0], bound_by=bound[1],
                    plain=("dq, dk and dv together"),
                    library=("backward of F.scaled_dot_product_attention "
                             "via torch.autograd.grad, dq, dk and dv "
                             "together"))
                if turns["parent_" + key]:
                    row["parent_ms_turns"] = turns["parent_" + key]
                    row["parent_ms"] = statistics.mean(turns["parent_" + key])
                out.setdefault(name + suffix, {})[d] = row
            _log(f"{what}: K5 {turns['dq']} ms, K6 {turns['dkv']} ms in "
                 f"turns (parent {turns['parent_dq']}, "
                 f"{turns['parent_dkv']}); SDPA backward {b_lib:.4f} ms")
            del dq, dk, dv, m, l, dcol, o, po
        if d == 256:
            fp32 = _fp32_backward(q, k, v, do, scale, flush)
            for name in ("attention_bwd_dq", "attention_bwd_dkv"):
                out[name][d]["fp32"] = fp32[name]
        torch.cuda.empty_cache()
    _log("attention at other head dims: " + json.dumps(out))
    return out


def _fp32_backward(q, k, v, do, scale, flush):
    """K5 and K6 in fp32 (the CUDA-core bodies) on the bf16 inputs
    upcast, causal: each gradient within ``FP32_L2_TOL`` of the plain
    version by relative L2, and their times."""
    from apex_tpu_torch.ops import attention, attention_bwd_cuda

    q, k, v, do = (t.float() for t in (q, k, v, do))
    kw = dict(causal=True, sm_scale=scale)
    o = attention._dense_attention(q, k, v, True, scale, None)
    dq, m, l, dcol = attention_bwd_cuda.attention_bwd_dq(q, k, v, o, do, **kw)
    dk, dv = attention_bwd_cuda.attention_bwd_dkv(q, k, v, do, m, l, dcol,
                                                  **kw)
    ref = attention._attention_bwd_split(q, k, v, o, do, True, scale, None)
    torch.cuda.synchronize()
    l2 = [_rel_l2(a, r) for a, r in zip((dq, dk, dv), ref)]
    del ref, dk, dv
    _log(f"fp32 attention backward at head dim {q.shape[-1]}: dq/dk/dv "
         f"relative L2 {l2} (tol {FP32_L2_TOL})")
    if max(l2) > FP32_L2_TOL:
        raise AssertionError(f"fp32 K5/K6 disagree with the plain version: "
                             f"{l2}")
    shape = f"[{','.join(map(str, q.shape))}] fp32, causal"
    return {"attention_bwd_dq": {
                "shape": shape, "rel_l2": l2[0],
                "ms": _time_ms(lambda: attention_bwd_cuda.attention_bwd_dq(
                    q, k, v, o, do, **kw), flush, reps=5)},
            "attention_bwd_dkv": {
                "shape": shape, "rel_l2": max(l2[1:]),
                "ms": _time_ms(lambda: attention_bwd_cuda.attention_bwd_dkv(
                    q, k, v, do, m, l, dcol, **kw), flush, reps=5)}}


def phase_dropout_mask_exact(dev):
    """K1d's mask on the card equals the plain mask bit for bit: with q = k
    = 0 (non-causal), d = sk = 128 and V the identity, every score is 0, P
    = 1/128, and O[i, j] = mscale[i, j] / 128, over 2 x 12 (b, h) and 1024
    rows, for seeds 0, -1, -2^31 and 2^31 - 1. In fp32 (the CUDA-core
    body) O * 128 must equal the mask exactly; in bf16 (the tensor-core
    body) O is a bf16 rounding of mscale / 128, so O != 0 must hold
    exactly where the mask keeps."""
    from apex_tpu_torch.ops import attention, attention_cuda

    b, h, s, d = 2, 12, 1024, 128
    checked = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(b, h, s, d, device=dev, dtype=dtype)
        k = torch.zeros(b, h, d, d, device=dev, dtype=dtype)
        v = torch.eye(d, device=dev, dtype=dtype).expand(
            b, h, d, d).contiguous()
        checked[str(dtype)] = 0
        for value in (0, -1, -2 ** 31, 2 ** 31 - 1):
            seed = torch.tensor([value], dtype=torch.int32, device=dev)
            o = attention_cuda.prefill_attention_dropout(
                q, k, v, causal=False, sm_scale=0.125, dropout_p=DROPOUT_P,
                dropout_seed=seed)
            want = attention.dropout_mscale(seed, b, h, s, d, DROPOUT_P)
            if dtype == torch.float32:
                bad = int((o * d != want).sum())
            else:
                bad = int(((o != 0) != (want != 0)).sum())
            if bad:
                raise AssertionError(f"K1d's mask differs from the plain "
                                     f"mask in {bad} elements ({dtype}, "
                                     f"seed {value})")
            checked[str(dtype)] += want.numel()
    kept = float((want > 0).float().mean())
    _log(f"dropout mask from K1d's output equals the plain mask in all "
         f"elements, fp32 (exactly) and bf16 (where kept): {checked} (4 "
         f"seeds each, {b}x{h} heads x {s} rows x {d} keys); kept fraction "
         f"{kept:.5f} (p = {DROPOUT_P})")
    return {"elements": checked, "kept_fraction": kept}


def phase_dropout_kernels(dev, flush):
    """K1d, K5d and K6d at the training shape: q, k, v, dO [8, 12, 1024,
    64] bf16, causal, p = 0.1, seed -123456789. K1d against the plain
    forward (``K1_L2_TOL``), K5d/K6d against the plain backward with the
    same mask (``BF16_L2_TOL``), two K5d/K6d runs bit for bit."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention, attention_bwd_cuda
    from apex_tpu_torch.ops import attention_cuda

    B, H, S, D = TRAIN["batch"], 12, TRAIN["seq"], 64
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([-123456789], dtype=torch.int32, device=dev)
    scale = D ** -0.5
    kw = dict(causal=True, sm_scale=scale, dropout_p=DROPOUT_P,
              dropout_seed=seed)
    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
    ro = attention._dense_attention(q, k, v, True, scale, None, DROPOUT_P,
                                    seed)
    torch.cuda.synchronize()
    k1_tol = 5e-2
    fwd_err = {"max_abs_err": _max_err(o, ro), "rel_l2": _rel_l2(o, ro)}
    del ro
    _log(f"prefill_attention_dropout: {fwd_err} (tol {k1_tol}, "
         f"{K1_L2_TOL})")
    if fwd_err["max_abs_err"] > k1_tol or fwd_err["rel_l2"] > K1_L2_TOL:
        raise AssertionError(f"K1d disagrees with its plain version: "
                             f"{fwd_err}")

    tol = 5e-2
    dq, m, l, dcol = attention_bwd_cuda.attention_bwd_dq_dropout(
        q, k, v, o, do, **kw)
    dk, dv = attention_bwd_cuda.attention_bwd_dkv_dropout(
        q, k, v, do, m, l, dcol, **kw)
    dq2, m2, l2_, dcol2 = attention_bwd_cuda.attention_bwd_dq_dropout(
        q, k, v, o, do, **kw)
    dk2, dv2 = attention_bwd_cuda.attention_bwd_dkv_dropout(
        q, k, v, do, m2, l2_, dcol2, **kw)
    rdq, rdk, rdv = attention._attention_bwd_split(q, k, v, o, do, True,
                                                   scale, None, DROPOUT_P,
                                                   seed)
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2),
                                                    (dv, dv2)))
    del dq2, dk2, dv2, m2, l2_, dcol2
    pairs = {"dq": (dq, rdq), "dk": (dk, rdk), "dv": (dv, rdv)}
    l2 = {n: _rel_l2(a, b) for n, (a, b) in pairs.items()}
    errs = {n: _rel_err(a, b) for n, (a, b) in pairs.items()}
    abs_errs = {"dq": _max_err(dq, rdq),
                "dkv": max(_max_err(dk, rdk), _max_err(dv, rdv))}
    del pairs, rdq, rdk, rdv
    _log(f"attention_bwd_dropout: relative L2 {l2} (tol {BF16_L2_TOL}); max "
         f"error over the largest magnitude {errs} (tol {tol}); max_abs_err "
         f"{abs_errs}; two runs bit for bit: {repeatable}")
    if max(l2.values()) > BF16_L2_TOL or max(errs.values()) > tol:
        raise AssertionError(f"K5d/K6d disagree with the plain backward: "
                             f"relative L2 {l2}, max {errs}")
    if not repeatable:
        raise AssertionError("two K5d/K6d runs on the same inputs differ")

    spreads = [[], [], []]
    fwd_ms, fwd_turns, fwd_lib = _time_in_turns(
        lambda: attention_cuda.prefill_attention_dropout(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=DROPOUT_P, is_causal=True, scale=scale),
        flush, spread=spreads[0])
    fwd_plain = _time_ms(lambda: attention._dense_attention(
        q, k, v, True, scale, None, DROPOUT_P, seed), flush, reps=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(
        qg, kg, vg, dropout_p=DROPOUT_P, is_causal=True,
        scale=scale)                                # graph built untimed
    # in turns: kernels, library, kernels
    dq_turns, dkv_turns = [], []
    for turn in range(2):
        dq_turns.append(_time_ms(
            lambda: attention_bwd_cuda.attention_bwd_dq_dropout(
                q, k, v, o, do, **kw), flush,
            spread=spreads[1] if turn == 0 else None))
        dkv_turns.append(_time_ms(
            lambda: attention_bwd_cuda.attention_bwd_dkv_dropout(
                q, k, v, do, m, l, dcol, **kw), flush,
            spread=spreads[2] if turn == 0 else None))
        if turn == 0:
            bwd_lib = _time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do, retain_graph=True), flush)
    del og, qg, kg, vg
    dq_ms, dkv_ms = statistics.mean(dq_turns), statistics.mean(dkv_turns)
    bwd_plain = _time_ms(lambda: attention._attention_bwd_split(
        q, k, v, o, do, True, scale, None, DROPOUT_P, seed), flush, reps=5)
    live = B * H * S * (S + 1) // 2          # causal (query, key) pairs
    hash_ops = HASH_OPS_PER_PAIR * live      # one hash per live pair a pass
    t_bytes = q.numel() * q.element_size()
    stats = 3 * B * H * S * 4
    fwd_bytes = 4 * t_bytes + 4                  # q k v seed in, o out
    dq_bytes = 6 * t_bytes + stats + 4           # q k v o dO seed in, dq out
    dkv_bytes = 6 * t_bytes + stats + 4          # q k v dO stats seed, dk dv
    fwd_flops, dq_flops, dkv_flops = (2 * 2 * D * live, 3 * 2 * D * live,
                                      4 * 2 * D * live)
    fwd_bound = _bound(fwd_bytes, fwd_flops, int_ops=hash_ops)
    dq_bound = _bound(dq_bytes, dq_flops, int_ops=hash_ops)
    dkv_bound = _bound(dkv_bytes, dkv_flops, int_ops=hash_ops)
    shape = f"q,k,v,dO [{B},{H},{S},{D}] bf16, causal, p = {DROPOUT_P}"
    common = {"route": "cuda", "shape": shape, "hash_ops": hash_ops,
              "live_pairs": live}
    bwd_common = dict(
        common, source="apex_tpu_torch/csrc/attention_bwd.cu",
        plain=("_attention_bwd_split with dropout computes dq, dk and dv "
               "together; its time is the pair's"),
        plain_ms=bwd_plain, library_ms=bwd_lib,
        library=("backward of F.scaled_dot_product_attention(dropout_p="
                 f"{DROPOUT_P}, is_causal=True) via torch.autograd.grad "
                 "(graph built outside the timed region), dq, dk and dv "
                 "together; it draws another mask, so a time yardstick "
                 "only"), tol=tol, rel_l2_tol=BF16_L2_TOL,
        bitwise_repeatable=repeatable)
    return [
        dict(common, name="prefill_attention_dropout",
             source="apex_tpu_torch/csrc/prefill_attention.cu",
             replaces="apex_tpu/ops/attention_pallas.py:252",
             max_abs_err=fwd_err["max_abs_err"], rel_l2=fwd_err["rel_l2"],
             tol=k1_tol, rel_l2_tol=K1_L2_TOL, ms=fwd_ms,
             ms_turns=fwd_turns, kernel_ms=fwd_ms, ms_spread=spreads[0],
             plain_ms=fwd_plain, library_ms=fwd_lib,
             library=(f"F.scaled_dot_product_attention(dropout_p="
                      f"{DROPOUT_P}, is_causal=True); it draws another "
                      f"mask, so a time yardstick only"),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], bytes=fwd_bytes,
             flops=fwd_flops),
        dict(bwd_common, name="attention_bwd_dq_dropout",
             replaces="apex_tpu/ops/attention_pallas.py:331",
             max_abs_err=abs_errs["dq"], rel_err=errs["dq"], rel_l2=l2["dq"],
             ms=dq_ms, ms_turns=dq_turns, kernel_ms=dq_ms,
             ms_spread=spreads[1],
             bound_ms=dq_bound[0], bound_by=dq_bound[1], bytes=dq_bytes,
             flops=dq_flops),
        dict(bwd_common, name="attention_bwd_dkv_dropout",
             replaces="apex_tpu/ops/attention_pallas.py:331",
             max_abs_err=abs_errs["dkv"],
             rel_err=max(errs["dk"], errs["dv"]),
             rel_l2=max(l2["dk"], l2["dv"]), ms=dkv_ms, ms_turns=dkv_turns,
             kernel_ms=dkv_ms, ms_spread=spreads[2], bound_ms=dkv_bound[0],
             bound_by=dkv_bound[1], bytes=dkv_bytes, flops=dkv_flops)]


def phase_xent_kernels(dev, flush):
    """K7, K8 and K9 at the training shape: x [8192, 768] bf16 drawn like
    a layer-normed hidden (unit variance), E [50304, 768] from N(0, 0.02)
    as the model initialises it, seeded labels, and a non-uniform fp32
    cotangent of the training step's size (loss scale 2^16 over n)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import xent, xent_cuda

    n = TRAIN["batch"] * TRAIN["seq"]
    V, h = MODEL["vocab_size"], MODEL["hidden_size"]
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    e = (torch.randn(V, h, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    dl = (torch.rand(n, generator=gen, device=dev) + 0.5) * (2.0 ** 16 / n)
    loss, lse = xent_cuda.xent_fwd(x, e, labels)
    dx = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl)
    de = xent_cuda.xent_bwd_de(x, e, labels, lse, dl)
    dx_again = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl)
    de_again = xent_cuda.xent_bwd_de(x, e, labels, lse, dl)
    rloss, rlse = xent.linear_cross_entropy_fwd(x, e, labels)
    rdx = xent.linear_cross_entropy_dx(x, e, labels, rlse, dl)
    rde = xent.linear_cross_entropy_de(x, e, labels, rlse, dl)
    torch.cuda.synchronize()
    repeatable = {"dx": torch.equal(dx, dx_again),
                  "de": torch.equal(de, de_again)}
    del dx_again, de_again
    fwd_err = {"loss_max_abs_err": _max_err(loss, rloss),
               "lse_max_abs_err": _max_err(lse, rlse),
               "loss_rel_l2": _rel_l2(loss, rloss),
               "lse_rel_l2": _rel_l2(lse, rlse)}
    bwd_err = {k: {"max_abs_err": _max_err(a, b), "rel_err": _rel_err(a, b),
                   "rel_l2": _rel_l2(a, b)}
               for k, (a, b) in (("dx", (dx, rdx)), ("de", (de, rde)))}
    del rloss, rlse, rdx, rde
    _log(f"xent_fwd: {fwd_err} (tol max abs {XENT_LOSS_TOL}, relative L2 "
         f"{XENT_LOSS_L2_TOL})")
    _log(f"xent_bwd: {bwd_err} (tol relative L2 {BF16_L2_TOL}, max error "
         f"over the largest magnitude 5e-2); bitwise repeatable: "
         f"{repeatable}")
    if (max(fwd_err["loss_max_abs_err"], fwd_err["lse_max_abs_err"])
            > XENT_LOSS_TOL
            or max(fwd_err["loss_rel_l2"], fwd_err["lse_rel_l2"])
            > XENT_LOSS_L2_TOL):
        raise AssertionError(f"K7 disagrees with its plain version: "
                             f"{fwd_err}")
    for k, err in bwd_err.items():
        if err["rel_l2"] > BF16_L2_TOL or err["rel_err"] > 5e-2:
            raise AssertionError(f"{k} kernel disagrees with its plain "
                                 f"version: {err}")
    for k, same in repeatable.items():
        if not same:
            raise AssertionError(f"two {k} kernel runs on the same inputs "
                                 f"differ")

    spreads = [[], [], []]
    fwd_plain = _time_ms(lambda: xent.linear_cross_entropy_fwd(x, e, labels),
                         flush, reps=3)
    dx_plain = _time_ms(lambda: xent.linear_cross_entropy_dx(
        x, e, labels, lse, dl), flush, reps=3)
    de_plain = _time_ms(lambda: xent.linear_cross_entropy_de(
        x, e, labels, lse, dl), flush, reps=3)
    lab64 = labels.long()
    # in turns: K7, the materialized head's two calls, K7 (and the
    # parent's K7 before and after, with --parent)
    fwd = _turns(lambda: xent_cuda.xent_fwd(x, e, labels),
                 lambda: F.cross_entropy(x @ e.t(), lab64, reduction="none"),
                 flush, "xent", spread=spreads[0])
    _log(f"xent_fwd turns: {fwd}")
    xg, eg = x.detach().requires_grad_(), e.detach().requires_grad_()
    lg = F.cross_entropy(xg @ eg.t(), lab64,
                         reduction="none")       # graph built untimed
    # in turns: K8 and K9, the library backward, K8 and K9
    dx_turns, de_turns = [], []
    for turn in range(2):
        dx_turns.append(_time_ms(
            lambda: xent_cuda.xent_bwd_dx(x, e, labels, lse, dl), flush,
            spread=spreads[1] if turn == 0 else None))
        de_turns.append(_time_ms(
            lambda: xent_cuda.xent_bwd_de(x, e, labels, lse, dl), flush,
            spread=spreads[2] if turn == 0 else None))
        if turn == 0:
            bwd_lib = _time_ms(lambda: torch.autograd.grad(
                lg, (xg, eg), dl, retain_graph=True), flush)
    del lg, xg, eg
    dx_ms, de_ms = statistics.mean(dx_turns), statistics.mean(de_turns)
    xb, eb = n * h * 2, V * h * 2
    rows_b = n * 4                               # one fp32/int32 row vector
    fwd_bytes = xb + eb + 3 * rows_b             # labels in, loss, lse out
    dx_bytes = 2 * xb + eb + 3 * rows_b          # labels, lse, dl in
    de_bytes = xb + 2 * eb + 3 * rows_b
    fwd_flops, bwd_flops = 2 * n * V * h, 4 * n * V * h
    fwd_bound = _bound(fwd_bytes, fwd_flops)
    dx_bound, de_bound = _bound(dx_bytes, bwd_flops), _bound(de_bytes,
                                                            bwd_flops)
    common = {"route": "cuda", "source": "apex_tpu_torch/csrc/xent.cu",
              "shape": f"x [{n},{h}] bf16, E [{V},{h}] bf16, int32 labels"}
    bwd_common = dict(common, library_ms=bwd_lib, library=(
        "backward of x @ E.T then F.cross_entropy(reduction='none') via "
        "torch.autograd.grad (graph built outside the timed region): the "
        "materialized head's two calls, dX and dE together"),
        rel_l2_tol=BF16_L2_TOL, tol=5e-2)
    return [
        dict(common, name="xent_fwd",
             replaces="apex_tpu/ops/xent_pallas.py:429",
             max_abs_err=fwd_err["loss_max_abs_err"], **fwd_err,
             tol=XENT_LOSS_TOL, rel_l2_tol=XENT_LOSS_L2_TOL, **fwd,
             kernel_ms=fwd["ms"], ms_spread=spreads[0], plain_ms=fwd_plain,
             library=("x @ E.T then F.cross_entropy(reduction='none'): the "
                      "materialized head, two calls"),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], bytes=fwd_bytes,
             flops=fwd_flops),
        dict(bwd_common, name="xent_bwd_dx",
             replaces="apex_tpu/ops/xent_pallas.py:467",
             **bwd_err["dx"], bitwise_repeatable=repeatable["dx"],
             ms=dx_ms, ms_turns=dx_turns, kernel_ms=dx_ms,
             ms_spread=spreads[1], plain_ms=dx_plain,
             bound_ms=dx_bound[0], bound_by=dx_bound[1], bytes=dx_bytes,
             flops=bwd_flops),
        dict(bwd_common, name="xent_bwd_de",
             replaces="apex_tpu/ops/xent_pallas.py:482",
             **bwd_err["de"], bitwise_repeatable=repeatable["de"],
             ms=de_ms, ms_turns=de_turns, kernel_ms=de_ms,
             ms_spread=spreads[2], plain_ms=de_plain,
             bound_ms=de_bound[0], bound_by=de_bound[1], bytes=de_bytes,
             flops=bwd_flops)]


def _training_counts():
    from apex_tpu_torch.ops import (attention_bwd_cuda, attention_cuda,
                                    batch_norm_cuda, collectives_cuda,
                                    layer_norm_cuda, multi_tensor_cuda,
                                    softmax_cuda, xent_cuda)

    return {"prefill_attention": attention_cuda.prefill_attention,
            "attention_bwd_dq": attention_bwd_cuda.attention_bwd_dq,
            "attention_bwd_dkv": attention_bwd_cuda.attention_bwd_dkv,
            "prefill_attention_dropout":
                attention_cuda.prefill_attention_dropout,
            "attention_bwd_dq_dropout":
                attention_bwd_cuda.attention_bwd_dq_dropout,
            "attention_bwd_dkv_dropout":
                attention_bwd_cuda.attention_bwd_dkv_dropout,
            "layer_norm_fwd": layer_norm_cuda.layer_norm_fwd,
            "layer_norm_bwd": layer_norm_cuda.layer_norm_bwd,
            "xent_fwd": xent_cuda.xent_fwd,
            "xent_bwd_dx": xent_cuda.xent_bwd_dx,
            "xent_bwd_de": xent_cuda.xent_bwd_de,
            "softmax_fwd": softmax_cuda.softmax_fwd,
            "softmax_bwd": softmax_cuda.softmax_bwd,
            "xent_fwd_partials": xent_cuda.xent_fwd_partials,
            "softmax_fwd_long": softmax_cuda.softmax_fwd_long,
            "softmax_bwd_long": softmax_cuda.softmax_bwd_long,
            "multi_tensor_scale": multi_tensor_cuda.scale,
            "multi_tensor_l2norm": multi_tensor_cuda.l2norm,
            "multi_tensor_adam": multi_tensor_cuda.adam,
            "multi_tensor_lamb": multi_tensor_cuda.lamb,
            "multi_tensor_sgd": multi_tensor_cuda.sgd,
            "batch_norm_fwd_one": batch_norm_cuda.fwd,
            "batch_norm_bwd_one": batch_norm_cuda.bwd,
            "batch_norm_fwd_stats": batch_norm_cuda.fwd_stats,
            "batch_norm_fwd_apply": batch_norm_cuda.fwd_apply,
            "batch_norm_bwd_stats": batch_norm_cuda.bwd_stats,
            "batch_norm_bwd_apply": batch_norm_cuda.bwd_apply,
            "collectives_quantize": collectives_cuda.quantize,
            "collectives_dequantize_sum": collectives_cuda.dequantize_sum,
            "multi_tensor_zero_adam": multi_tensor_cuda.zero_adam,
            "multi_tensor_zero_lamb_stage1":
                multi_tensor_cuda.zero_lamb_stage1,
            "multi_tensor_zero_lamb_stage2":
                multi_tensor_cuda.zero_lamb_stage2}


def _warmup_cosine(count):
    """pretrain.py:53-80's schedule of the device step count (a 0-d int32
    tensor), on the device: linear warm-up over ``warmup_iters`` steps,
    then a cosine from ``lr`` to ``min_lr`` over ``decay_iters``."""
    base, low = LAMB["lr"], LAMB["min_lr"]
    warmup, decay = LAMB["warmup_iters"], LAMB["decay_iters"]
    step = count.float()
    warm = base * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(decay - warmup, 1), 0.0, 1.0)
    decayed = low + (base - low) * 0.5 * (1.0 + torch.cos(np.pi * frac))
    return torch.where(step < warmup, warm, decayed)


def _make_opt(opt):
    """The window's optimizer: ``fused_adam`` at ``TRAIN["lr"]``, or
    pretrain.py's ``fused_lamb`` (``LAMB``)."""
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    if opt == "lamb":
        return fused_lamb(learning_rate=_warmup_cosine, eps=LAMB["eps"],
                          weight_decay=LAMB["weight_decay"],
                          max_grad_norm=LAMB["max_grad_norm"])
    return fused_adam(learning_rate=TRAIN["lr"])


def _train_cfg(fused=False, dropout=False, recompute="none", scores=False,
               vocab=None, model=MODEL):
    """GPT-2-small (or ``model``) for training; ``dropout`` sets GPT-2's
    published hidden and attention dropout
    (``benchmarks/profile_gpt.py:401-425``), on the in-kernel route or,
    with ``scores``, on the scores path (the profile's row 10:
    ``fused_attention_dropout=False``, ``softmax_use_pallas=True``, the
    materialized head); ``vocab`` replaces the vocabulary size (the
    tensor-parallel windows pad it)."""
    from apex_tpu_torch.transformer.testing import TransformerConfig

    drop = DROPOUT_P if dropout else 0.0
    return TransformerConfig(**dict(model, hidden_dropout=drop,
                                    attention_dropout=drop,
                                    vocab_size=vocab or model["vocab_size"]),
                             fused_lm_head=fused,
                             recompute_granularity=recompute,
                             fused_attention_dropout=not scores,
                             softmax_use_pallas=True)


def _train_setup(dev, batch, seed=0, fused=False, dropout=False,
                 recompute="none", scores=False, tp=1, padded=False,
                 model=MODEL, opt="adam"):
    """The model, scaler, optimizer, step, states and seeded batch of one
    training configuration; at ``tp`` > 1 (inside an initialized tp group)
    this rank's ``GPTModel(tp_size=tp)`` over the padded vocabulary
    (``TP_VOCAB``) and the ``GradScaler``; ``padded`` gives tp = 1 the
    padded vocabulary, the tp windows' reference; ``opt`` "adam" or
    "lamb" (:func:`_make_opt`)."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.testing import GPTModel

    cfg = _train_cfg(fused, dropout, recompute, scores,
                     vocab=TP_VOCAB if tp > 1 or padded else None,
                     model=model)
    model = GPTModel(cfg, device=dev, seed=seed, tp_size=tp)
    scaler = GradScaler() if tp > 1 else LossScaler()
    opt = _make_opt(opt)
    rs = np.random.RandomState(0)                 # as bench.py:433-435
    s = TRAIN["seq"]
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, s))).to(dev)
    labels = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                         (batch, s))).to(dev)
    pos = torch.arange(s, device=dev)[None].expand(batch, s)
    gen = None
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(11)
    step = make_one_step(model, scaler, opt, dropout_generator=gen)
    return (model, scaler, opt, step, opt.init(dict(model.named_parameters())),
            scaler.init(dev), ids, pos, labels)


def _want_launches(fused, dropout, recompute, scores=False, model=MODEL,
                   opt=None):
    """Launches per step of each counted kernel: the forward's attention
    (or, on the scores path, softmax) and layer norms once more for what
    the backward recomputes. Heads past the attention kernels' head dims
    take the softmax too (the scores route, or with dropout the scores
    path). With ``opt`` ("adam" or "lamb") the step's optimizer region:
    one K12 launch a group of the model's leaves (12 a layer and 4) for
    the unscale, then one K14 launch a list, or for LAMB K13's two stages
    a group and one K15 launch."""
    from apex_tpu_torch.ops import attention, multi_tensor_cuda

    layers = model["num_layers"]
    head_dim = model["hidden_size"] // model["num_attention_heads"]
    scores = scores or attention.kernel_route(head_dim) == "scores"
    again = {"full": 1, "selective": 1}.get(recompute, 0)
    ln_again = 2 * layers if recompute == "full" else 0
    fwd, bwd = (("prefill_attention_dropout", ("attention_bwd_dq_dropout",
                 "attention_bwd_dkv_dropout")) if dropout else
                ("prefill_attention", ("attention_bwd_dq",
                                       "attention_bwd_dkv")))
    if scores:
        fwd, bwd = "softmax_fwd", ("softmax_bwd",)
    want = dict.fromkeys(_training_counts(), 0)
    want.update({fwd: layers * (1 + again),
                 "layer_norm_fwd": 2 * layers + 1 + ln_again,
                 "layer_norm_bwd": 2 * layers + 1})
    want.update(dict.fromkeys(bwd, layers))
    head = int(fused)
    want.update(xent_fwd=head, xent_bwd_dx=head, xent_bwd_de=head)
    if opt is not None:
        leaves = 12 * layers + 4

        def groups(depth):
            return -(-leaves // multi_tensor_cuda.capacity(depth))

        # K14 and K15: one launch a list of list_capacity() tensors
        lists = -(-leaves // multi_tensor_cuda.list_capacity())
        want["multi_tensor_scale"] = groups(2)
        if opt == "lamb":
            want.update(multi_tensor_l2norm=2 * groups(1),
                        multi_tensor_lamb=lists)
        else:
            want["multi_tensor_adam"] = lists
    return want


def phase_training(dev, card, fused, dropout=False, recompute="none",
                   scores=False, optimizer="adam"):
    """The training main path with the materialized (``fused=False``) or
    the fused LM head, with or without dropout (0.1, drawn from a seeded
    generator; in-kernel or, with ``scores``, on the scores path) and
    recompute, trained by Adam or LAMB (``optimizer``): warm-up, the timed window
    with the launch counts and the materialized cross entropy's calls read
    around it alone, the loss check after the window."""
    from apex_tpu_torch.transformer.testing import standalone_transformer_lm

    b, s = TRAIN["batch"], TRAIN["seq"]
    t0 = time.perf_counter()
    (model, scaler, opt, step, opt_state, ss, ids, pos,
     labels) = _train_setup(dev, b, fused=fused, dropout=dropout,
                            recompute=recompute, scores=scores,
                            opt=optimizer)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"GPTModel (fused_lm_head={fused}, dropout="
         f"{DROPOUT_P if dropout else 0.0}, recompute={recompute}, scores "
         f"path={scores}, {optimizer}) built in "
         f"{time.perf_counter() - t0:.2f} s: "
         f"{n_params} parameters")
    losses = []
    for _ in range(TRAIN["warmup"]):
        opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    ce = standalone_transformer_lm.vocab_parallel_cross_entropy
    ce_calls = []

    def counted_ce(*args, **kwargs):
        ce_calls.append(1)
        return ce(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(standalone_transformer_lm,
                           "vocab_parallel_cross_entropy", counted_ce):
        t0 = time.perf_counter()
        for _ in range(TRAIN["timed"]):
            opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses]             # read after the window
    step_ms = wall / TRAIN["timed"] * 1e3
    stats = {"card": card, "fused_lm_head": fused, "optimizer": optimizer,
             "dropout": DROPOUT_P if dropout else 0.0,
             "recompute_granularity": recompute, "scores_path": scores,
             "batch": b, "seq": s,
             "steps_timed": TRAIN["timed"],
             "step_ms": step_ms, "tokens_per_s": b * s / (step_ms / 1e3),
             "mfu": 6 * n_params * b * s / (step_ms / 1e3) / BF16_FLOPS_PER_S,
             "n_params": n_params, "peak_mem_gb": peak / 1e9,
             "loss_step1": vals[0], "loss_last": vals[-1], "losses": vals,
             "launches_per_step": {k: v / TRAIN["timed"]
                                   for k, v in launches.items()},
             "materialized_ce_calls": len(ce_calls)}
    _log("training: " + json.dumps(stats))
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        raise AssertionError(f"training loss not finite and falling: {vals}")
    head = int(fused)
    want = _want_launches(fused, dropout, recompute, scores, opt=optimizer)
    for k, per_step in want.items():
        if launches[k] != per_step * TRAIN["timed"]:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN['timed']} steps, want {per_step} "
                                 f"per step")
    if len(ce_calls) != (1 - head) * TRAIN["timed"]:
        raise AssertionError(f"the materialized cross entropy ran "
                             f"{len(ce_calls)} times in {TRAIN['timed']} "
                             f"steps (fused_lm_head={fused})")
    return ((model, scaler, step, opt_state, ss, ids, pos, labels), launches,
            stats)


def _gpt2_leaves(dev):
    """GPT-2-small's 148 fp32 parameter tensors (124.4 M elements), from
    the training model's init, keyed by name."""
    from apex_tpu_torch.transformer.testing import GPTModel

    model = GPTModel(_train_cfg(fused=True), device=dev, seed=0)
    return {n: p.detach() for n, p in model.named_parameters()}


def _ragged_leaves(dev, seed):
    """The ragged list: 1, 3, 767, 768 and 4099 elements and a view 4 bytes
    past a 16-byte boundary (element loads)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {f"r{n}": torch.randn(n, generator=gen, device=dev)
           for n in (1, 3, 767, 768, 4099)}
    out["misaligned"] = torch.randn(1001, generator=gen, device=dev)[1:]
    return out


def _same_bits(a, b):
    a, b = a.contiguous(), b.contiguous()
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(bits), b.view(bits))


def _copy(tree):
    return {n: t.clone() for n, t in tree.items()}


def _opt_state_tensors(state):
    out = {"count": state.count}
    out.update({f"m.{n}": t for n, t in state.m.items()})
    out.update({f"v.{n}": t for n, t in state.v.items()})
    return out


def _worst_rel(got, want):
    """The largest |got - want| over each tensor's largest magnitude."""
    worst = 0.0
    for k, w in want.items():
        if not w.numel() or not w.is_floating_point():
            continue
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{k}: not finite")
        scale = w.float().abs().max().clamp(min=1e-30)
        worst = max(worst, ((got[k].float() - w.float()).abs().max()
                            / scale).item())
    return worst


def _parent_wrapper(name):
    """The parent's wrapper ``name`` of ``multi_tensor_cuda`` (K14
    ``adam``, K15 ``lamb``), its whole host path run on the parent's
    library."""
    from apex_tpu_torch.ops import _build

    fn = getattr(PARENT_MODULES["multi_tensor"], name)

    def run(*args, **kw):
        with mock.patch.dict(_build._libs,
                             {"multi_tensor": PARENT["multi_tensor"]}):
            return fn(*args, **kw)
    return run


def _host_turns(this, parent=None, calls=10):
    """The host ms of one call of ``this`` (a wrapper's whole host path,
    its launch not waited on), each call from a synced start, the median
    of ``calls``; with ``parent``, in turns: this, parent, this, parent."""
    out = {"host_ms_turns": [], "parent_host_ms_turns": []}
    for fn, key in ((this, "host_ms_turns"), (parent, "parent_host_ms_turns"),
                    (this, "host_ms_turns"), (parent, "parent_host_ms_turns")):
        if fn is None:
            continue
        host = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        out[key].append(statistics.median(host))
    torch.cuda.synchronize()
    out["host_ms"] = statistics.mean(out["host_ms_turns"])
    if parent is None:
        out.pop("parent_host_ms_turns")
    else:
        out["parent_host_ms"] = statistics.mean(out["parent_host_ms_turns"])
    return out


def phase_multi_tensor_kernels(dev, flush):
    """K12-K15 on GPT-2-small's 148 fp32 leaves (gradients scaled by
    2^16, as the loss scaler leaves them) and on the ragged list, each
    against its plain version: K12 (the unscale: fp32 outputs and the
    found-inf flag, also with an inf planted) and K14 (one Adam step, and
    one with the flag set) bit for bit; K13 (norms) and K15 (one LAMB
    step, two_pass) within MT_NORM_TOL / MT_LAMB_TOL, two runs the same
    bits. Each timed in turns with its library call (K12
    ``torch._amp_foreach_non_finite_check_and_unscale_``, in place at
    scale 1; K13 ``torch._foreach_norm``; K14 ``torch.optim.Adam(
    fused=True)``'s step on copies; K15 none) and against its plain
    version; bounds by bytes (K12 8, K13 4, K14 and K15 28 a parameter;
    K15's two-pass floor 40). K14 and K15 with ``--parent`` in turns with
    the parent's kernels and held to their bits; K15 also at BERT-large's
    leaves; both in a CUDA graph (``_mt_graph_capture``)."""
    from apex_tpu_torch.ops import multi_tensor
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb
    from apex_tpu_torch.optimizers._base import apply_plain

    source = "apex_tpu_torch/csrc/multi_tensor.cu"
    params = _gpt2_leaves(dev)
    n = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=dev).manual_seed(5)
    scaled = {k: torch.randn(p.shape, generator=gen, device=dev)
              * (2.0 ** 16 * 1e-3) for k, p in params.items()}
    ragged = _ragged_leaves(dev, 6)
    inv = 1.0 / torch.tensor(2.0 ** 16, device=dev)
    no = torch.tensor(False, device=dev)
    yes = torch.tensor(True, device=dev)
    rows = []

    # K12: the loss scaler's unscale, flag on the inputs
    def unscale(leaves, plain=False):
        fn = multi_tensor.scale_reference if plain else mt.scale
        return fn(leaves, [torch.float32] * len(leaves), inv, True,
                  torch.bool)

    checks = {}
    for what, leaves in (("gpt2", list(scaled.values())),
                         ("ragged", list(ragged.values()))):
        for poison in (False, True):
            if poison:
                leaves = [t.clone() for t in leaves]
                leaves[-2].view(-1)[3] = float("inf")
            (got, flag), (ref, rflag) = unscale(leaves), unscale(leaves, True)
            same = all(_same_bits(a, b) for a, b in zip(got, ref))
            checks[f"{what}{' inf' if poison else ''}"] = same
            if not same or flag.item() != rflag.item() \
                    or rflag.item() != poison:
                raise AssertionError(f"K12 on {what} (inf planted: {poison})"
                                     f": bits {same}, flag {flag.item()} vs "
                                     f"{rflag.item()}")
    grads = dict(zip(scaled, unscale(list(scaled.values()))[0]))
    gl = list(scaled.values())
    lib_in = [g.clone() for g in gl]
    found = torch.zeros(1, device=dev)
    one = torch.ones(1, device=dev)
    spread = []
    t = _turns(lambda: unscale(gl), lambda: torch.
               _amp_foreach_non_finite_check_and_unscale_(lib_in, found,
                                                          one),
               flush, source, spread=spread, spin=MT_SPIN)
    plain_ms = _time_ms(lambda: unscale(gl, True), flush)
    bound = _bound(8 * n, 0)
    rows.append(dict(name="multi_tensor_scale", route="cuda", source=source,
                     replaces="apex_tpu/amp/scaler.py:68",
                     counterparts=["apex_tpu/amp/scaler.py:68 "
                                   "LossScaler.unscale",
                                   "apex_tpu/multi_tensor_apply/"
                                   "multi_tensor_apply.py:70 "
                                   "multi_tensor_scale", ":85 axpby"],
                     max_abs_err=0.0, bitwise=checks, leaves=len(gl),
                     elements=n, ms_spread=spread, plain_ms=plain_ms,
                     bound_ms=bound[0], bound_by=bound[1], bytes=8 * n,
                     **t))
    _log("K12: " + json.dumps(rows[-1]))

    # K13: per-tensor and global norms of the unscaled gradients
    gu = list(grads.values())
    norms, again = mt.l2norm(gu), mt.l2norm(gu)
    rl = list(ragged.values())
    err = max(_worst_rel(dict(enumerate(norms)), dict(enumerate(
        multi_tensor.l2norm_reference(gu)))),
        _worst_rel(dict(enumerate(mt.l2norm(rl))),
                   dict(enumerate(multi_tensor.l2norm_reference(rl)))))
    repeat = all(_same_bits(a, b) for a, b in zip(norms, again))
    if err > MT_NORM_TOL or not repeat:
        raise AssertionError(f"K13: error {err} (band {MT_NORM_TOL}), "
                             f"repeatable {repeat}")
    spread = []
    t = _turns(lambda: mt.l2norm(gu), lambda: torch._foreach_norm(gu),
               flush, source, spread=spread)
    plain_ms = _time_ms(lambda: multi_tensor.l2norm_reference(gu), flush)
    bound = _bound(4 * n, 0)
    rows.append(dict(name="multi_tensor_l2norm", route="cuda", source=source,
                     replaces="apex_tpu/multi_tensor_apply/"
                              "multi_tensor_apply.py:111",
                     counterparts=["apex_tpu/multi_tensor_apply/"
                                   "multi_tensor_apply.py:99 "
                                   "multi_tensor_l2norm", ":111 per_tensor",
                                   "apex_tpu/optimizers/fused_lamb.py:116 "
                                   "LAMB phase 1"],
                     max_abs_err=err, band=MT_NORM_TOL,
                     bitwise_repeatable=repeat, ms_spread=spread,
                     plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                     bytes=4 * n, **t))
    _log("K13: " + json.dumps(rows[-1]))

    # K14: one Adam step against the plain update and selects, bit for bit
    tx = fused_adam(1e-4, weight_decay=0.01)
    adam_checks = {}
    for what, p0, g in (("gpt2", params, grads),
                        ("ragged", ragged, _ragged_leaves(dev, 7))):
        pk, pp = _copy(p0), _copy(p0)
        sk, sp = tx.init(pk), tx.init(pp)
        for step in range(2):
            tx.step(g, sk, pk, no)
            apply_plain(tx.update, g, sp, pp, no)
        tx.step(g, sk, pk, yes)
        same = (all(_same_bits(pk[k], pp[k]) for k in pk) and all(
            _same_bits(a, b) for a, b in zip(
                _opt_state_tensors(sk).values(),
                _opt_state_tensors(sp).values())))
        adam_checks[what] = same
        if not same:
            raise AssertionError(f"K14 on {what}: not the plain version's "
                                 f"bits")
    adam_kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                   adam_w_mode=True, bias_correction=True, skip=no)
    lists, sk = _mt_lists(params, grads, tx)
    count_new = sk.count + 1
    bc = _bias_corrections(count_new)

    def k14():
        mt.adam(*lists, sk.count, count_new, *bc, 1e-4, **adam_kw)

    has_parent = "multi_tensor" in PARENT
    parent_adam = _parent_wrapper("adam") if has_parent else None

    def parent14():
        parent_adam(*lists, sk.count, count_new, *bc, 1e-4, **adam_kw)

    extra = _list_kernel_facts("adam", lists, k14)
    extra["host"] = _host_turns(k14, parent14 if has_parent else None)
    if has_parent:
        extra["parent_bitwise"] = _same_as_parent(
            lambda ls: mt.adam(*ls, sk.count.clone(), count_new, *bc, 1e-4,
                               **adam_kw),
            lambda ls: parent_adam(*ls, sk.count.clone(), count_new, *bc,
                                   1e-4, **adam_kw), lists)
    lib_p = [torch.nn.Parameter(p.clone()) for p in lists[1]]
    for p, g in zip(lib_p, lists[0]):
        p.grad = g
    lib_opt = torch.optim.Adam(lib_p, lr=1e-4, weight_decay=0.01,
                               fused=True)
    pp = _copy(params)
    sp = tx.init(pp)
    spread = []
    t = _turns(k14, lib_opt.step, flush, "multi_tensor", spread=spread,
               parent_fn=parent14, spin=MT_LIST_SPIN)
    plain_ms = _time_ms(lambda: apply_plain(tx.update, grads, sp, pp, no),
                        flush)
    bound = _bound(28 * n, 0)
    rows.append(dict(name="multi_tensor_adam", route="cuda", source=source,
                     replaces="apex_tpu/optimizers/fused_adam.py:41",
                     counterparts=["apex_tpu/optimizers/fused_adam.py:41 "
                                   "_adam_flat", "bench.py:240-245 selects"],
                     max_abs_err=0.0, bitwise=adam_checks,
                     ms_spread=spread, plain_ms=plain_ms, bound_ms=bound[0],
                     bound_by=bound[1], bytes=28 * n,
                     bound_share=bound[0] / t["ms"], **extra, **t))
    _log("K14: " + json.dumps(rows[-1]))
    del lib_p, lib_opt, sk, pp, sp, lists
    torch.cuda.empty_cache()

    # K15: one LAMB step (two_pass) within the band, two runs the same bits
    lamb = fused_lamb(1e-3, impl="two_pass")
    errs, repeat = {}, True
    for what, p0, g in (("gpt2", params, grads),
                        ("ragged", ragged, _ragged_leaves(dev, 8))):
        pk, pk2, pp = _copy(p0), _copy(p0), _copy(p0)
        sk, sk2, sp = lamb.init(pk), lamb.init(pk2), lamb.init(pp)
        lamb.step(g, sk, pk, no)
        lamb.step(g, sk2, pk2, no)
        apply_plain(lamb.update, g, sp, pp, no)
        got, want = _opt_state_tensors(sk), _opt_state_tensors(sp)
        got.update(pk)
        want.update(pp)
        errs[what] = _worst_rel(got, want)
        repeat &= all(_same_bits(pk[k], pk2[k]) for k in pk)
        kept = _copy(pk)
        lamb.step(g, sk, pk, yes)
        repeat &= all(_same_bits(pk[k], kept[k]) for k in pk)
    if max(errs.values()) > MT_LAMB_TOL or not repeat:
        raise AssertionError(f"K15: errors {errs} (band {MT_LAMB_TOL}), "
                             f"repeatable and skipping {repeat}")
    row = dict(name="multi_tensor_lamb", route="cuda", source=source,
               replaces="apex_tpu/optimizers/fused_lamb.py:111",
               counterparts=["apex_tpu/optimizers/fused_lamb.py:111 "
                             "update_two_pass", ":145 update_one_pass"],
               max_abs_err=max(errs.values()), errors=errs, band=MT_LAMB_TOL,
               bitwise_repeatable=repeat, library_ms=None)
    row.update(_k15_times(dev, flush, params, grads, gu, plain=True))
    row["bert_large"] = _k15_bert_large(dev, flush)
    row["cuda_graph"] = _mt_graph_capture(dev)
    rows.append(row)
    _log("K15: " + json.dumps(rows[-1]))
    return rows


def _mt_lists(params, grads, tx):
    """K14's or K15's four lists (g, p, m, v) over copies of ``params``
    and a fresh state of ``tx``; and the state."""
    names = list(params)
    pk = _copy(params)
    sk = tx.init(pk)
    return ([grads[k] for k in names], [pk[k] for k in names],
            [sk.m[k] for k in names], [sk.v[k] for k in names]), sk


def _bias_corrections(count_new):
    t = count_new.float()
    return 1.0 - torch.pow(0.9, t), 1.0 - torch.pow(0.999, t)


def _list_kernel_facts(kind, lists, call):
    """K14's or K15's launch at these lists: its plan (the grid, the
    blocks an SM holds), ptxas's registers and spills of the fp32
    instantiation it runs, and the launches one call makes."""
    from apex_tpu_torch.ops import multi_tensor_cuda as mt

    g, p = lists[0][0], lists[1][0]
    res, sms = mt.resident(kind, g.dtype, p.dtype, p.device)
    pl = mt.plan(kind, [x.numel() for x in lists[0]], sms, res)
    wrapper = getattr(mt, kind)
    before = wrapper.launches
    call()
    launches = wrapper.launches - before
    ptxas = _ptxas("multi_tensor", f"{kind}_list_kernelIffE")
    return {"plan": {"grid": pl.grid, "blocks_an_sm": res},
            "ptxas": next(iter(ptxas.values()), None),
            "launches_a_call": launches}


def _same_as_parent(this, parent, lists):
    """Whether one call of this tree's kernel and one of the parent's, each
    on its own copy of ``lists`` (gradients shared), leave the same bits."""
    a = [lists[0]] + [[t.clone() for t in ls] for ls in lists[1:]]
    b = [lists[0]] + [[t.clone() for t in ls] for ls in lists[1:]]
    this(a)
    parent(b)
    return all(_same_bits(x, y) for la, lb in zip(a[1:], b[1:])
               for x, y in zip(la, lb))


def _k15_times(dev, flush, params, grads, gsq_of, plain=False):
    """K15 (one step, ``pretrain.py``'s hyperparameters but lr 1e-3) on
    these leaves: timed, and with ``--parent`` in turns with the parent's
    four launches (parent, kernel, kernel, parent) and held to its bits;
    the plain version's time (``plain``); bytes, the 28-byte bound, the
    40-byte two-pass floor, the plan, ptxas, the launches, and the host
    ms of a call (in turns with the parent's wrapper, ``_host_turns``)."""
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.optimizers._base import apply_plain

    lamb = fused_lamb(1e-3, impl="two_pass")
    n = sum(p.numel() for p in params.values())
    no = torch.tensor(False, device=dev)
    lists, sk = _mt_lists(params, grads, lamb)
    count_new = sk.count + 1
    bc = _bias_corrections(count_new)
    gsq = mt.l2norm(gsq_of).total_sq
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6, weight_decay=0.01,
              adam_w_mode=True, bias_correction=True, max_grad_norm=1.0,
              trust=True, global_sq=gsq, skip=no)

    def k15():
        mt.lamb(*lists, sk.count, count_new, *bc, 1e-3, **kw)

    has_parent = "multi_tensor" in PARENT
    parent_lamb = _parent_wrapper("lamb") if has_parent else None

    def parent15():
        parent_lamb(*lists, sk.count, count_new, *bc, 1e-3, **kw)

    out = _list_kernel_facts("lamb", lists, k15)
    out["host"] = _host_turns(k15, parent15 if has_parent else None)
    spread = []
    if has_parent:
        out["parent_bitwise"] = _same_as_parent(
            lambda ls: mt.lamb(*ls, sk.count.clone(), count_new, *bc, 1e-3,
                               **kw),
            lambda ls: parent_lamb(*ls, sk.count.clone(), count_new, *bc,
                                   1e-3, **kw), lists)
        out["parent_ms_turns"] = [_time_ms(parent15, flush,
                                           spin=MT_LIST_SPIN)]
    turns = [_time_ms(k15, flush, spread=spread, spin=MT_LIST_SPIN),
             _time_ms(k15, flush, spin=MT_LIST_SPIN)]
    if has_parent:
        out["parent_ms_turns"].append(_time_ms(parent15, flush,
                                               spin=MT_LIST_SPIN))
        out["parent_ms"] = statistics.mean(out["parent_ms_turns"])
    if plain:
        pp = _copy(params)
        sp = lamb.init(pp)
        out["plain_ms"] = _time_ms(
            lambda: apply_plain(lamb.update, grads, sp, pp, no), flush)
    bound = _bound(28 * n, 0)
    ms = statistics.mean(turns)
    out.update(ms=ms, ms_turns=turns, ms_spread=spread, bytes=28 * n,
               elements=n, leaves=len(params), bound_ms=bound[0],
               bound_by=bound[1], bound_share=bound[0] / ms,
               two_pass_floor_ms=_bound(40 * n, 0)[0])
    return out


def _k15_bert_large(dev, flush):
    """K15 at BERT-large's 302 leaves (336.3 M elements, fp32, as
    ``phase_bert_training`` window A builds the model): one step within
    MT_LAMB_TOL of the plain version, two runs the same bits, and
    ``_k15_times``."""
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.optimizers._base import apply_plain
    from apex_tpu_torch.transformer.testing import BertModel

    model = BertModel(_bert_cfg("A"), device=dev, seed=0)
    params = {n: p.detach() for n, p in model.named_parameters()}
    del model
    gen = torch.Generator(device=dev).manual_seed(9)
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for k, p in params.items()}
    lamb = fused_lamb(1e-3, impl="two_pass")
    no = torch.tensor(False, device=dev)
    pk, pk2 = _copy(params), _copy(params)
    sk, sk2 = lamb.init(pk), lamb.init(pk2)
    lamb.step(grads, sk, pk, no)
    lamb.step(grads, sk2, pk2, no)
    repeat = all(_same_bits(pk[k], pk2[k]) for k in pk)
    del pk2, sk2
    pp = _copy(params)
    sp = lamb.init(pp)
    apply_plain(lamb.update, grads, sp, pp, no)
    got, want = _opt_state_tensors(sk), _opt_state_tensors(sp)
    got.update(pk)
    want.update(pp)
    err = _worst_rel(got, want)
    del pk, sk, pp, sp, got, want
    torch.cuda.empty_cache()
    if err > MT_LAMB_TOL or not repeat:
        raise AssertionError(f"K15 at BERT-large's leaves: error {err} (band "
                             f"{MT_LAMB_TOL}), repeatable {repeat}")
    out = {"max_abs_err": err, "bitwise_repeatable": repeat}
    out.update(_k15_times(dev, flush, params, grads, list(grads.values())))
    del params, grads
    torch.cuda.empty_cache()
    return out


def _mt_graph_capture(dev):
    """Whether a CUDA graph captures K14's and K15's one launch (K15's
    cooperative) on the ragged list and each of two replays gives the
    bits of eager steps on a copy laid out alike."""
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    out = {}
    no = torch.tensor(False, device=dev)
    for name, tx in (("adam", fused_adam(1e-3, weight_decay=0.01)),
                     ("lamb", fused_lamb(1e-2, weight_decay=0.01))):
        # both from the same draw, so the misaligned view is misaligned in
        # both (K15's per-thread sums follow the vector or element walk)
        params, eager = _ragged_leaves(dev, 11), _ragged_leaves(dev, 11)
        grads = {k: v * 1e-2 for k, v in _ragged_leaves(dev, 12).items()}
        es, gs = tx.init(eager), tx.init(params)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = _copy(params)
            tx.step(grads, tx.init(warm), warm, no)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            tx.step(grads, gs, params, no)
        same = True
        for _ in range(2):
            graph.replay()
            tx.step(grads, es, eager, no)
            torch.cuda.synchronize()
            got, want = _opt_state_tensors(gs), _opt_state_tensors(es)
            got.update(params)
            want.update(eager)
            same &= all(_same_bits(got[k], want[k]) for k in want)
        out[name] = same
        if not same:
            raise AssertionError(f"K14/K15 in a CUDA graph: {name}'s replay "
                                 f"differs from the eager step")
        del graph
    return out


def phase_optimizer_paths_agree(dev):
    """The optimizer's kernel path against its plain path in the training
    window (GPT-2-small, the fused head, b=8, s=1024). Adam: each of 7
    steps' real gradients goes through the kernel step (K12, K14, on the
    model's parameters) and the plain step (the plain unscale, update and
    selects, on copies): parameters, moments and count equal bit for bit
    after every step. LAMB: two 7-step trajectories from the same weights
    and batch, kernel and plain optimizer: losses within TRAIN_LOSS_BAND
    (K13/K15 sum in another order than the plain structure)."""
    from apex_tpu_torch.optimizers._base import apply_plain

    (model, scaler, opt, _, state, ss, ids, pos, labels) = _train_setup(
        dev, TRAIN["batch"], fused=True)
    plain_scaler = _plain_scaler()
    params = dict(model.named_parameters())
    plain = {n: p.detach().clone() for n, p in params.items()}
    pstate = opt.init(plain)
    steps = TRAIN["warmup"] + TRAIN["timed"]
    for i in range(steps):
        for p in params.values():
            p.grad = None
        loss = torch.mean(model(ids, pos, None, labels)) * ss.loss_scale
        loss.backward()
        with torch.no_grad():
            raw = {n: p.grad for n, p in params.items()}
            names = list(raw)
            grads, found = scaler.unscale(raw, ss)
            pgrads, pfound = plain_scaler.unscale(raw, ss)
            if found.item() != pfound.item() or not all(
                    _same_bits(grads[n], pgrads[n]) for n in names):
                raise AssertionError(f"step {i + 1}: K12 is not the plain "
                                     f"unscale")
            opt.step(grads, state, params, found)
            apply_plain(opt.update, pgrads, pstate, plain, pfound)
            ss = scaler.update(ss, found)
        same = all(_same_bits(params[n].detach(), plain[n]) for n in names)
        same &= all(_same_bits(a, b) for a, b in zip(
            _opt_state_tensors(state).values(),
            _opt_state_tensors(pstate).values()))
        if not same:
            raise AssertionError(f"Adam step {i + 1}: kernel and plain "
                                 f"optimizer disagree")
    _log(f"optimizer kernel vs plain, Adam: parameters, moments and count "
         f"equal bit for bit after each of {steps} steps")
    del model, opt, state, plain, pstate, params
    torch.cuda.empty_cache()

    losses = {}
    for path in ("kernel", "plain"):
        (model, _, opt, step, state, ss, ids, pos, labels) = _train_setup(
            dev, TRAIN["batch"], fused=True, opt="lamb")
        if path == "plain":
            step = _plain_opt_step(model, opt)
        vals = []
        for _ in range(steps):
            state, ss, loss = step(state, ss, ids, pos, labels)
            vals.append(loss)
        losses[path] = [x.item() for x in vals]
        del model, opt, step, state
        torch.cuda.empty_cache()
    worst = max(abs(a - b) for a, b in zip(*losses.values()))
    _log(f"optimizer kernel vs plain, LAMB: losses {json.dumps(losses)}, "
         f"largest difference {worst:.3e} (band {TRAIN_LOSS_BAND})")
    if worst > TRAIN_LOSS_BAND or not all(np.isfinite(losses["kernel"])):
        raise AssertionError("LAMB: kernel and plain optimizer disagree")
    return {"adam_bitwise_steps": steps, "lamb_losses": losses,
            "lamb_worst_loss_diff": worst}


def _plain_opt_step(model, opt, dropout_generator=None):
    """``make_one_step`` over the plain unscale and the optimizer without
    its fused form (so the step takes the update and the selects)."""
    from apex_tpu_torch.optimizers._base import GradientTransformation
    from apex_tpu_torch.train_step import make_one_step

    return make_one_step(model, _plain_scaler(),
                         GradientTransformation(opt.init, opt.update),
                         dropout_generator=dropout_generator)


def _plain_scaler():
    """A ``LossScaler`` whose unscale is the plain version (K12's) on the
    card too."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.ops import multi_tensor

    class PlainScaler(LossScaler):
        def unscale(self, grads, state):
            names = list(grads)
            outs, found = multi_tensor.scale_reference(
                [grads[n] for n in names], [torch.float32] * len(names),
                1.0 / state.loss_scale, True, torch.bool)
            return dict(zip(names, outs)), found

    return PlainScaler()


def _region_costs(fn, reps=5):
    """One optimizer region's costs: the host ms of a call (from a synced
    start, the call's return not waited on), and the device ms and the
    launches of a call from a torch.profiler trace of ``reps`` calls."""
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    prof, _, _ = _profiled(lambda: [fn() for _ in range(reps)], cpu=False)
    busy, launches = 0.0, 0
    for evt in _device_events(prof):
        busy += evt.self_device_time_total
        launches += evt.count
    return {"host_ms": statistics.median(host), "host_ms_all": host,
            "device_ms": busy / reps / 1e3, "launches": launches / reps}


# timed steps a turn of _step_turns
STEP_TURN_STEPS = 10


@contextlib.contextmanager
def _parent_optimizer():
    """The parent's K14 and K15 wrappers in this tree's place, on the
    parent's library (K12 and K13, whose C entries are this tree's, run
    on it too)."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import multi_tensor_cuda as mt

    pmt = PARENT_MODULES["multi_tensor"]
    with mock.patch.object(mt, "adam", pmt.adam), \
            mock.patch.object(mt, "lamb", pmt.lamb), \
            mock.patch.dict(_build._libs,
                            {"multi_tensor": PARENT["multi_tensor"]}):
        yield


def _step_turns(dev, name):
    """GPT-2-small's training window (the fused head, b=8, s=1024) under
    ``name``'s optimizer: the step ms (2 warm-up steps, then
    ``STEP_TURN_STEPS`` on the host clock ending in a sync) in turns with
    this tree's K14/K15 wrappers and the parent's, ten pairs, each side
    first in every other pair (turns of ~50 ms steps differ by a few
    percent); the training state carried from turn to turn. The step ms
    of each side is the median of its turns."""
    (_, _, _, step, state, ss, ids, pos, labels) = _train_setup(
        dev, TRAIN["batch"], fused=True, opt=name)
    out = {"step_ms_turns": [], "parent_step_ms_turns": []}
    for key in ("step_ms_turns", "parent_step_ms_turns",
                "parent_step_ms_turns", "step_ms_turns") * 5:
        with (_parent_optimizer() if key.startswith("parent")
              else contextlib.nullcontext()):
            for _ in range(2):
                state, ss, _ = step(state, ss, ids, pos, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEP_TURN_STEPS):
                state, ss, _ = step(state, ss, ids, pos, labels)
            torch.cuda.synchronize()
            out[key].append((time.perf_counter() - t0) / STEP_TURN_STEPS
                            * 1e3)
    out["step_ms"] = statistics.median(out["step_ms_turns"])
    out["parent_step_ms"] = statistics.median(out["parent_step_ms_turns"])
    out["pairs_faster"] = sum(a < b for a, b in zip(
        out["step_ms_turns"], out["parent_step_ms_turns"]))
    return out


def phase_optimizer_region(dev):
    """The training step's optimizer region alone (the unscale, the scaler
    update, the optimizer and the skip selects) on the window's real
    gradients (one backward of GPT-2-small with the fused head at b=8,
    s=1024, scaled by 2^16), for Adam and for LAMB: the kernel path
    (K12, then K14, or K13 + K15) against the plain path (the plain
    unscale, the functional update and the per-leaf selects) in turns,
    kernel, plain, kernel, plain: host ms a region, device ms and
    launches (torch.profiler). With ``--parent`` the kernel path on the
    parent's K14/K15 wrappers (``_parent_optimizer``) takes a turn after
    each plain one, and the window's step ms is taken in turns with the
    parent's (``_step_turns``)."""
    from apex_tpu_torch.optimizers._base import apply_plain

    (model, scaler, _, _, _, ss, ids, pos, labels) = _train_setup(
        dev, TRAIN["batch"], fused=True)
    params = dict(model.named_parameters())
    loss = torch.mean(model(ids, pos, None, labels)) * ss.loss_scale
    loss.backward()
    raw = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    plain_scaler = _plain_scaler()
    out = {}
    order = ("kernel", "plain") * 2
    if "multi_tensor" in PARENT:
        order = ("kernel", "plain", "parent") * 2
    for name in ("adam", "lamb"):
        opt = _make_opt(name)
        sets = {path: {n: p.detach().clone() for n, p in params.items()}
                for path in set(order)}
        states = {path: opt.init(ps) for path, ps in sets.items()}
        path_of = ["kernel"]

        def kernel():
            grads, found = scaler.unscale(raw, ss)
            scaler.update(ss, found)
            opt.step(grads, states[path_of[0]], sets[path_of[0]], found)

        def plain():
            grads, found = plain_scaler.unscale(raw, ss)
            plain_scaler.update(ss, found)
            apply_plain(opt.update, grads, states["plain"], sets["plain"],
                        found)

        with torch.no_grad():
            runs = {path: [] for path in order}
            for path in order:
                path_of[0] = path
                with (_parent_optimizer() if path == "parent"
                      else contextlib.nullcontext()):
                    runs[path].append(_region_costs(plain if path == "plain"
                                                    else kernel))
        out[name] = {path: {k: statistics.mean(r[k] for r in rs)
                            for k in ("host_ms", "device_ms", "launches")}
                     | {"turns": rs} for path, rs in runs.items()}
        _log(f"optimizer region, {name} (kernel vs plain, in turns): "
             + json.dumps({p: {k: v for k, v in r.items() if k != "turns"}
                           for p, r in out[name].items()}))
        del sets, states
        torch.cuda.empty_cache()
    del model, params, raw
    torch.cuda.empty_cache()
    if "multi_tensor" in PARENT:
        for name in ("adam", "lamb"):
            out[name]["window"] = _step_turns(dev, name)
            _log(f"GPT-2-small window, {name}, step ms against the parent's "
                 f"K14/K15 wrappers in turns: "
                 + json.dumps(out[name]["window"]))
            torch.cuda.empty_cache()
    return out


def phase_training_overflow(state):
    """A forced overflow: every parameter and the Adam state bitwise
    unchanged, the scale halved, ``unskipped`` reset. At a loss scale of
    3e38 the port's gradients stay finite (the largest is ~0.1 at init,
    and 0.1 x 3e38 < the fp32 maximum), so a hook makes the word-table
    gradient non-finite, as an overflow would."""
    model, scaler, step, opt_state, ss, ids, pos, labels = state
    ss = scaler.load_state_dict(ss, {"loss_scale": 3e38, "unskipped": 7})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    before_m = {n: t.clone() for n, t in opt_state.m.items()}
    before_v = {n: t.clone() for n, t in opt_state.v.items()}
    count = opt_state.count.item()
    hook = model.word_embeddings.register_hook(
        lambda g: g * float("inf"))
    opt_state, ss, _ = step(opt_state, ss, ids, pos, labels)
    hook.remove()
    torch.cuda.synchronize()
    same = all(torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters())
    same_state = (all(torch.equal(t, before_m[n])
                      for n, t in opt_state.m.items())
                  and all(torch.equal(t, before_v[n])
                          for n, t in opt_state.v.items())
                  and opt_state.count.item() == count)
    result = {"overflow": ss.overflow.item(),
              "loss_scale": ss.loss_scale.item(),
              "unskipped": ss.unskipped.item(),
              "params_unchanged": same, "adam_state_unchanged": same_state}
    _log("forced overflow: " + json.dumps(result))
    if not (result["overflow"] and same and same_state
            and result["loss_scale"] == np.float32(1.5e38)
            and result["unskipped"] == 0):
        raise AssertionError(f"the forced overflow was not skipped: {result}")
    return result


def _step_grads(model, ids, pos, labels, dropout_seed=None):
    """Loss and every gradient of one step (``pos`` is a BertModel's
    attention mask; a parameter outside the loss gives zeros); with
    ``dropout_seed``, trained with dropout from a generator seeded with it
    (the same masks and attention seeds on every call)."""
    from apex_tpu_torch.train_step import per_token_loss

    model.zero_grad(set_to_none=True)
    drop = {}
    if dropout_seed is not None:
        drop = dict(deterministic=False, dropout_generator=torch.Generator(
            device=ids.device).manual_seed(dropout_seed))
    loss = per_token_loss(model(ids, pos, None, labels, **drop)).mean()
    loss.backward()
    return loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                             else p.grad).float().clone()
                         for n, p in model.named_parameters()}


def _compare_steps(what, a, b):
    """Loss difference and worst gradient relative L2 of two (loss,
    grads) results, held to the training bands."""
    (a_loss, a_grads), (b_loss, b_grads) = a, b
    worst, worst_name = 0.0, ""
    for n, g in a_grads.items():
        ref = b_grads[n]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {n} gradient not finite")
        err = ((g - ref).norm() / ref.norm().clamp(min=1e-30)).item()
        if err > worst:
            worst, worst_name = err, n
    dloss = abs(a_loss - b_loss)
    _log(f"{what} (b=2): loss {a_loss:.6f} vs {b_loss:.6f} (band "
         f"{TRAIN_LOSS_BAND}), worst gradient relative L2 {worst:.3e} at "
         f"{worst_name} (band {TRAIN_GRAD_BAND})")
    if dloss > TRAIN_LOSS_BAND or worst > TRAIN_GRAD_BAND:
        raise AssertionError(f"{what}: the two steps disagree")
    return dloss, worst


def _plain_patches():
    """Patches that put the plain versions in the place of the attention
    (K1, K1d, K5/K6, K5d/K6d), layer-norm (K3/K4), LM-head (K7-K9) and
    softmax (K10/K11) kernels, for a step's plain path on the card."""
    from apex_tpu_torch.ops import (attention, attention_bwd_cuda,
                                    attention_cuda, layer_norm,
                                    layer_norm_cuda, softmax, softmax_cuda,
                                    xent, xent_cuda)

    def plain_fwd(q, k, v, *, causal, sm_scale, segment_ids=None):
        return attention._dense_attention(q, k, v, causal, sm_scale,
                                          segment_ids)

    def plain_bwd(q, k, v, o, do, *, causal, sm_scale, segment_ids=None):
        return attention._attention_bwd_split(q, k, v, o, do, causal,
                                              sm_scale, segment_ids)

    def plain_fwd_dropout(q, k, v, *, causal, sm_scale, dropout_p,
                          dropout_seed, segment_ids=None):
        return attention._dense_attention(q, k, v, causal, sm_scale,
                                          segment_ids, dropout_p,
                                          dropout_seed)

    def plain_bwd_dropout(q, k, v, o, do, *, causal, sm_scale, dropout_p,
                          dropout_seed, segment_ids=None):
        return attention._attention_bwd_split(q, k, v, o, do, causal,
                                              sm_scale, segment_ids,
                                              dropout_p, dropout_seed)

    def plain_ln_bwd(x, w, mean, rstd, dy):
        dx, dw, db = layer_norm.layer_norm_bwd(x, w, mean, rstd, dy)
        return dx, dw[None], db[None]

    return [
        mock.patch.object(attention_cuda, "prefill_attention", plain_fwd),
        mock.patch.object(attention_bwd_cuda, "attention_bwd", plain_bwd),
        mock.patch.object(attention_cuda, "prefill_attention_dropout",
                          plain_fwd_dropout),
        mock.patch.object(attention_bwd_cuda, "attention_bwd_dropout",
                          plain_bwd_dropout),
        mock.patch.object(layer_norm_cuda, "layer_norm_fwd",
                          layer_norm.layer_norm_fwd),
        mock.patch.object(layer_norm_cuda, "layer_norm_bwd", plain_ln_bwd),
        mock.patch.object(xent_cuda, "xent_fwd",
                          xent.linear_cross_entropy_fwd),
        mock.patch.object(xent_cuda, "xent_bwd_dx",
                          xent.linear_cross_entropy_dx),
        mock.patch.object(xent_cuda, "xent_bwd_de",
                          xent.linear_cross_entropy_de),
        mock.patch.object(softmax_cuda, "softmax_fwd",
                          softmax.scaled_masked_softmax_reference),
        mock.patch.object(softmax_cuda, "softmax_bwd",
                          softmax.scaled_masked_softmax_backward_reference)]


@contextlib.contextmanager
def _plain_path(patches=None):
    """The block runs the plain path: ``patches``, by default
    ``_plain_patches()``."""
    with contextlib.ExitStack() as stack:
        for patch in _plain_patches() if patches is None else patches:
            stack.enter_context(patch)
        yield


def phase_training_paths_agree(dev, fused, dropout=False, scores=False,
                               model=MODEL):
    """One step's loss and every gradient at b=2 through the kernel path
    and the plain path on the card (K1, K3-K6 and, with the fused head,
    K7-K9, with dropout K1d, K5d and K6d, on the scores path K10 and K11,
    patched to their plain versions) of GPT-2-small or ``model``; with
    dropout both paths draw the same masks and seeds. Returns the loss
    difference, the worst gradient's relative L2 and the kernel path's
    launch counts."""
    net, _, _, _, _, _, ids, pos, labels = _train_setup(
        dev, 2, seed=1, fused=fused, dropout=dropout, scores=scores,
        model=model)
    seed = 21 if dropout else None
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    kernel = _step_grads(net, ids, pos, labels, seed)
    kernel_launches = {k: fn.launches for k, fn in counts.items()}
    with _plain_path():
        plain = _step_grads(net, ids, pos, labels, seed)
    want = _want_launches(fused, dropout, "none", scores, model)
    if kernel_launches != want:
        raise AssertionError(f"the kernel path's step launched "
                             f"{kernel_launches}, want {want}")
    what = ("fused" if fused else "materialized") + " head" + (
        f", dropout {DROPOUT_P}" if dropout else "") + (
        ", scores path" if scores else "")
    if model is not MODEL:
        what += f", {model['hidden_size']} wide, {model['num_layers']} layers"
    dloss, worst = _compare_steps(f"training kernel vs plain path on the "
                                  f"card, {what}", kernel, plain)
    return dloss, worst, kernel_launches


def _bert_valid_lengths(rs, batch, seq, low, edges=True):
    """Seeded valid lengths of a padded BERT batch, uniform over [low,
    seq]; with ``edges`` row 0 all valid and row 1 a single valid
    token."""
    lengths = rs.randint(low, seq + 1, batch)
    if edges:
        lengths[0], lengths[1] = seq, 1
    return lengths


def _pad_ids(lengths, seq, dev):
    """int32 ``[b, seq]`` segment ids of a tail-padded batch: valid 0, pad
    1 (the padding route's ``validity == 0``)."""
    col = torch.arange(seq, device=dev)[None]
    return (col >= torch.as_tensor(lengths, device=dev)[:, None]).to(
        torch.int32).contiguous()


def phase_bert_mask_exact(dev):
    """K1d's mask on the non-causal segment-id route at BERT's 512 keys,
    at BERT-large's head dim 64 (the instantiation its main path launches)
    and at 128: q = k = 0, so a query's probabilities are uniform over the
    keys of its segment, and V the identity in blocks of d columns, so
    that O's nonzeros are the kept keys of the query's segment. They must
    be, bit for bit, where the plain ``dropout_mscale`` keeps (its global
    (batch, head, row, column) hash) and the segments agree, in fp32 and
    bf16, for two seeds; rows of one all-valid sequence and one of 200
    valid tokens."""
    from apex_tpu_torch.ops import attention, attention_cuda

    b, h, s = 2, 16, BERT_TRAIN["seq"]
    seg = _pad_ids([s, 200], s, dev)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    checked = 0
    for value in (-123456789, 2 ** 31 - 1):
        seed = torch.tensor([value], dtype=torch.int32, device=dev)
        want = (attention.dropout_mscale(seed, b, h, s, s, DROPOUT_P) > 0) \
            & same
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.zeros(b, h, s, d, device=dev, dtype=dtype)
                eye = torch.eye(s, device=dev, dtype=dtype)
                for j in range(s // d):
                    v = eye[:, j * d:(j + 1) * d].expand(b, h, s, d)
                    o = attention_cuda.prefill_attention_dropout(
                        q, q, v.contiguous(), causal=False, sm_scale=0.125,
                        dropout_p=DROPOUT_P, dropout_seed=seed,
                        segment_ids=(seg, seg))
                    bad = int(((o != 0)
                               != want[..., j * d:(j + 1) * d]).sum())
                    if bad:
                        raise AssertionError(
                            f"K1d's non-causal segment-id mask differs from "
                            f"the plain mask in {bad} elements (head dim "
                            f"{d}, {dtype}, seed {value}, key block {j})")
                    checked += o.numel()
    _log(f"K1d's mask on the segment-id route equals the plain mask: "
         f"{checked} elements ({b}x{h} heads x {s} rows x {s} keys, head "
         f"dims 64 and 128, fp32 and bf16, 2 seeds)")
    return {"elements": checked}


def phase_bert_kernel_modes(dev, flush):
    """The kernel modes BERT-large's main path runs and no earlier path
    did, at its shapes (b 16, 16 heads, s 512, head dim 64, bf16), each
    against its plain version, timed in turns around a library call and
    given a bound:

    * K1d, K5d, K6d non-causal with padding segment ids (``_pad_ids``;
      seeded valid lengths over [128, 512], row 0 all valid, row 1 one
      token), p = 0.1: the padding dropout window's route. The library
      call is SDPA with a boolean key-padding mask and dropout 0.1 (another
      mask and other pad rows: a time yardstick only);
    * K10 with the ``[16, 1, 512, 512]`` extended mask of those lengths
      (pad queries' rows fully masked: exact zeros), scale 24 (the 24th
      layer's query-key layer scaling), and K11 on its output: the scores
      path's mask mode. The library calls are ``torch.softmax`` on the
      pre-masked fp32 input and ``torch._softmax_backward_data``.

    Returns ``{kernel name: its BERT-large numbers}``."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (attention, attention_bwd_cuda,
                                    attention_cuda, softmax, softmax_cuda)
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        bert_extended_attention_mask)

    b, heads, s = BERT_TRAIN["batch"], BERT_LARGE["num_attention_heads"], \
        BERT_TRAIN["seq"]
    d = BERT_LARGE["hidden_size"] // heads
    rs = np.random.RandomState(12)
    lengths = _bert_valid_lengths(rs, b, s, BERT_TRAIN["min_valid"])
    seg = _pad_ids(lengths, s, dev)
    segs = (seg, seg)
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(b, heads, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([-987654321], dtype=torch.int32, device=dev)
    scale = d ** -0.5
    kw = dict(causal=False, sm_scale=scale, dropout_p=DROPOUT_P,
              dropout_seed=seed, segment_ids=segs)
    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
    ro = attention._dense_attention(q, k, v, False, scale, segs, DROPOUT_P,
                                    seed)
    torch.cuda.synchronize()
    k1_tol, tol = 5e-2, 5e-2
    fwd_err = {"max_abs_err": _max_err(o, ro), "rel_l2": _rel_l2(o, ro)}
    del ro
    dq, m, l, dcol = attention_bwd_cuda.attention_bwd_dq_dropout(
        q, k, v, o, do, **kw)
    dk, dv = attention_bwd_cuda.attention_bwd_dkv_dropout(
        q, k, v, do, m, l, dcol, **kw)
    rdq, rdk, rdv = attention._attention_bwd_split(
        q, k, v, o, do, False, scale, segs, DROPOUT_P, seed)
    torch.cuda.synchronize()
    pairs = {"dq": (dq, rdq), "dk": (dk, rdk), "dv": (dv, rdv)}
    l2 = {n: _rel_l2(a, r) for n, (a, r) in pairs.items()}
    errs = {n: _rel_err(a, r) for n, (a, r) in pairs.items()}
    abs_errs = {"dq": _max_err(dq, rdq),
                "dkv": max(_max_err(dk, rdk), _max_err(dv, rdv))}
    del pairs, rdq, rdk, rdv
    _log(f"BERT-large segment-id route: K1d {fwd_err} (tol {k1_tol}, "
         f"{K1_L2_TOL}); K5d/K6d relative L2 {l2} (tol {BF16_L2_TOL}), max "
         f"error over the largest magnitude {errs} (tol {tol})")
    if fwd_err["max_abs_err"] > k1_tol or fwd_err["rel_l2"] > K1_L2_TOL:
        raise AssertionError(f"K1d (segment ids) disagrees with its plain "
                             f"version: {fwd_err}")
    if max(l2.values()) > BF16_L2_TOL or max(errs.values()) > tol:
        raise AssertionError(f"K5d/K6d (segment ids) disagree with the "
                             f"plain backward: {l2}, {errs}")

    # SDPA's key padding: True where a key takes part
    key_pad = (seg == 0)[:, None, None, :]
    spreads = [[], [], []]
    fwd_ms, fwd_turns, fwd_lib = _time_in_turns(
        lambda: attention_cuda.prefill_attention_dropout(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=key_pad, dropout_p=DROPOUT_P, scale=scale),
        flush, spread=spreads[0])
    fwd_plain = _time_ms(lambda: attention._dense_attention(
        q, k, v, False, scale, segs, DROPOUT_P, seed), flush, reps=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=key_pad,
                                        dropout_p=DROPOUT_P, scale=scale)
    dq_turns, dkv_turns = [], []
    for turn in range(2):
        dq_turns.append(_time_ms(
            lambda: attention_bwd_cuda.attention_bwd_dq_dropout(
                q, k, v, o, do, **kw), flush,
            spread=spreads[1] if turn == 0 else None))
        dkv_turns.append(_time_ms(
            lambda: attention_bwd_cuda.attention_bwd_dkv_dropout(
                q, k, v, do, m, l, dcol, **kw), flush,
            spread=spreads[2] if turn == 0 else None))
        if turn == 0:
            bwd_lib = _time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do, retain_graph=True), flush)
    del og, qg, kg, vg
    bwd_plain = _time_ms(lambda: attention._attention_bwd_split(
        q, k, v, o, do, False, scale, segs, DROPOUT_P, seed), flush, reps=5)
    # a query attends the keys of its segment: the valid ones or the pads
    live = heads * int(sum(n * n + (s - n) * (s - n) for n in lengths))
    hash_ops = HASH_OPS_PER_PAIR * live
    t_bytes = q.numel() * q.element_size()
    seg_bytes = 2 * seg.numel() * 4
    stats = 3 * b * heads * s * 4
    fwd_bytes = 4 * t_bytes + seg_bytes + 4
    bwd_bytes = 6 * t_bytes + stats + seg_bytes + 4
    fwd_bound = _bound(fwd_bytes, 4 * d * live, int_ops=hash_ops)
    dq_bound = _bound(bwd_bytes, 6 * d * live, int_ops=hash_ops)
    dkv_bound = _bound(bwd_bytes, 8 * d * live, int_ops=hash_ops)
    shape = (f"q,k,v,dO [{b},{heads},{s},{d}] bf16, non-causal, segment "
             f"ids [{b},{s}] (valid lengths {sorted(int(n) for n in lengths)}"
             f"), p = {DROPOUT_P}")
    bwd_lib_note = ("backward of F.scaled_dot_product_attention with a "
                    "boolean key-padding attn_mask and dropout_p="
                    f"{DROPOUT_P}, dq, dk and dv together (another mask and "
                    "other pad rows: a time yardstick)")
    out = {
        "prefill_attention_dropout": dict(
            shape=shape, **fwd_err, tol=k1_tol, rel_l2_tol=K1_L2_TOL,
            ms=fwd_ms, ms_turns=fwd_turns, ms_spread=spreads[0],
            plain_ms=fwd_plain, library_ms=fwd_lib,
            library=("F.scaled_dot_product_attention with a boolean "
                     f"key-padding attn_mask, dropout_p={DROPOUT_P}"),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], live_pairs=live),
        "attention_bwd_dq_dropout": dict(
            shape=shape, max_abs_err=abs_errs["dq"], rel_l2=l2["dq"],
            rel_err=errs["dq"], ms=statistics.mean(dq_turns),
            ms_turns=dq_turns, ms_spread=spreads[1], plain_ms=bwd_plain,
            library_ms=bwd_lib, library=bwd_lib_note,
            bound_ms=dq_bound[0], bound_by=dq_bound[1], live_pairs=live),
        "attention_bwd_dkv_dropout": dict(
            shape=shape, max_abs_err=abs_errs["dkv"],
            rel_l2=max(l2["dk"], l2["dv"]),
            rel_err=max(errs["dk"], errs["dv"]),
            ms=statistics.mean(dkv_turns), ms_turns=dkv_turns,
            ms_spread=spreads[2], plain_ms=bwd_plain, library_ms=bwd_lib,
            library=bwd_lib_note, bound_ms=dkv_bound[0],
            bound_by=dkv_bound[1], live_pairs=live)}
    del q, k, v, do, o, dq, dk, dv, m, l, dcol
    torch.cuda.empty_cache()

    # K10's mask mode with the extended mask, then K11
    sm_scale = float(BERT_LARGE["num_layers"])
    x = (torch.randn(b, heads, s, s, generator=gen, device=dev) * 3
         / sm_scale).to(torch.bfloat16)
    g = torch.randn(b, heads, s, s, generator=gen, device=dev).to(
        torch.bfloat16)
    valid = (seg == 0).to(torch.int32)
    mask = bert_extended_attention_mask(valid)        # [b, 1, s, s]
    y = softmax_cuda.softmax_fwd(x, mask, sm_scale, False)
    dx = softmax_cuda.softmax_bwd(y, g, sm_scale)
    ry = softmax.scaled_masked_softmax_reference(x, mask, sm_scale, False)
    rdx = softmax.scaled_masked_softmax_backward_reference(y, g, sm_scale)
    torch.cuda.synchronize()
    dead = mask.all(dim=-1, keepdim=True).expand_as(y)
    sm_errs = {"fwd": {"max_abs_err": _max_err(y, ry),
                       "rel_l2": _rel_l2(y, ry),
                       "zeros_agree": bool(torch.equal(y == 0, ry == 0)),
                       "masked_rows_exact_zeros": bool(
                           (y[dead] == 0).all()),
                       "masked_rows": int(mask.all(dim=-1).sum())},
               "bwd": {"max_abs_err": _max_err(dx, rdx),
                       "rel_l2": _rel_l2(dx, rdx),
                       "zeros_agree": bool((dx[y == 0] == 0).all())}}
    del ry, rdx
    _log(f"BERT-large K10 mask mode / K11: {sm_errs} (tol relative L2 "
         f"{SOFTMAX_L2_TOL}, max |y diff| {SOFTMAX_Y_TOL})")
    for name, e in sm_errs.items():
        if (e["rel_l2"] > SOFTMAX_L2_TOL or not e["zeros_agree"]
                or (name == "fwd" and (e["max_abs_err"] > SOFTMAX_Y_TOL
                                       or not e["masked_rows_exact_zeros"]))):
            raise AssertionError(f"K10/K11 ({name}, BERT-large mask) "
                                 f"disagree with their plain versions: {e}")
    xm = torch.where(mask, torch.finfo(torch.float32).min,
                     x.float() * sm_scale)
    spreads = [[], []]
    fwd = _time_in_turns(
        lambda: softmax_cuda.softmax_fwd(x, mask, sm_scale, False),
        lambda: torch.softmax(xm, dim=-1), flush, spread=spreads[0])
    del xm
    bwd = _time_in_turns(
        lambda: softmax_cuda.softmax_bwd(y, g, sm_scale),
        lambda: torch._softmax_backward_data(g, y, -1, torch.bfloat16),
        flush, spread=spreads[1])
    fwd_plain = _time_ms(lambda: softmax.scaled_masked_softmax_reference(
        x, mask, sm_scale, False), flush, reps=5)
    bwd_plain = _time_ms(
        lambda: softmax.scaled_masked_softmax_backward_reference(
            y, g, sm_scale), flush, reps=5)
    # what the function needs: K10 reads x only at the unmasked pairs (a
    # masked pair's output is decided by the mask alone), reads the mask
    # and writes every y; K11 reads every y, g only where y can be nonzero
    # (the unmasked pairs), and writes every dx
    elems = x.numel()
    sm_live = heads * int((~mask).sum().item())
    fwd_bytes = 2 * sm_live + mask.numel() + 2 * elems
    bwd_bytes = 2 * elems + 2 * sm_live + 2 * elems
    fwd_bound = _bound(fwd_bytes, 5 * sm_live, FP32_FLOPS_PER_S)
    bwd_bound = _bound(bwd_bytes, 4 * sm_live, FP32_FLOPS_PER_S)
    sm_shape = (f"x, g [{b},{heads},{s},{s}] bf16, mask [{b},1,{s},{s}] "
                f"bool (the extended mask of the same lengths), scale "
                f"{sm_scale}")
    out["softmax_fwd"] = dict(
        shape=sm_shape, **sm_errs["fwd"], ms=fwd[0], ms_turns=fwd[1],
        ms_spread=spreads[0], library_ms=fwd[2],
        library=("torch.softmax over the fp32-upcast, pre-masked scores "
                 "(masking excluded)"), plain_ms=fwd_plain,
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], bytes=fwd_bytes,
        live_pairs=sm_live)
    out["softmax_bwd"] = dict(
        shape=sm_shape, **sm_errs["bwd"], ms=bwd[0], ms_turns=bwd[1],
        ms_spread=spreads[1], library_ms=bwd[2],
        library="torch._softmax_backward_data on the same y and g",
        plain_ms=bwd_plain, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        bytes=bwd_bytes, live_pairs=sm_live)
    del x, g, y, dx, mask
    torch.cuda.empty_cache()
    _log("BERT-large kernel modes: " + json.dumps(out))
    return out


def _bert_cfg(window, layers=None):
    """BERT-large's configuration for window "A" (dropout 0) or "B"
    (dropout 0.1), optionally cut to ``layers``."""
    from apex_tpu_torch.transformer.testing import TransformerConfig

    drop = DROPOUT_P if window == "B" else 0.0
    return TransformerConfig(**dict(
        BERT_LARGE, num_layers=layers or BERT_LARGE["num_layers"]),
        hidden_dropout=drop, attention_dropout=drop,
        recompute_granularity="none", softmax_use_pallas=True)


def _bert_batch(window, batch, vocab, dev):
    """ids, the attention mask and labels of a window, from
    ``np.random.RandomState(0)``: window A all valid, window B padded at
    the tail to seeded lengths over [``min_valid``, s] (mask 0, token 0)."""
    s = BERT_TRAIN["seq"]
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (batch, s))
    labels = rs.randint(0, vocab, (batch, s))
    mask = np.ones((batch, s), np.int64)
    if window == "B":
        lengths = _bert_valid_lengths(rs, batch, s, BERT_TRAIN["min_valid"],
                                      edges=False)
        for row, n in enumerate(lengths):
            mask[row, n:] = 0
            ids[row, n:] = 0
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, mask, labels))


def _bert_setup(dev, window, batch, layers=None, seed=0):
    """The model, scaler, LAMB (``fused_lamb(lr)`` with its defaults, as
    profile_pretrain.py builds it), step, states and batch of a window."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.testing import BertModel

    cfg = _bert_cfg(window, layers)
    model = BertModel(cfg, device=dev, seed=seed)
    scaler, opt = LossScaler(), fused_lamb(learning_rate=BERT_TRAIN["lr"])
    gen = None
    if window == "B":
        gen = torch.Generator(device=dev).manual_seed(11)
    step = make_one_step(model, scaler, opt, dropout_generator=gen)
    ids, mask, labels = _bert_batch(window, batch, cfg.vocab_size, dev)
    return (model, scaler, opt, step, opt.init(dict(model.named_parameters())),
            scaler.init(dev), ids, mask, labels)


def _bert_want_launches(window, layers, leaves):
    """Launches per step: window A the scores path (K10, K11 a layer), B
    the segment-id route (K1d, K5d, K6d a layer); K3/K4 twice a layer,
    the final layer norm's and the LM head's; K12 once and K13 twice a
    group of the leaves, K15 once a list; nothing else."""
    from apex_tpu_torch.ops import multi_tensor_cuda

    def groups(depth):
        return -(-leaves // multi_tensor_cuda.capacity(depth))

    want = dict.fromkeys(_training_counts(), 0)
    attn = (("softmax_fwd", "softmax_bwd") if window == "A" else
            ("prefill_attention_dropout", "attention_bwd_dq_dropout",
             "attention_bwd_dkv_dropout"))
    want.update(dict.fromkeys(attn, layers))
    want.update(layer_norm_fwd=2 * layers + 2, layer_norm_bwd=2 * layers + 2,
                multi_tensor_scale=groups(2),
                multi_tensor_l2norm=2 * groups(1),
                multi_tensor_lamb=-(-leaves
                                     // multi_tensor_cuda.list_capacity()))
    return want


def phase_bert_training(dev, card, window):
    """BERT-large trained by ``make_one_step`` with ``fused_lamb`` at b =
    16, s = 512 (window A or B, see ``BERT_LARGE``): 2 warm-up and 5 timed
    steps (host clock ending in ``synchronize``), the launches a step
    (``_bert_want_launches``), step ms, tokens/s, MFU (6 N b s over the
    step at 989 TFLOP/s), peak memory, the losses of steps 1-7 (finite and
    falling), then a profiled two-step window."""
    b, s = BERT_TRAIN["batch"], BERT_TRAIN["seq"]
    t0 = time.perf_counter()
    (model, scaler, opt, step, opt_state, ss, ids, mask,
     labels) = _bert_setup(dev, window, b)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    leaves = len(list(model.parameters()))
    _log(f"BertModel (window {window}) built in "
         f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, "
         f"{leaves} leaves")
    losses = []
    for _ in range(BERT_TRAIN["warmup"]):
        opt_state, ss, loss = step(opt_state, ss, ids, mask, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(BERT_TRAIN["timed"]):
        opt_state, ss, loss = step(opt_state, ss, ids, mask, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses]
    step_ms = wall / BERT_TRAIN["timed"] * 1e3
    valid = int(mask.sum().item())
    stats = {"card": card, "window": window,
             "dropout": DROPOUT_P if window == "B" else 0.0,
             "batch": b, "seq": s, "valid_tokens": valid,
             "steps_timed": BERT_TRAIN["timed"], "step_ms": step_ms,
             "tokens_per_s": b * s / (step_ms / 1e3),
             "valid_tokens_per_s": valid / (step_ms / 1e3),
             "mfu": 6 * n_params * b * s / (step_ms / 1e3) / BF16_FLOPS_PER_S,
             "n_params": n_params, "leaves": leaves,
             "peak_mem_gb": peak / 1e9, "loss_step1": vals[0],
             "loss_last": vals[-1], "losses": vals,
             "launches_per_step": {k: v / BERT_TRAIN["timed"]
                                   for k, v in launches.items() if v}}
    _log(f"BERT-large window {window}: " + json.dumps(stats))
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        raise AssertionError(f"BERT-large window {window}: loss not finite "
                             f"and falling: {vals}")
    want = _bert_want_launches(window, BERT_LARGE["num_layers"], leaves)
    for k, per_step in want.items():
        if launches[k] != per_step * BERT_TRAIN["timed"]:
            raise AssertionError(f"BERT-large window {window}: {k} "
                                 f"launched {launches[k]} times in "
                                 f"{BERT_TRAIN['timed']} steps, want "
                                 f"{per_step} a step")
    stats["profile"] = phase_training_profile(
        (model, scaler, step, opt_state, ss, ids, mask, labels))
    del model, opt, step, opt_state
    torch.cuda.empty_cache()
    return launches, stats


def phase_bert_paths_agree(dev, window):
    """BERT-large's width over ``BERT_AGREE``'s 2 layers at b = 2, s = 512,
    on window ``window``'s route: one step's loss and every gradient
    through the kernel path and the plain path (the attention, layer-norm
    and softmax kernels patched to their plain versions; the same weights
    and draws) within the training bands; then one ``make_one_step`` with
    LAMB on each path from the same weights (the plain path with the
    plain unscale and the functional LAMB update): the pooler's and the
    binary head's parameters, which move by weight decay alone, must
    match within ``MT_LAMB_TOL`` of their largest magnitude."""
    layers, b = BERT_AGREE["layers"], BERT_AGREE["batch"]
    (net, _, opt, _, _, _, ids, mask, labels) = _bert_setup(
        dev, window, b, layers=layers, seed=1)
    seed = 21 if window == "B" else None
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    kernel = _step_grads(net, ids, mask, labels, seed)
    kernel_launches = {k: fn.launches for k, fn in counts.items() if
                       fn.launches}
    with _plain_path():
        plain = _step_grads(net, ids, mask, labels, seed)
    attn = ("softmax_fwd" if window == "A" else "prefill_attention_dropout")
    if kernel_launches.get(attn) != layers:
        raise AssertionError(f"BERT paths agree, window {window}: the kernel "
                             f"path launched {kernel_launches}")
    dloss, worst = _compare_steps(
        f"BERT-large width, {layers} layers, window {window}: kernel vs "
        f"plain path", kernel, plain)
    del net
    torch.cuda.empty_cache()

    # one LAMB step on each path from the same weights and draws
    after = {}
    for path in ("kernel", "plain"):
        (net, _, opt, step, state, ss, ids, mask, labels) = _bert_setup(
            dev, window, b, layers=layers, seed=1)
        if path == "plain":
            gen = None
            if window == "B":       # the draws of the kernel path's step
                gen = torch.Generator(device=dev).manual_seed(11)
            step = _plain_opt_step(net, opt, dropout_generator=gen)
        with _plain_path() if path == "plain" else contextlib.nullcontext():
            state, ss, _ = step(state, ss, ids, mask, labels)
        after[path] = {n: p.detach().clone() for n, p in
                       net.named_parameters()
                       if n.startswith(("pooler.", "binary_head."))}
        del net, opt, step, state
        torch.cuda.empty_cache()
    worst_head = _worst_rel(after["kernel"], after["plain"])
    _log(f"BERT-large width, window {window}: pooler and binary head after "
         f"one LAMB step, kernel vs plain path: worst {worst_head:.3e} of "
         f"the largest magnitude (band {MT_LAMB_TOL})")
    if worst_head > MT_LAMB_TOL:
        raise AssertionError(f"window {window}: the pooler and binary head "
                             f"moved differently under LAMB")
    return {"loss_diff": dloss, "worst_grad_rel_l2": worst,
            "pooler_binary_head_worst": worst_head,
            "kernel_launches": kernel_launches}


def phase_gpt3_2p7b(dev):
    """GPT-3 2.7B's widths (``GPT3_2P7B``: hidden 2560, 32 heads of 80, ffn
    10240, vocab 50304; depth cut to 2 layers), random weights from torch
    seed 0, end to end. Serving: ``ServingEngine`` (4 slots, page size
    128, 72 pages, 512-token packed prefill) serves a seeded trace of 6
    greedy requests to completion, K1 and K2 launching once a layer a
    prefill batch and a decode step; then one packed prefill batch and 4
    decode steps through the kernel path and the plain path, logits within
    ``LOGITS_BAND``. Training: one step at b = 2, s = 1024 through the
    kernel path and the plain path, within the training bands. K1, K2, K3,
    K4, K5 and K6 must each have launched. Returns the launch counts of the
    two runs and their numbers."""
    from apex_tpu_torch.ops import attention_cuda, decode_attention_cuda
    from apex_tpu_torch.serving import ServingEngine, synthetic_trace
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**GPT3_2P7B)
    if cfg.head_dim != 80:
        raise AssertionError(f"GPT-3 2.7B's head dim is 80, got "
                             f"{cfg.head_dim}")
    counted = {"prefill_attention": attention_cuda.prefill_attention,
               "decode_attention": decode_attention_cuda.decode_attention}
    for fn in counted.values():
        fn.launches = 0
    engine = ServingEngine(cfg, seed=0, device=dev, **GPT3_ENGINE)
    reqs, trace_id = synthetic_trace(vocab=cfg.vocab_size, **GPT3_TRACE)
    t0 = time.perf_counter()
    engine.run_trace(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefills, decodes = engine.prefill_batches, engine.decode_steps
    tokens = engine.tokens_generated
    traced, (tp, td) = _traced_serve(engine, _offset_rids(synthetic_trace(
        vocab=cfg.vocab_size, **GPT3_TRACE)[0], 3000))
    serving_launches = {k: fn.launches for k, fn in counted.items()}
    L = cfg.num_layers
    want = {"prefill_attention": engine.prefill_batches * L,
            "decode_attention": _decode_calls(engine) * L}
    traced = {k: traced[k] for k in counted}
    want_traced = {"prefill_attention": tp * L, "decode_attention": td * L}
    if serving_launches != want or traced != want_traced:
        raise AssertionError(f"GPT-3 2.7B serving launched "
                             f"{serving_launches}, want {want}; the device "
                             f"ran {traced} in the traced run, want "
                             f"{want_traced}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid} did not complete")
    logits = phase_paths_agree(engine, dev)
    worst_logit = None if logits is None else max(
        float(t.abs().max()) for t in logits)
    del engine, logits
    torch.cuda.empty_cache()
    dloss, worst_grad, train_launches = phase_training_paths_agree(
        dev, fused=False, model=GPT3_2P7B)
    torch.cuda.empty_cache()
    launched = {**serving_launches, **train_launches}
    for name in ("prefill_attention", "decode_attention", "layer_norm_fwd",
                 "layer_norm_bwd", "attention_bwd_dq", "attention_bwd_dkv"):
        if not launched.get(name):
            raise AssertionError(f"GPT-3 2.7B: {name} never launched")
    stats = {"config": "GPT-3 2.7B widths, 2 of 32 layers", "head_dim": 80,
             "trace_id": trace_id, "requests": len(reqs), "tokens": tokens,
             "prefill_batches": prefills, "decode_steps": decodes,
             "serving_wall_s": wall, "tokens_per_s": tokens / wall,
             "traced_run_kernels": traced, "largest_logit": worst_logit, "train_loss_diff": dloss,
             "train_worst_grad_rel_l2": worst_grad}
    _log("GPT-3 2.7B widths: " + json.dumps(stats))
    return serving_launches, train_launches, stats


def _wide_window(dev, model, dropout):
    """``WIDE_WINDOW``'s training steps of ``model`` (materialized head;
    dropout 0.1 from a seeded generator if ``dropout``): step ms, peak
    memory, the losses and the launches per step, which must be
    ``_want_launches``'s."""
    b, w = WIDE_WINDOW["batch"], WIDE_WINDOW
    (net, _, opt, step, opt_state, ss, ids, pos, labels) = _train_setup(
        dev, b, dropout=dropout, model=model)
    losses = []
    for _ in range(w["warmup"]):
        opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(w["timed"]):
        opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / w["timed"] * 1e3
    launches = {k: fn.launches for k, fn in counts.items()}
    vals = [x.item() for x in losses]
    n_params = sum(p.numel() for p in net.parameters())
    del net, opt, step, opt_state, ss
    torch.cuda.empty_cache()
    want = {k: n * w["timed"] for k, n in
            _want_launches(False, dropout, "none", model=model,
                           opt="adam").items()}
    if launches != want:
        raise AssertionError(f"{model['hidden_size']} wide, dropout "
                             f"{dropout}: launched {launches}, want {want}")
    if not all(np.isfinite(vals)):
        raise AssertionError(f"training loss not finite: {vals}")
    return {"dropout": DROPOUT_P if dropout else 0.0, "batch": b,
            "seq": TRAIN["seq"], "steps_timed": w["timed"],
            "step_ms": step_ms, "tokens_per_s": b * TRAIN["seq"] / step_ms
            * 1e3, "n_params": n_params,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": vals,
            "launches_per_step": {k: v / w["timed"]
                                  for k, v in launches.items() if v}}


def phase_gptj_6b(dev):
    """GPT-J-6B's attention widths (``GPTJ_6B``: hidden 4096, 16 heads of
    256, ffn 16384, vocab 50400; 2 of 28 layers; random weights from torch
    seed 0), bf16, the materialized head, b = 2, s = 1024: without and
    with dropout 0.1, ``WIDE_WINDOW``'s steps (K1, K5, K6 or K1d, K5d,
    K6d once a layer a step, at their D = 256 bodies) and one step through
    the kernel path against the plain path within the training bands.
    Returns the launch counts of each window and its numbers."""
    launches, stats = {}, {}
    for dropout in (False, True):
        key = "dropout" if dropout else "no_dropout"
        stats[key] = _wide_window(dev, GPTJ_6B, dropout)
        dloss, worst, launches[key] = phase_training_paths_agree(
            dev, fused=False, dropout=dropout, model=GPTJ_6B)
        stats[key].update(train_loss_diff=dloss,
                          train_worst_grad_rel_l2=worst)
        torch.cuda.empty_cache()
    for key, names in (("no_dropout", ("prefill_attention",
                                       "attention_bwd_dq",
                                       "attention_bwd_dkv")),
                       ("dropout", ("prefill_attention_dropout",
                                    "attention_bwd_dq_dropout",
                                    "attention_bwd_dkv_dropout"))):
        for name in names:
            if not launches[key].get(name):
                raise AssertionError(f"GPT-J-6B widths ({key}): {name} "
                                     f"never launched")
    _log("GPT-J-6B widths (2 of 28 layers): " + json.dumps(stats))
    return launches, stats


def phase_head_dim_320(dev):
    """``HD320`` (4 heads of 320, past the attention kernels' 256), bf16:
    one training step without and one with dropout 0.1 through the kernel
    path against the plain path within the training bands, K10 and K11
    once a layer (the scores route; with dropout the scores path) and no
    attention kernel; the timed window of each; then ``ServingEngine``
    (``ENGINE``'s 8 slots and 72 pages of 128) serves ``GPT3_TRACE``'s
    seeded greedy requests, K10 once a layer a prefill batch and K2 (its
    512 bucket) once a layer a decode step, K1 never; the kernel and
    plain paths' logits within ``LOGITS_BAND``. Returns the launch counts
    of the runs and their numbers."""
    from apex_tpu_torch.ops import (attention_cuda, decode_attention_cuda,
                                    softmax_cuda)
    from apex_tpu_torch.serving import ServingEngine, synthetic_trace
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**HD320)
    if cfg.head_dim != 320:
        raise AssertionError(f"HD320's head dim is {cfg.head_dim}")
    launches, stats = {}, {}
    for dropout in (False, True):
        key = "training_dropout" if dropout else "training"
        stats[key] = _wide_window(dev, HD320, dropout)
        dloss, worst, launches[key] = phase_training_paths_agree(
            dev, fused=False, dropout=dropout, model=HD320)
        stats[key].update(train_loss_diff=dloss,
                          train_worst_grad_rel_l2=worst)
        if not (launches[key]["softmax_fwd"] and launches[key]["softmax_bwd"]):
            raise AssertionError(f"head dim 320 ({key}): K10/K11 never "
                                 f"launched: {launches[key]}")
        torch.cuda.empty_cache()

    counted = {"prefill_attention": attention_cuda.prefill_attention,
               "decode_attention": decode_attention_cuda.decode_attention,
               "softmax_fwd": softmax_cuda.softmax_fwd}
    for fn in counted.values():
        fn.launches = 0
    engine = ServingEngine(cfg, seed=0, device=dev, **ENGINE)
    reqs, trace_id = synthetic_trace(vocab=cfg.vocab_size, **GPT3_TRACE)
    t0 = time.perf_counter()
    engine.run_trace(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefills, decodes = engine.prefill_batches, engine.decode_steps
    tokens = engine.tokens_generated
    traced, (tp, td) = _traced_serve(engine, _offset_rids(synthetic_trace(
        vocab=cfg.vocab_size, **GPT3_TRACE)[0], 3000))
    launches["serving"] = {k: fn.launches for k, fn in counted.items()}
    L = cfg.num_layers
    want = {"prefill_attention": 0,
            "decode_attention": _decode_calls(engine) * L,
            "softmax_fwd": engine.prefill_batches * L}
    traced = {k: traced[k] for k in counted}
    want_traced = {"prefill_attention": 0, "decode_attention": td * L,
                   "softmax_fwd": tp * L}
    if launches["serving"] != want or traced != want_traced or not td:
        raise AssertionError(f"head dim 320 serving launched "
                             f"{launches['serving']}, want {want}; the "
                             f"device ran {traced} in the traced run, want "
                             f"{want_traced}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid} did not complete")
    if decode_attention_cuda.plan(320, ENGINE["page_size"], 8, 2)[0] != 512:
        raise AssertionError("head dim 320 does not decode at the 512 bucket")
    logits = phase_paths_agree(engine, dev)
    stats["serving"] = {
        "trace_id": trace_id, "requests": len(reqs), "tokens": tokens,
        "prefill_batches": prefills, "decode_steps": decodes,
        "serving_wall_s": wall, "tokens_per_s": tokens / wall,
        "traced_run_kernels": traced,
        "largest_logit": max(float(t.abs().max()) for t in logits)}
    del engine, logits
    torch.cuda.empty_cache()
    _log("head dim 320 (4 heads, 2 layers): " + json.dumps(stats))
    return launches, stats


def phase_head_dim_576(dev):
    """``HD576`` (2 heads of 576, past the decode kernels' 512), bf16:
    ``ServingEngine`` (``ENGINE``'s 8 slots and 72 pages of 128) serves
    ``GPT3_TRACE``'s seeded greedy requests; decode takes its scores route,
    so K10 launches once a layer a prefill batch and a decode step, and
    K1, K2 and K2q never; the kernel and plain paths' logits within
    ``LOGITS_BAND``. Returns the launch counts and the numbers."""
    from apex_tpu_torch.ops import (attention_cuda, decode_attention_cuda,
                                    softmax_cuda)
    from apex_tpu_torch.serving import ServingEngine, synthetic_trace
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**HD576)
    if cfg.head_dim != 576:
        raise AssertionError(f"HD576's head dim is {cfg.head_dim}")
    counted = {"prefill_attention": attention_cuda.prefill_attention,
               "decode_attention": decode_attention_cuda.decode_attention,
               "decode_attention_quant":
                   decode_attention_cuda.decode_attention_quant,
               "softmax_fwd": softmax_cuda.softmax_fwd}
    for fn in counted.values():
        fn.launches = 0
    engine = ServingEngine(cfg, seed=0, device=dev, **ENGINE)
    reqs, trace_id = synthetic_trace(vocab=cfg.vocab_size, **GPT3_TRACE)
    t0 = time.perf_counter()
    engine.run_trace(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefills, decodes = engine.prefill_batches, engine.decode_steps
    tokens = engine.tokens_generated
    traced, (tp, td) = _traced_serve(engine, _offset_rids(synthetic_trace(
        vocab=cfg.vocab_size, **GPT3_TRACE)[0], 3000))
    launches = {k: fn.launches for k, fn in counted.items()}
    L = cfg.num_layers
    want = {"prefill_attention": 0, "decode_attention": 0,
            "decode_attention_quant": 0,
            "softmax_fwd": (engine.prefill_batches + _decode_calls(engine))
            * L}
    traced = {k: traced[k] for k in counted}
    want_traced = dict(want, softmax_fwd=(tp + td) * L)
    if launches != want or traced != want_traced or not td:
        raise AssertionError(f"head dim 576 serving launched {launches}, "
                             f"want {want}; the device ran {traced} in the "
                             f"traced run, want {want_traced}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid} did not complete")
    logits = phase_paths_agree(engine, dev)
    stats = {"trace_id": trace_id, "requests": len(reqs), "tokens": tokens,
             "prefill_batches": prefills, "decode_steps": decodes,
             "serving_wall_s": wall, "tokens_per_s": tokens / wall,
             "traced_run_kernels": traced,
             "largest_logit": max(float(t.abs().max()) for t in logits)}
    del engine, logits
    torch.cuda.empty_cache()
    _log("head dim 576 serving (2 heads, 2 layers): " + json.dumps(stats))
    return launches, stats


def phase_recompute_agree(dev):
    """``"selective"`` and ``"full"`` recompute against ``"none"`` at b=2
    with dropout on the kernel path: one weight seed, one generator seed,
    so the same masks and attention seeds; within the training bands, and
    whether they were bit for bit equal."""
    out = {}
    ref = None
    for granularity in ("none", "selective", "full"):
        model, _, _, _, _, _, ids, pos, labels = _train_setup(
            dev, 2, seed=1, dropout=True, recompute=granularity)
        got = _step_grads(model, ids, pos, labels, dropout_seed=21)
        del model
        if ref is None:
            ref = got
            continue
        bitwise = got[0] == ref[0] and all(
            torch.equal(g, ref[1][n]) for n, g in got[1].items())
        dloss, worst = _compare_steps(
            f"recompute {granularity} vs none, dropout {DROPOUT_P}, kernel "
            f"path", got, ref)
        _log(f"recompute {granularity} vs none: bit for bit {bitwise}")
        out[granularity] = {"loss_diff": dloss, "worst_grad_rel_l2": worst,
                            "bitwise": bitwise}
    return out


def phase_fused_vs_materialized(dev):
    """One b=2 step of the fused-head model against the materialized-head
    model on the same weights (seed 1), both on the kernel path."""
    fused_model, _, _, _, _, _, ids, pos, labels = _train_setup(
        dev, 2, seed=1, fused=True)
    fused = _step_grads(fused_model, ids, pos, labels)
    del fused_model
    model = _train_setup(dev, 2, seed=1)[0]
    return _compare_steps("fused vs materialized LM head on the card",
                          fused, _step_grads(model, ids, pos, labels))


def _tp_device(rank, backend):
    """A rank's card: its own over NCCL, the shared first card over gloo."""
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _tp_rank(rank, world, tmp, backend, card):
    """One rank of the tp = 2 training phase (started with ``spawn``):
    the parity step at b=2 against the tp = 1 reference the parent saved,
    then the timed window at b=8, s=1024; the results go to
    ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state

    dev = _tp_device(rank, backend)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        parallel_state.initialize_model_parallel(world, backend=backend)
        out = {"rank": rank, "device": str(dev), "backend": backend,
               "parity": _tp_parity(dev, rank, world, tmp),
               "window": _tp_window(dev, rank, card)}
        torch.save(out, f"{tmp}/rank{rank}.pt")
        parallel_state.destroy_model_parallel()
    finally:
        dist.destroy_process_group()


def _tp_parity(dev, rank, world, tmp):
    """This rank's loss and, for each of its parameters, the squared
    difference of its gradient from the reference's slice and the slice's
    squared norm (the parent sums them over the ranks)."""
    from apex_tpu_torch.serving import weights

    model, _, _, _, _, _, ids, pos, labels = _train_setup(
        dev, 2, seed=1, fused=True, tp=world)
    loss, grads = _step_grads(model, ids, pos, labels)
    del model
    ref = torch.load(f"{tmp}/ref.pt", weights_only=False)
    tree = {}
    for name, g in ref["grads"].items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = g
    mine = weights.shard_param_tree(tree, _train_cfg(fused=True,
                                                     vocab=TP_VOCAB),
                                    rank, world)
    out = {}
    for name, g in grads.items():
        node = mine
        for key in name.split("."):
            node = node[key]
        r = node.to(dev).float()
        out[name] = (((g - r) ** 2).sum().item(), (r ** 2).sum().item(),
                     weights.shard_axis(name.replace(".", "/")) is not None)
    return {"loss": loss, "grads": out}


def _tp_window(dev, rank, card):
    """The timed tp = 2 window, as :func:`phase_training` runs a tp = 1
    one: warm-up, the counts zeroed, the timed steps, the counts, peak
    memory and losses read after; then two profiled steps (rank 0's
    profile; rank 1 runs them unprofiled)."""
    import torch.distributed as dist

    b, s = TRAIN["batch"], TRAIN["seq"]
    t0 = time.perf_counter()
    (model, scaler, opt, step, opt_state, ss, ids, pos,
     labels) = _train_setup(dev, b, fused=True, tp=TP_SIZE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN["warmup"]):
        opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    dist.barrier()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TRAIN["timed"]):
        opt_state, ss, loss = step(opt_state, ss, ids, pos, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    vals = [x.item() for x in losses]
    step_ms = wall / TRAIN["timed"] * 1e3
    dist.barrier()

    def two_steps():
        nonlocal opt_state, ss
        for _ in range(2):
            opt_state, ss, _ = step(opt_state, ss, ids, pos, labels)

    kinds = ("attention_fwd", "attention_bwd", "layer_norm", "lm_head",
             "matmul", "optimizer", "other")
    profile = (_profile(two_steps, kinds, attempts=1) if rank == 0
               else two_steps())
    comm = _tp_collectives(dev, two_steps)
    return {"card": card, "build_s": build_s,
            "rank_params": sum(p.numel() for p in model.parameters()),
            "step_ms": step_ms, "tokens_per_s": b * s / (step_ms / 1e3),
            "peak_mem_gb": peak / 1e9, "losses": vals,
            "launches": launches, "profile": profile, "collectives": comm}


def _tp_collectives(dev, two_steps):
    """What the tp group's collectives cost this rank: the all-reduces two
    steps make (count and bytes, per step), and the mean time of 10
    all-reduces of one ``[s, b, h]`` bf16 activation through the port's
    mapping, host clock ending in ``synchronize``."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer.tensor_parallel import mappings

    calls = []
    all_reduce = dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel() * t.element_size())
        return all_reduce(t, *args, **kwargs)

    with mock.patch.object(dist, "all_reduce", counted):
        two_steps()
    act = torch.randn(TRAIN["seq"] * TRAIN["batch"], MODEL["hidden_size"],
                      device=dev).to(torch.bfloat16)
    mappings.all_reduce_(act)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(10):
        mappings.all_reduce_(act)
    torch.cuda.synchronize()
    return {"all_reduces_per_step": len(calls) / 2,
            "all_reduce_mb_per_step": sum(calls) / 2 / 1e6,
            "activation_all_reduce_ms":
                (time.perf_counter() - t0) / 10 * 1e3,
            "activation_mb": act.numel() * act.element_size() / 1e6}


def phase_training_tp2(dev, card):
    """This slice's main path: GPT-2-small (vocabulary padded to 50432 for
    tp = 2, the fused head) trained at tensor-parallel size 2 by
    ``make_one_step`` with the ``GradScaler``, in two ranks started with
    ``spawn`` (the kernels already built by this process). With two or
    more cards each rank takes its own over NCCL; with one, both ranks
    share it over gloo, which runs the all-reduces of CUDA tensors
    through the host. The parent first runs one step at b=2 at tp = 1 on
    the same seed; each rank's step on the same batch must agree with it
    within the training bands (loss; each gradient, the shards'
    differences summed over the ranks). Then the window: per rank step
    ms, tokens/s, peak memory, the launches per step (K7p, K8, K9 once,
    K1, K5, K6 12 times, K3, K4 25 times, nothing else), the losses of
    steps 1-7, equal on the two ranks, rank 0's profiled window, and the
    all-reduces a step makes and what one of an activation costs."""
    import tempfile

    import torch.multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= TP_SIZE else "gloo"
    _log(f"tp={TP_SIZE} training: {torch.cuda.device_count()} card(s), "
         f"backend {backend}" + (" (both ranks share cuda:0; the "
                                 "all-reduces go through the host)"
                                 if backend == "gloo" else ""))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model, _, _, _, _, _, ids, pos, labels = _train_setup(
            dev, 2, seed=1, fused=True, padded=True)
        n_params = sum(p.numel() for p in model.parameters())
        ref_loss, ref_grads = _step_grads(model, ids, pos, labels)
        del model
        torch.save({"loss": ref_loss,
                    "grads": {n: g.cpu() for n, g in ref_grads.items()}},
                   f"{tmp}/ref.pt")
        del ref_grads
        torch.cuda.empty_cache()
        ctx = mp.start_processes(_tp_rank, args=(TP_SIZE, tmp, backend, card),
                                 nprocs=TP_SIZE, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TP_TIMEOUT_S
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"tp={TP_SIZE} ranks still running "
                                       f"after {TP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(TP_SIZE)]
    wall_s = time.perf_counter() - t0

    # parity: the loss on every rank, each gradient over the shards
    worst, worst_name = 0.0, ""
    names = ranks[0]["parity"]["grads"]
    for name in names:
        per_rank = [r["parity"]["grads"][name] for r in ranks]
        if per_rank[0][2]:               # sharded: the shards concatenated
            err = (sum(d for d, _, _ in per_rank)
                   / max(sum(q for _, q, _ in per_rank), 1e-60)) ** 0.5
        else:                            # whole on each rank
            err = max((d / max(q, 1e-60)) ** 0.5 for d, q, _ in per_rank)
        if not np.isfinite(err):
            raise AssertionError(f"tp={TP_SIZE}: {name} gradient not finite")
        if err > worst:
            worst, worst_name = err, name
    dloss = max(abs(r["parity"]["loss"] - ref_loss) for r in ranks)
    _log(f"tp={TP_SIZE} vs tp=1 on the card (b=2, fused head, vocab "
         f"{TP_VOCAB}): loss {ranks[0]['parity']['loss']:.6f} vs "
         f"{ref_loss:.6f} (band {TRAIN_LOSS_BAND}), worst gradient relative "
         f"L2 {worst:.3e} at {worst_name} (band {TRAIN_GRAD_BAND})")
    if dloss > TRAIN_LOSS_BAND or worst > TRAIN_GRAD_BAND:
        raise AssertionError(f"tp={TP_SIZE} disagrees with tp=1")

    want = _want_launches(True, False, "none", opt="adam")
    want.update(xent_fwd=0, xent_fwd_partials=1)
    b, s = TRAIN["batch"], TRAIN["seq"]
    # the cards the ranks' work is spread over: MFU is per card
    cards = TP_SIZE if backend == "nccl" else 1
    windows = []
    for r in ranks:
        w = r["window"]
        per_step = {k: v / TRAIN["timed"] for k, v in w["launches"].items()}
        windows.append(dict(
            {k: w[k] for k in ("card", "step_ms", "tokens_per_s",
                               "peak_mem_gb", "rank_params", "build_s")},
            rank=r["rank"], device=r["device"], backend=r["backend"],
            mfu=6 * n_params * b * s / (w["step_ms"] / 1e3)
            / (cards * BF16_FLOPS_PER_S),
            loss_step1=w["losses"][0], loss_last=w["losses"][-1],
            losses=w["losses"], launches_per_step=per_step,
            collectives=w["collectives"], profile=w["profile"]))
        vals = w["losses"]
        if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
            raise AssertionError(f"tp={TP_SIZE} rank {r['rank']}: loss not "
                                 f"finite and falling: {vals}")
        for k, n in want.items():
            if w["launches"][k] != n * TRAIN["timed"]:
                raise AssertionError(
                    f"tp={TP_SIZE} rank {r['rank']}: {k} launched "
                    f"{w['launches'][k]} times in {TRAIN['timed']} steps, "
                    f"want {n} per step")
    if any(r["window"]["losses"] != ranks[0]["window"]["losses"]
           for r in ranks):
        raise AssertionError(f"tp={TP_SIZE}: the ranks' losses differ: "
                             f"{[r['window']['losses'] for r in ranks]}")
    stats = {"tp": TP_SIZE, "backend": backend, "cards": cards,
             "vocab_size": TP_VOCAB,
             "n_params": n_params, "batch": b, "seq": s,
             "steps_timed": TRAIN["timed"], "phase_wall_s": wall_s,
             "parity": {"loss_diff": dloss, "worst_grad_rel_l2": worst,
                        "worst_grad": worst_name},
             "ranks": windows}
    _log("training tp=2: " + json.dumps(stats))
    return ranks[0]["window"]["launches"], stats


def _bn_rows(dev, shape, dtype, seed):
    """x and dy of a batch-norm shape (NCHW) as NHWC rows [N H W, C], the
    scale and bias in the main path's dtype (bf16 under O2, fp32 with an
    fp32 activation), fp32 running stats."""
    n, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n * h * w, c, generator=gen, device=dev) * 2.0
         + 0.5).to(dtype)
    dy = torch.randn(n * h * w, c, generator=gen, device=dev).to(dtype)
    wt = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype)
    b = torch.randn(c, generator=gen, device=dev).to(dtype)
    rm = torch.zeros(c, device=dev)
    rv = torch.ones(c, device=dev)
    return x, dy, wt, b, rm, rv


def _stat_err(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def _bn_check(dev, shape, dtype, fuse_relu, seed, one_launch=True):
    """K17 and K18 against their plain versions at one shape, in their
    one-launch forms (one rank) or their two-launch forms (a group's,
    the all-reduce between the stages): the stats and sums and the saved
    statistics and running stats within BN_STAT_TOL, y and dx by relative
    L2 within BN_L2_TOL, two runs of each launch the same bits. Returns
    the errors and the inputs."""
    from apex_tpu_torch.ops import batch_norm as bn
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    x, dy, wt, b, rm, rv = _bn_rows(dev, shape, dtype, seed)
    rm1, rv1, rm2, rv2 = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    if one_launch:
        y, mean, rstd, stats = bnc.fwd(x, wt, b, rm, rv, 1e-5, 0.1,
                                       fuse_relu)
        again = bnc.fwd(x, wt, b, rm1, rv1, 1e-5, 0.1, fuse_relu)
        repeat = all(_same_bits(g, o) for g, o in zip(
            (y, mean, rstd, stats, rm, rv), again + (rm1, rv1)))
        del again
    else:
        stats = bnc.fwd_stats(x)
        repeat = _same_bits(stats, bnc.fwd_stats(x))
        y, mean, rstd = bnc.fwd_apply(x, stats, wt, b, rm, rv, 1e-5, 0.1,
                                      True, fuse_relu)
    # y, the saved statistics and the running stats from the kernel's own
    # stats, which are held against the plain stats on their own
    ry, rmean, rrstd = bn.fwd_apply_reference(x, stats, wt, b, rm2, rv2,
                                              1e-5, 0.1, True, fuse_relu)
    errs = {"stats": _stat_err(stats, bn.fwd_stats_reference(x)),
            "mean_rstd_running": max(_stat_err(mean, rmean),
                                     _stat_err(rstd, rrstd),
                                     _stat_err(rm, rm2), _stat_err(rv, rv2)),
            "y_rel_l2": _rel_l2(y, ry)}
    del ry, y
    if one_launch:
        dx, sums = bnc.bwd(x, dy, mean, rstd, wt, b, stats, True, fuse_relu)
        dx2, sums2 = bnc.bwd(x, dy, mean, rstd, wt, b, stats, True,
                             fuse_relu)
        repeat &= _same_bits(dx, dx2) and _same_bits(sums, sums2)
        del dx2
    else:
        sums = bnc.bwd_stats(x, dy, mean, rstd, wt, b, fuse_relu)
        repeat &= _same_bits(sums, bnc.bwd_stats(x, dy, mean, rstd, wt, b,
                                                 fuse_relu))
        dx = bnc.bwd_apply(x, dy, mean, rstd, wt, b, sums, stats, True,
                           fuse_relu)
    errs["bwd_sums"] = _stat_err(sums, bn.bwd_stats_reference(
        x, dy, mean, rstd, wt, b, fuse_relu))
    rdx = bn.bwd_apply_reference(x, dy, mean, rstd, wt, b, sums, stats, True,
                                 fuse_relu)
    errs["dx_rel_l2"] = _rel_l2(dx, rdx)
    del rdx, dx
    bad = [k for k, v in errs.items()
           if v > (BN_L2_TOL[dtype] if k.endswith("l2") else BN_STAT_TOL)]
    if bad or not repeat:
        raise AssertionError(
            f"K17/K18 ({'one' if one_launch else 'two'}-launch form) at "
            f"{shape} {dtype}: {errs} (bands {BN_L2_TOL[dtype]}, "
            f"{BN_STAT_TOL}), repeatable {repeat}")
    return errs, (x, dy, wt, b, rm, rv, stats, mean, rstd, sums)


def _codes(*ts):
    from apex_tpu_torch.ops import _build

    return tuple(0 if t is None else _build.DTYPE_CODES[t.dtype] for t in ts)


def _bn_bounds(shape, size):
    """K17's and K18's least times at one shape (ms): the one-pass bound
    (K17 x read once and y written once, K18 x and dy read once and dx
    written once) and the two-pass floor (x, and dy, read once more, as a
    norm larger than L2 must be)."""
    n, c, h, w = shape
    elems = n * c * h * w
    return {"fwd": {"bytes": 2 * size * elems,
                    "bound_ms": _bound(2 * size * elems, 0)[0],
                    "floor_ms": _bound(3 * size * elems, 0)[0]},
            "bwd": {"bytes": 3 * size * elems,
                    "bound_ms": _bound(3 * size * elems, 0)[0],
                    "floor_ms": _bound(5 * size * elems, 0)[0]}}


def _bn_times(dev, flush, shape, dtype, inputs):
    """K17 and K18 at one shape in their one-launch forms, timed in turns
    around their library call (``F.batch_norm(training=True)`` on the
    channels_last view, cuDNN, and its backward through
    ``torch.autograd.grad`` on a graph built outside the timed region);
    each with its one-pass bound and two-pass floor (``_bn_bounds``).
    Each is also timed after a clean flush (``clean_l2_ms``): the standard
    flush leaves L2 full of dirty lines, whose write-back a launch pays as
    it streams."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    x, dy, wt, b, rm, rv, stats, mean, rstd, sums = inputs
    n, c, h, w = shape

    def k17():
        return bnc.fwd(x, wt, b, rm, rv, 1e-5, 0.1, False)

    def k18():
        return bnc.bwd(x, dy, mean, rstd, wt, b, stats, True, False)

    xc = x.view(n, h, w, c).permute(0, 3, 1, 2).detach().requires_grad_()
    wf = wt.float().requires_grad_()
    bf = b.float().requires_grad_()
    lrm, lrv = rm.clone(), rv.clone()
    libs = {"fwd": lambda: F.batch_norm(xc, lrm, lrv, wf, bf, training=True)}
    yc = libs["fwd"]()
    dyc = dy.view(n, h, w, c).permute(0, 3, 1, 2)
    libs["bwd"] = lambda: torch.autograd.grad(yc, (xc, wf, bf), dyc,
                                              retain_graph=True)
    out = {}
    bounds = _bn_bounds(shape, x.element_size())
    for name, fn in (("fwd", k17), ("bwd", k18)):
        t = _turns(fn, libs[name], flush, "batch_norm")
        t["clean_l2_ms"] = _time_ms(fn, flush, clean=True)
        t.update(bounds[name])
        t["floor_share"] = t["floor_ms"] / t["ms"]
        out[name] = t
    del yc
    return out


def _bn_kernel_resources(dev):
    """ptxas's registers and spills of each bf16 16-byte-vector kernel of
    csrc/batch_norm.cu and the blocks of 512 threads an SM holds of it
    (``batch_norm_cuda.resident``)."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    names = {"bn_fwd_stats": ("bn_stats_kernel", "Lb0E"),
             "bn_fwd_apply": ("bn_fwd_apply_kernel",),
             "bn_bwd_stats": ("bn_stats_kernel", "Lb1E"),
             "bn_bwd_apply": ("bn_bwd_apply_kernel",),
             "bn_fwd": ("bn_fwd_kernel",), "bn_bwd": ("bn_bwd_kernel",)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for entry, needles in names.items():
        found = _ptxas("batch_norm", *needles, "13__nv_bfloat16Li8E")
        regs = next(iter(found.values()), {})
        out[entry] = dict(regs, blocks_per_sm=bnc.resident(
            entry, torch.bfloat16, 8, dev) // sms)
    return out


def _bn_graph_capture(dev):
    """K17 and K18 in their one-launch (cooperative) forms captured into a
    CUDA graph on a side stream and replayed: whether the capture takes
    them, and the replay's outputs against the eager calls' bits."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    x, dy, wt, b, rm, rv = _bn_rows(dev, (8, 256, 28, 28), torch.bfloat16,
                                    5)
    rm0, rv0 = rm.clone(), rv.clone()
    eager_y, mean, rstd, stats = bnc.fwd(x, wt, b, rm, rv, 1e-5, 0.1, True)
    eager_dx, eager_sums = bnc.bwd(x, dy, mean, rstd, wt, b, stats, True,
                                   True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            bnc.fwd(x, wt, b, rm0.clone(), rv0.clone(), 1e-5, 0.1, True)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            grm, grv = rm0.clone(), rv0.clone()
            with torch.cuda.graph(graph, stream=side):
                gy, gmean, grstd, gstats = bnc.fwd(x, wt, b, grm, grv, 1e-5,
                                                   0.1, True)
                gdx, gsums = bnc.bwd(x, dy, gmean, grstd, wt, b, gstats,
                                     True, True)
        grm.copy_(rm0)
        grv.copy_(rv0)
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        torch.cuda.synchronize()
        return {"captured": False, "error": str(e)[:300]}
    same = all(_same_bits(g, e) for g, e in (
        (gy, eager_y), (gdx, eager_dx), (gsums, eager_sums), (grm, rm),
        (grv, rv)))
    if not same:
        raise AssertionError("K17/K18 replayed from a CUDA graph differ from "
                             "their eager calls")
    return {"captured": True, "replay_equals_eager": same}


def phase_batch_norm_kernels(dev, flush):
    """K17 and K18 in their one-launch forms (one rank: ResNet-50's and
    DCGAN's path) against their plain versions at ResNet-50's twelve
    batch-norm shapes at b = 256 in bf16 (``BN_STEP_SHAPES``; the
    64-channel ones with the fused ReLU) and one fp32 shape, their
    two-launch forms (a group's) at ``BN_MAIN_SHAPE`` and the fp32 shape,
    each timed in turns with cuDNN's ``F.batch_norm`` forward and backward;
    each shape's one-pass bound and two-pass floor, and the step's batch
    norm (the norms a shape holds x (K17 + K18), summed) against the
    floor's sum; the kernels' registers and resident blocks;
    whether a CUDA graph captures the one-launch forms. The rows report
    ``BN_MAIN_SHAPE`` and carry the others ``by_shape``."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    source = "apex_tpu_torch/csrc/batch_norm.cu"
    resources = _bn_kernel_resources(dev)
    _log("K17/K18 registers, spills, blocks an SM (bf16, 16-byte vectors): "
         + json.dumps(resources))
    by_shape, step = {}, {"this": 0.0, "floor": 0.0, "bound": 0.0,
                          "this_clean_l2": 0.0}
    main_inputs = None
    cases = [(s, torch.bfloat16, k) for s, k in BN_STEP_SHAPES] + [
        (BN_FP32_SHAPE, torch.float32, 0)]
    for shape, dtype, norms in cases:
        relu = shape[1] == 64
        errs, inputs = _bn_check(dev, shape, dtype, fuse_relu=relu,
                                 seed=sum(shape))
        times = _bn_times(dev, flush, shape, dtype, inputs)
        key = f"{list(shape)} {str(dtype).replace('torch.', '')}"
        entry = {"norms_a_step": norms, "errors": errs, **times}
        if shape in (BN_MAIN_SHAPE, BN_FP32_SHAPE):
            two_errs, two = _bn_check(dev, shape, dtype, fuse_relu=relu,
                                      seed=sum(shape), one_launch=False)
            x, dy, wt, b, rm, rv, stats, mean, rstd, sums = two

            def two17():
                st = bnc.fwd_stats(x)
                return bnc.fwd_apply(x, st, wt, b, rm, rv, 1e-5, 0.1, True,
                                     False)

            def two18():
                su = bnc.bwd_stats(x, dy, mean, rstd, wt, b, False)
                return bnc.bwd_apply(x, dy, mean, rstd, wt, b, su, stats,
                                     True, False)

            entry["two_launch"] = {"errors": two_errs,
                                   "fwd_ms": _time_ms(two17, flush),
                                   "bwd_ms": _time_ms(two18, flush)}
            del two
        if shape == BN_MAIN_SHAPE:
            main_inputs = (shape, dtype, inputs)
        else:
            del inputs
        if norms:
            for side, k in (("this", "ms"), ("floor", "floor_ms"),
                            ("bound", "bound_ms"),
                            ("this_clean_l2", "clean_l2_ms")):
                step[side] += norms * (times["fwd"][k] + times["bwd"][k])
        by_shape[key] = entry
        _log(f"K17/K18 {key}: " + json.dumps(entry))
        torch.cuda.empty_cache()
    # the target: 0.8 of the floor's sum, 17.0 ms
    step["target_ms"] = step["floor"] / 0.8
    step["target_met"] = step["this"] <= 17.0
    step["floor_share"] = step["floor"] / step["this"]
    below = [k for k, v in by_shape.items() if v["norms_a_step"] and min(
        v["fwd"]["floor_share"], v["bwd"]["floor_share"]) < 0.5]
    step["shapes_below_half_the_floor"] = below
    _log("K17/K18 a ResNet-50 step (b = 256, 53 norms), ms: "
         + json.dumps(step))
    capture = _bn_graph_capture(dev)
    _log("K17/K18 one-launch forms in a CUDA graph: " + json.dumps(capture))
    # plain versions' times at the main shape
    from apex_tpu_torch.ops import batch_norm as bn

    shape, dtype, inputs = main_inputs
    x, dy, wt, b, rm, rv, stats, mean, rstd, sums = inputs
    plain = {"fwd": _time_ms(lambda: bn.fwd_reference(
        x, wt, b, rm, rv, 1e-5, 0.1, False), flush, reps=5),
             "bwd": _time_ms(lambda: bn.bwd_reference(
                 x, dy, mean, rstd, wt, b, stats, True, False), flush,
                 reps=5)}
    del inputs, main_inputs, x, dy
    torch.cuda.empty_cache()
    main = f"{list(BN_MAIN_SHAPE)} bfloat16"
    rows = []
    for name, which, err_key, entry in (
            ("batch_norm_fwd", "fwd", "y_rel_l2", "bn_fwd"),
            ("batch_norm_bwd", "bwd", "dx_rel_l2", "bn_bwd")):
        m = by_shape[main]
        rows.append(dict(
            {k: m[which][k] for k in ("ms", "ms_turns", "library_ms",
                                      "ms_spread", "bound_ms", "floor_ms",
                                      "floor_share", "bytes")
             if k in m[which]},
            name=name, route="cuda", source=source,
            replaces="apex_tpu/parallel/sync_batchnorm.py:23",
            counterparts=["apex_tpu/parallel/sync_batchnorm.py:23 "
                          "sync_batch_norm" + (" (its autodiff)"
                                               if which == "bwd" else "")],
            shape=list(BN_MAIN_SHAPE), dtype="bfloat16", form="one launch",
            plain_ms=plain[which], bound_by="bytes",
            max_abs_err=m["errors"][err_key], band=BN_L2_TOL[torch.bfloat16],
            errors=m["errors"], parent_ms=m[which].get("parent_ms"),
            resources={k: v for k, v in resources.items()
                       if k.startswith(entry)},
            step_ms=step, graph_capture=capture,
            by_shape={k: {**v[which], "norms_a_step": v["norms_a_step"],
                          "errors": v["errors"],
                          **({"two_launch_ms": v["two_launch"][
                              f"{which}_ms"]} if "two_launch" in v else {})}
                      for k, v in by_shape.items()}))
        _log(f"{name}: " + json.dumps(rows[-1]))
    return rows


def _resnet_leaves(dev, seed=0):
    """ResNet-50's 161 parameters under O2: fp32 masters, their model
    copies (bf16, bn_init's two fp32) and seeded fp32 gradients."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet50

    model = resnet50(dtype=torch.bfloat16, device=dev, seed=seed)
    amp.initialize(model, opt_level="O2", verbosity=0)
    copies = {n: p.detach() for n, p in model.named_parameters()}
    masters = {n: p.float().clone() for n, p in copies.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev) * 1e-2
             for n, p in masters.items()}
    return masters, copies, grads


def phase_sgd_kernel(dev, flush):
    """K16 on ResNet-50's 161 leaves (25.6 M parameters): the O2 step's
    four-list form (fp32 gradient, master and buffer; the model copy),
    timed in turns with ``torch.optim.SGD(fused=True).step`` on fp32
    copies of the masters (momentum 0.9, weight decay 1e-4), against
    ``apply_plain`` over ``fused_sgd``'s update and the copy's cast; the
    bound is its bytes, 22 a parameter with a bf16 copy (g, p, buf read;
    p, buf, the copy written). Its bitwise check runs on real gradients
    in ``phase_resnet_paths_agree``."""
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.optimizers._base import apply_plain

    masters, copies, grads = _resnet_leaves(dev)
    names = list(masters)
    n = sum(p.numel() for p in masters.values())
    half = sum(p.numel() for p in copies.values()
               if p.dtype != torch.float32)
    nbytes = 20 * n + 2 * half + 4 * (n - half)
    tx = fused_sgd(learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
                   weight_decay=RESNET["weight_decay"])
    state = tx.init(masters)
    no = torch.tensor(False, device=dev)
    lists = ([grads[k] for k in names], [masters[k] for k in names],
             [state.momentum_buf[k] for k in names], [copies[k] for k in names])
    count_new = state.count + 1

    def k16():
        mt.sgd(*lists, state.count, count_new, RESNET["lr"],
               weight_decay=RESNET["weight_decay"],
               momentum=RESNET["momentum"], dampening=0.0, nesterov=False,
               skip=no)

    lib_p = [torch.nn.Parameter(masters[k].clone()) for k in names]
    for p, k in zip(lib_p, names):
        p.grad = grads[k]
    lib = torch.optim.SGD(lib_p, lr=RESNET["lr"], momentum=RESNET["momentum"],
                          weight_decay=RESNET["weight_decay"], fused=True)
    pm = {k: t.clone() for k, t in masters.items()}
    pc = {k: t.clone() for k, t in copies.items()}
    ps = tx.init(pm)

    def plain():
        apply_plain(tx.update, grads, ps, pm, no)
        for k in names:
            pc[k].copy_(pm[k].to(pc[k].dtype))

    spread = []
    t = _turns(k16, lib.step, flush, "multi_tensor", spread=spread,
               spin=MT_SPIN)
    plain_ms = _time_ms(plain, flush, reps=5)
    bound = _bound(nbytes, 0)
    row = dict(name="multi_tensor_sgd", route="cuda",
               source="apex_tpu_torch/csrc/multi_tensor.cu",
               replaces="apex_tpu/optimizers/fused_sgd.py:41",
               counterparts=["apex_tpu/optimizers/fused_sgd.py:41 update",
                             "apex_tpu/amp/amp_optimizer.py:119-134 skip "
                             "selects and master-to-model copy"],
               max_abs_err=0.0, leaves=len(names), elements=n,
               ms_spread=spread, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1], bytes=nbytes, **t)
    _log("K16: " + json.dumps(row))
    del lib_p, lib, masters, copies, grads, pm, pc
    torch.cuda.empty_cache()
    return row


def _resnet_sgd(plain=False):
    """The recipe's ``fused_sgd`` on ``make_lr_schedule`` (the fused step
    on K16), or with ``plain`` its update alone (``apply_plain``)."""
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.optimizers._base import GradientTransformation

    tx = fused_sgd(learning_rate=imagenet.make_lr_schedule(
        RESNET["lr"], RESNET["len_epoch"]), momentum=RESNET["momentum"],
        weight_decay=RESNET["weight_decay"])
    return GradientTransformation(tx.init, tx.update) if plain else tx


def _resnet_setup(dev, level, seed=0, group=None, plain=False):
    """ResNet-50 under amp ``level`` (the policy's compute dtype for its
    convolutions), ``amp.initialize`` with the recipe's SGD, its state and
    the ImageNet example's step over ``group``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.frontend import (Properties, build_policy,
                                             opt_levels)
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.models import resnet50

    dtype = build_policy(opt_levels[level](Properties())).compute_dtype
    model = resnet50(num_classes=RESNET["classes"], norm_process_group=group,
                     dtype=dtype, device=dev, seed=seed)
    model, opt = amp.initialize(model, _resnet_sgd(plain), opt_level=level,
                                verbosity=0)
    state = opt.init(dict(model.named_parameters()))
    step = imagenet.build_train_step(model, opt, group, dtype)
    return model, opt, state, step, dtype


def _resnet_batch(dev, batch, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(batch, 3, RESNET["image"], RESNET["image"],
                        generator=gen, device=dev)
    labels = torch.randint(0, RESNET["classes"], (batch,), generator=gen,
                           device=dev)
    return images, labels


def _resnet_want(model, level):
    """Launches a step: K17 and K18 once a batch norm each in their
    one-launch forms (one rank), the unscale's K12 once a group of
    (gradient dtype) leaves, K16 once a group of (model-copy dtype)
    leaves; nothing else."""
    from apex_tpu_torch.ops import multi_tensor_cuda as mt

    params = list(model.parameters())
    norms = sum(1 for m in model.modules()
                if type(m).__name__ == "SyncBatchNorm")
    by = {}
    for p in params:
        by[p.dtype] = by.get(p.dtype, 0) + 1

    def groups(counts, depth):
        return sum(-(-k // mt.capacity(depth)) for k in counts)

    want = dict.fromkeys(_training_counts(), 0)
    want.update(dict.fromkeys(("batch_norm_fwd_one", "batch_norm_bwd_one"),
                              norms))
    want["multi_tensor_scale"] = groups(by.values(), 2)
    want["multi_tensor_sgd"] = groups(
        by.values() if level == "O2" else [len(params)], 4)
    return want, norms


def _with_totals(launches):
    """The launches with K17's and K18's totals over both forms (one
    launch a norm on one rank, a stats and an apply launch a norm in a
    group)."""
    out = dict(launches)
    for d in ("fwd", "bwd"):
        out[f"batch_norm_{d}"] = sum(launches.get(f"batch_norm_{d}_{k}", 0)
                                     for k in ("one", "stats", "apply"))
    return out


@contextlib.contextmanager
def _bn_held(records, group=None, backend=None):
    """Each K17 and K18 launch that the block makes, in either form, is
    held against its plain version on the same inputs (the running stats
    cloned before K17 updates them; y and the saved statistics from the
    kernel's own stats, dx from its own sums, which are held against the
    plain ones on their own), one record a call in ``records``:
    the sums and the saved statistics by ``_stat_err``, y and dx by
    relative L2. With a ``group`` of ranks the all-reduced sums that
    reach the second stages are also held against the whole batch's:
    each rank's plain sums gathered and added in rank order (over the
    host under gloo)."""
    import torch.distributed as dist

    from apex_tpu_torch.ops import batch_norm as bn
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    kernel = {name: getattr(bnc, name) for name in (
        "fwd", "bwd", "fwd_stats", "fwd_apply", "bwd_stats", "bwd_apply")}

    def whole(local):
        t = local if backend == "nccl" else local.cpu()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return total.to(local.device)

    def note(stage, x2d, **errors):
        records.append({"stage": stage, "rows": x2d.shape[0],
                        "channels": x2d.shape[1], "dtype": x2d.dtype,
                        "errors": errors})

    def fwd(x2d, weight, bias, rm, rv, eps, momentum, fuse_relu):
        rm2 = None if rm is None else rm.clone()
        rv2 = None if rv is None else rv.clone()
        y, mean, rstd, stats = kernel["fwd"](x2d, weight, bias, rm, rv, eps,
                                             momentum, fuse_relu)
        ry, rmean, rrstd = bn.fwd_apply_reference(
            x2d, stats, weight, bias, rm2, rv2, eps, momentum, True,
            fuse_relu)
        errors = {"stats": _stat_err(stats, bn.fwd_stats_reference(x2d)),
                  "y_rel_l2": _rel_l2(y, ry),
                  "mean_rstd": max(_stat_err(mean, rmean),
                                   _stat_err(rstd, rrstd))}
        if rm is not None:
            errors["running"] = max(_stat_err(rm, rm2), _stat_err(rv, rv2))
        note("fwd", x2d, **errors)
        return y, mean, rstd, stats

    def bwd(x2d, dy2d, mean, rstd, weight, bias, stats, training,
            fuse_relu):
        dx, sums = kernel["bwd"](x2d, dy2d, mean, rstd, weight, bias, stats,
                                 training, fuse_relu)
        rsums = bn.bwd_stats_reference(x2d, dy2d, mean, rstd, weight, bias,
                                       fuse_relu)
        rdx = bn.bwd_apply_reference(x2d, dy2d, mean, rstd, weight, bias,
                                     sums, stats, training, fuse_relu)
        note("bwd", x2d, sums=_stat_err(sums, rsums),
             dx_rel_l2=_rel_l2(dx, rdx))
        return dx, sums

    def fwd_stats(x2d):
        out = kernel["fwd_stats"](x2d)
        note("fwd_stats", x2d,
             stats=_stat_err(out, bn.fwd_stats_reference(x2d)))
        return out

    def fwd_apply(x2d, stats, weight, bias, rm, rv, eps, momentum, training,
                  fuse_relu):
        rm2 = None if rm is None else rm.clone()
        rv2 = None if rv is None else rv.clone()
        y, mean, rstd = kernel["fwd_apply"](x2d, stats, weight, bias, rm, rv,
                                            eps, momentum, training,
                                            fuse_relu)
        ry, rmean, rrstd = bn.fwd_apply_reference(
            x2d, stats, weight, bias, rm2, rv2, eps, momentum, training,
            fuse_relu)
        errors = {"y_rel_l2": _rel_l2(y, ry),
                  "mean_rstd": max(_stat_err(mean, rmean),
                                   _stat_err(rstd, rrstd))}
        if rm is not None:
            errors["running"] = max(_stat_err(rm, rm2), _stat_err(rv, rv2))
        if group is not None and training:
            errors["synced_stats"] = _stat_err(
                stats, whole(bn.fwd_stats_reference(x2d)))
        note("fwd_apply", x2d, **errors)
        return y, mean, rstd

    def bwd_stats(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
        out = kernel["bwd_stats"](x2d, dy2d, mean, rstd, weight, bias,
                                  fuse_relu)
        note("bwd_stats", x2d, sums=_stat_err(out, bn.bwd_stats_reference(
            x2d, dy2d, mean, rstd, weight, bias, fuse_relu)))
        return out

    def bwd_apply(x2d, dy2d, mean, rstd, weight, bias, sums, stats, training,
                  fuse_relu):
        dx = kernel["bwd_apply"](x2d, dy2d, mean, rstd, weight, bias, sums,
                                 stats, training, fuse_relu)
        errors = {"dx_rel_l2": _rel_l2(dx, bn.bwd_apply_reference(
            x2d, dy2d, mean, rstd, weight, bias, sums, stats, training,
            fuse_relu))}
        if group is not None and training:
            errors["synced_sums"] = _stat_err(sums, whole(
                bn.bwd_stats_reference(x2d, dy2d, mean, rstd, weight, bias,
                                       fuse_relu)))
        note("bwd_apply", x2d, **errors)
        return dx

    # each wrapper counts its launches on the function its module name
    # binds, which is the stand-in here: carry the count across
    stand_ins = {"fwd": fwd, "bwd": bwd, "fwd_stats": fwd_stats,
                 "fwd_apply": fwd_apply, "bwd_stats": bwd_stats,
                 "bwd_apply": bwd_apply}
    with contextlib.ExitStack() as stack:
        for name, fn in stand_ins.items():
            fn.launches = kernel[name].launches
            stack.enter_context(mock.patch.object(bnc, name, fn))
        try:
            yield
        finally:
            for name, fn in stand_ins.items():
                kernel[name].launches = fn.launches


def _bn_held_summary(records, norms, bwd_norms=None):
    """The held calls of one step (``_bn_held``): the calls a form makes
    (a norm's forward is one ``fwd`` call on one rank, a ``fwd_stats`` and
    a ``fwd_apply`` call in a group; ``norms`` forwards and, where it
    differs, ``bwd_norms`` backwards, each in one form), the widths and
    dtypes seen, the worst of each error, and ``bad``, the calls past
    their band (relative L2 within ``BN_L2_TOL`` of the activation's dtype,
    the sums and statistics within ``BN_STAT_TOL``) or norms not held as
    many times as they should be."""
    calls, worst, bad = {}, {}, []
    for r in records:
        calls[r["stage"]] = calls.get(r["stage"], 0) + 1
        for key, err in r["errors"].items():
            worst[key] = max(worst.get(key, 0.0), err)
            band = (BN_L2_TOL[r["dtype"]] if key.endswith("rel_l2")
                    else BN_STAT_TOL)
            if not err <= band:
                bad.append(f"{r['stage']} [{r['rows']}, {r['channels']}] "
                           f"{key} {err} (band {band})")
    for d, n in (("fwd", norms), ("bwd", bwd_norms or norms)):
        one = calls.get(d, 0)
        stats, apply = calls.get(f"{d}_stats", 0), calls.get(f"{d}_apply", 0)
        if not ((one, stats, apply) == (n, 0, 0)
                or (one, stats, apply) == (0, n, n)):
            bad.append(f"{d}: held {one} times in one launch and {stats} + "
                       f"{apply} in two, want {n} in one form")
    return {"calls": calls,
            "channels": sorted({r["channels"] for r in records}),
            "dtypes": sorted({str(r["dtype"]).replace("torch.", "")
                              for r in records}),
            "worst": worst,
            "bands": {"rel_l2": {str(k).replace("torch.", ""): v
                                 for k, v in BN_L2_TOL.items()},
                      "stats": BN_STAT_TOL},
            "bad": bad}


def phase_resnet_training(dev, card, level):
    """ResNet-50 trained by the ImageNet example's step at b = 256, 224^2,
    1000 classes under amp ``level`` (R-O2: bf16 parameters over fp32
    masters, JAX's batch-norm predicate, K16 writing the bf16 copy; R-O1:
    fp32 parameters, bf16 convolutions, no masters), SyncBatchNorm on
    K17/K18 at world 1: 2 warm-up and 5 timed steps (host clock ending
    in ``synchronize``): step ms, images/s, MFU (3 x the forward FLOPs of
    the convolutions and fc x b over the step at 989 TFLOP/s), peak
    memory, the losses of steps 1-7 (finite, falling), the launches a
    step (``_resnet_want``); one step with every K17/K18 call held
    against its plain version (``_bn_held``: the 53 norms' widths, 64 to
    2048, on the step's own activations); then a profiled two-step
    window: busy share, device ms by kind, and K17's and K18's stages
    counted by name on the device (53 each a step)."""
    from apex_tpu_torch.models.resnet import conv_linear_flops

    b = RESNET["batch"]
    t0 = time.perf_counter()
    model, opt, state, step, dtype = _resnet_setup(dev, level)
    images, labels = _resnet_batch(dev, b, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    leaves = len(list(model.parameters()))
    flops = conv_linear_flops(model, RESNET["image"])
    _log(f"ResNet-50 ({level}) built in {time.perf_counter() - t0:.2f} s: "
         f"{n_params} parameters, {leaves} leaves, "
         f"{len(list(model.buffers()))} buffers, forward {flops / 1e9:.4f} "
         f"GFLOP an image")
    losses = []
    for _ in range(RESNET["warmup"]):
        state, metrics, _ = step(state, images, labels)
        losses.append(metrics[0])
    torch.cuda.synchronize()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RESNET["timed"]):
        state, metrics, overflow = step(state, images, labels)
        losses.append(metrics[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses]
    step_ms = wall / RESNET["timed"] * 1e3
    stats = {"card": card, "opt_level": level,
             "compute_dtype": str(dtype).replace("torch.", ""),
             "param_dtypes": sorted({str(p.dtype).replace("torch.", "")
                                     for p in model.parameters()}),
             "fp32_params": sorted(n for n, p in model.named_parameters()
                                   if p.dtype == torch.float32)[:4],
             "batch": b, "image": RESNET["image"],
             "steps_timed": RESNET["timed"], "step_ms": step_ms,
             "images_per_s": b / (step_ms / 1e3),
             "forward_gflop_per_image": flops / 1e9,
             "mfu": 3 * flops * b / (step_ms / 1e3) / BF16_FLOPS_PER_S,
             "n_params": n_params, "leaves": leaves,
             "peak_mem_gb": peak / 1e9, "loss_step1": vals[0],
             "loss_last": vals[-1], "losses": vals,
             "launches_per_step": {k: v / RESNET["timed"]
                                   for k, v in launches.items() if v}}
    _log(f"ResNet-50 {level}: " + json.dumps(stats))
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        raise AssertionError(f"ResNet-50 {level}: loss not finite and "
                             f"falling: {vals}")
    want, norms = _resnet_want(model, level)
    for k, per_step in want.items():
        if launches[k] != per_step * RESNET["timed"]:
            raise AssertionError(f"ResNet-50 {level}: {k} launched "
                                 f"{launches[k]} times in {RESNET['timed']}"
                                 f" steps, want {per_step} a step")
    # one more step, each of its K17/K18 calls held against the plain
    # version on the same activations
    records = []
    with _bn_held(records):
        state, _, _ = step(state, images, labels)
    held = _bn_held_summary(records, norms)
    del records
    stats["batch_norm_held"] = held
    _log(f"ResNet-50 {level}, each K17/K18 call of one step (b={b}) against "
         f"its plain version: " + json.dumps(held))
    if held["bad"]:
        raise AssertionError(f"ResNet-50 {level}: K17/K18 past their bands: "
                             f"{held['bad'][:8]}")

    if level == "O2":
        # the step with batch norm on its plain version, in turns with
        # the kernels' step: kernel (the window), plain, kernel
        turns = {}
        for path in ("plain", "kernel"):
            with (_plain_path(_resnet_plain_patches(bn_only=True))
                  if path == "plain" else contextlib.nullcontext()):
                state, _, _ = step(state, images, labels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics, _ = step(state, images, labels)
                torch.cuda.synchronize()
                turns[path] = (time.perf_counter() - t0) * 1e3
        stats["plain_batch_norm_step_ms"] = turns["plain"]
        stats["kernel_step_ms_after"] = turns["kernel"]
        _log(f"ResNet-50 O2 step, batch norm on K17/K18 (window mean, then "
             f"after) {step_ms:.2f}, {turns['kernel']:.2f} ms against its "
             f"plain version {turns['plain']:.2f} ms")

    def two_steps():
        nonlocal state
        for _ in range(2):
            state, _, _ = step(state, images, labels)

    profile = _profile(two_steps, ("conv", "batch_norm", "elementwise",
                                   "optimizer", "sgd", "matmul", "other"))
    stats["profile"] = profile
    if profile is not None:
        traced = profile["traced"]
        for k in ("batch_norm_fwd_one", "batch_norm_bwd_one"):
            if traced[k] != 2 * norms:
                raise AssertionError(f"ResNet-50 {level}: the device ran "
                                     f"{k} {traced[k]} times in two steps, "
                                     f"want {2 * norms}")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return _with_totals(launches), stats


def _resnet_plain_patches(bn_only=False):
    """K17 and K18 (both forms) and (unless ``bn_only``) K12 replaced by
    their plain versions, for a ResNet step's plain path on the card (the
    plain SGD comes from ``_resnet_sgd(plain=True)``)."""
    from apex_tpu_torch.ops import (batch_norm, batch_norm_cuda,
                                    multi_tensor, multi_tensor_cuda)

    k12 = [] if bn_only else [mock.patch.object(
        multi_tensor_cuda, "scale", multi_tensor.scale_reference)]
    return k12 + [mock.patch.object(batch_norm_cuda, "fwd",
                              batch_norm.fwd_reference),
            mock.patch.object(batch_norm_cuda, "bwd",
                              batch_norm.bwd_reference),
            mock.patch.object(batch_norm_cuda, "fwd_stats",
                              batch_norm.fwd_stats_reference),
            mock.patch.object(batch_norm_cuda, "fwd_apply",
                              batch_norm.fwd_apply_reference),
            mock.patch.object(batch_norm_cuda, "bwd_stats",
                              batch_norm.bwd_stats_reference),
            mock.patch.object(batch_norm_cuda, "bwd_apply",
                              batch_norm.bwd_apply_reference)]


# the input perturbation that sets a ResNet comparison's band: each image
# element moved by this relative amount (with normal noise) before the
# cast; in bf16 that re-rounds part of the input, in fp32 it is an
# fp32-level change. ResNet-50 at its flax init is chaotic: on the card
# (b = 8, 224^2) this moves the step's gradients by 3% in fp32 and by
# 130% in bf16, so in bf16 only the loss is compared this way, and the
# kernels are held call by call instead (``_bn_held``)
NUDGE = {torch.bfloat16: 2.0 ** -12, torch.float32: 1e-7}


def _nudged(images, dtype, seed=99):
    gen = torch.Generator(device=images.device).manual_seed(seed)
    return images * (1 + NUDGE[dtype] * torch.randn(
        images.shape, generator=gen, device=images.device))


def _distances(a, b):
    """(|loss diff|, the gradients' relative L2 over the model, the worst
    tensor's relative L2) of two (loss, grads) results."""
    (la, ga), (lb, gb) = a, b
    num = sum(((ga[k].float() - gb[k].float()) ** 2).sum() for k in gb)
    den = sum((gb[k].float() ** 2).sum() for k in gb)
    worst = max(_rel_l2(ga[k], gb[k]) for k in gb
                if gb[k].float().norm() > 0)
    return abs(la - lb), (num / den).sqrt().item(), worst


def _held(what, err, noise, floors):
    """Each distance of ``err`` (the loss's, then any relative L2s) within
    the larger of its floor and twice the kernel path's own move under
    ``NUDGE`` (``noise``); a relative-L2 band of 1 or more, which a zero
    or unrelated result would meet, is refused."""
    bands = [max(f, 2 * n) for f, n in zip(floors, noise)]
    _log(f"{what}: distances {err} (loss, model-wide gradient relative L2, "
         f"worst tensor), the nudged input's {noise}, bands {bands}")
    if any(b >= 1.0 for b in bands[1:]):
        raise AssertionError(f"{what}: a band of {bands[1:]} relative L2 "
                             f"holds nothing")
    if any(e > b for e, b in zip(err, bands)):
        raise AssertionError(f"{what}: outside the bands")
    return {"distances": err, "nudged": noise, "bands": bands}


def phase_resnet_paths_agree(dev):
    """ResNet-50 at full width (b = 8, 224^2) through the kernel path and
    the plain path (K17/K18 and K12 replaced by their plain versions), in
    O0 (fp32) and O2, one step each. The band of each distance is the
    larger of the training band and twice the distance the kernel path
    itself moves when the images move by ``NUDGE`` (measured here, the
    same run). O0 holds the loss and every gradient (the model's relative
    L2 and the worst tensor's); O2 the loss alone, because in bf16 the
    network at init amplifies any rounding past a band that could fail
    (its K17/K18 calls are held one by one in ``phase_resnet_training``
    instead). Then K16 against the plain SGD, bit for bit over 7 steps on
    the 161 real gradients of the kernel path (masters, buffers, the bf16
    copies, the count), step 4's loss scale infinite (its gradients
    overflow, both skip)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import LossScalerState
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.optimizers._base import apply_plain

    b = RESNET_AGREE["batch"]
    images, labels = _resnet_batch(dev, b, 4)
    floors = (TRAIN_LOSS_BAND, TRAIN_GRAD_BAND, TRAIN_GRAD_BAND)
    out = {}
    for level in ("O0", "O2"):
        model, opt, state, step, dtype = _resnet_setup(dev, level, seed=1)
        params = dict(model.named_parameters())

        def loss_fn(_p, x, y):
            return imagenet._loss_and_metrics(model(x, train=True), y)[0]

        grad_fn = amp.value_and_scaled_grad(loss_fn, opt)
        keep = {n: t.clone() for n, t in model.named_buffers()}

        def run(x):
            with torch.no_grad():
                for n, t in model.named_buffers():
                    t.copy_(keep[n])
            loss, grads, inf = grad_fn(params, state, x.to(dtype), labels)
            if inf:
                raise AssertionError(f"ResNet-50 {level}: overflow")
            return loss.item(), grads

        counts = _training_counts()
        for fn in counts.values():
            fn.launches = 0
        kernel = run(images)
        if counts["batch_norm_fwd_one"].launches != 53:
            raise AssertionError("the kernel path did not run K17 53 times")
        nudged = run(_nudged(images, dtype))
        with _plain_path(_resnet_plain_patches()):
            plain = run(images)
        judged = 3 if level == "O0" else 1
        out[level] = _held(
            f"ResNet-50 {level}, kernel vs plain path (b={b})",
            _distances(kernel, plain)[:judged],
            _distances(nudged, kernel)[:judged], floors[:judged])
        del model, opt, state, step, kernel, nudged, plain
        torch.cuda.empty_cache()

    # K16 against the plain SGD on the kernel path's real gradients
    model, opt, state, step, dtype = _resnet_setup(dev, "O2", seed=2)
    params = dict(model.named_parameters())

    def loss_fn(_p, x, y):
        return imagenet._loss_and_metrics(model(x, train=True), y)[0]

    grad_fn = amp.value_and_scaled_grad(loss_fn, opt)
    tx = opt.tx
    pm = {n: t.clone() for n, t in state.master_params.items()}
    ps = tx.init(pm)
    pc = {n: p.detach().clone() for n, p in params.items()}
    before = mt.sgd.launches
    checks = []
    for k in range(RESNET_AGREE["sgd_steps"]):
        use = state
        if k == RESNET_AGREE["overflow_step"]:
            use = state.replace(scalers=(LossScalerState(
                torch.tensor(float("inf"), device=dev),
                state.scalers[0].unskipped, state.scalers[0].overflow),))
        _, grads, found_inf = grad_fn(params, use, images.to(dtype), labels)
        tx.step(grads, state.inner, state.master_params, found_inf,
                model_params=params)
        apply_plain(tx.update, grads, ps, pm, found_inf)
        with torch.no_grad():
            for n in pc:
                pc[n].copy_(pm[n].to(pc[n].dtype))
        same = (all(_same_bits(state.master_params[n], pm[n]) for n in pm)
                and all(_same_bits(state.inner.momentum_buf[n],
                                   ps.momentum_buf[n]) for n in pm)
                and all(_same_bits(params[n].detach(), pc[n]) for n in pc)
                and state.inner.count.item() == ps.count.item())
        checks.append({"step": k + 1, "overflow": bool(found_inf.item()),
                       "count": state.inner.count.item(), "bitwise": same})
        if not same or bool(found_inf.item()) != (
                k == RESNET_AGREE["overflow_step"]):
            raise AssertionError(f"K16 against the plain SGD: {checks}")
    if mt.sgd.launches == before:
        raise AssertionError("K16 never launched")
    _log("K16 bit for bit against the plain SGD over "
         f"{RESNET_AGREE['sgd_steps']} steps: " + json.dumps(checks))
    del model, opt, state, step
    torch.cuda.empty_cache()
    out["k16_steps"] = checks
    return out


def _checksums(tensors):
    """Two int64 checksums a tensor of its bits (their sum and a sum
    weighted by position), stacked [n, 2]."""
    out = []
    for t in tensors:
        t = t.detach().contiguous().view(-1)
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32
                      ).to(torch.int64)
        idx = torch.arange(1, bits.numel() + 1, device=t.device,
                           dtype=torch.int64)
        out.append(torch.stack([bits.sum(), (bits * idx).sum()]))
    return torch.stack(out)


def _ddp_rank(rank, world, tmp, backend, card):
    """One rank of R-DDP (started with ``spawn``): ResNet-50 under O2 with
    SyncBatchNorm over the group, its rank's 32 of the 64 images, three
    steps of the example's step; after each, the checksums of the fp32
    masters, the bf16 parameters and the running stats compared over the
    ranks (all-reduce MAX and MIN). In step 1 every K17/K18 call is held
    (``_bn_held`` over the group) and the averaged gradients against the
    mean of the ranks' own (gathered). The records, the step times and
    the all-reduces a step go to ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.parallel import broadcast_params

    dev = _tp_device(rank, backend)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        model, opt, state, step, _ = _resnet_setup(
            dev, "O2", seed=RESNET_DDP["seed"], group=group)
        broadcast_params(model, group)
        b = RESNET_DDP["batch"]
        images, labels = _resnet_batch(dev, b * world, RESNET_DDP["seed"])
        images, labels = (images[rank * b:(rank + 1) * b],
                          labels[rank * b:(rank + 1) * b])
        averaged = []
        reduce = imagenet.allreduce_gradients
        all_reduce = dist.all_reduce

        def capture(grads, *args, **kwargs):
            # the ranks' own gradients gathered (over the host under
            # gloo) and averaged in rank order, against the reduction's
            own = torch.cat([g.float().reshape(-1) for g in grads.values()])
            out = reduce(grads, *args, **kwargs)
            t = own if backend == "nccl" else own.cpu()
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t, group=group)
            mean = parts[0].clone()
            for part in parts[1:]:
                mean += part
            mean = (mean / world).to(own.device)
            got = torch.cat([g.float().reshape(-1) for g in out.values()])
            averaged.append(_rel_l2(got, mean))
            return out

        calls = []

        def counted(t, *args, **kwargs):
            calls.append(t.numel() * t.element_size())
            return all_reduce(t, *args, **kwargs)

        records = []
        out = {"rank": rank, "backend": backend, "card": card, "steps": []}
        for i in range(RESNET_DDP["steps"]):
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(dist, "all_reduce", counted):
                if i == 0:
                    with mock.patch.object(imagenet, "allreduce_gradients",
                                           capture), \
                            _bn_held(records, group, backend):
                        state, metrics, overflow = step(state, images, labels)
                else:
                    state, metrics, overflow = step(state, images, labels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n_calls, n_bytes = len(calls), sum(calls)
            sums = _checksums(list(state.master_params.values())
                              + [p for p in model.parameters()]
                              + list(model.buffers()))
            sums = sums.cpu() if backend == "gloo" else sums
            hi, lo = sums.clone(), sums.clone()
            all_reduce(hi, op=dist.ReduceOp.MAX)
            all_reduce(lo, op=dist.ReduceOp.MIN)
            out["steps"].append({
                "step": i + 1, "ms": ms, "loss": metrics[0].item(),
                "overflow": bool(overflow.item()),
                "all_reduces": n_calls, "all_reduce_mb": n_bytes / 1e6,
                "ranks_bit_equal": bool(torch.equal(hi, lo)),
                "tensors_compared": sums.shape[0]})
        norms = sum(1 for m in model.modules()
                    if type(m).__name__ == "SyncBatchNorm")
        out["batch_norm_held"] = _bn_held_summary(records, norms)
        out["averaged_grads_rel_l2"] = averaged
        out["int8"] = _ddp_int8_steps(state, step, images, labels, model,
                                      group, backend)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _ddp_int8_steps(state, step, images, labels, model, group, backend):
    """R-DDP-int8, after R-DDP's steps in the same ranks: three more steps
    of the example's step with the gradients reduced by
    ``DistributedDataParallel(compress="int8")`` and its error-feedback
    residual (``init_ef_state``) threaded through, every K19/K20 call held
    (``_zero_held``); the masters, parameters and buffers compared over
    the ranks after each step; the launches read from zero."""
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.parallel import DistributedDataParallel

    ddp = DistributedDataParallel(process_group=group, compress="int8")
    ef = {}

    def compressed(grads, *_args, **_kwargs):
        if "state" not in ef:
            ef["state"] = ddp.init_ef_state(grads)
        red, ef["state"] = ddp.average_gradients(grads, ef["state"])
        return red

    counts = _zero_counts()
    for fn in counts.values():
        fn.launches = 0
    records, steps = [], []
    for i in range(RESNET_DDP["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(imagenet, "allreduce_gradients",
                               compressed), _zero_held(records):
            state, metrics, overflow = step(state, images, labels)
        torch.cuda.synchronize()
        steps.append({"step": i + 1,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "loss": metrics[0].item(),
                      "overflow": bool(overflow.item()),
                      "ranks_bit_equal": _ranks_equal(
                          list(state.master_params.values())
                          + list(model.parameters())
                          + list(model.buffers()), backend)})
    return {"steps": steps, "held": _zero_held_summary(records),
            "launches": _read_counts(counts),
            "residual": ef["state"].numel()}


def phase_resnet_ddp(dev, card):
    """R-DDP, BASELINE config 2 at world 2: two ranks started with
    ``spawn`` (NCCL with a card each where the machine has two cards,
    else gloo with both on cuda:0, whose all-reduces of CUDA tensors go
    through the host: a correctness phase, its step ms recorded and not
    judged), ResNet-50 under O2 with SyncBatchNorm over the group, b = 32
    a rank, three steps: every rank's fp32 masters, bf16 parameters and
    running stats bit-equal after each step; in step 1, on every rank,
    each K17/K18 call within its band of the plain version on the same
    inputs, the all-reduced sums within ``BN_STAT_TOL`` of the whole
    batch's, and the averaged gradients within ``DDP_GRAD_TOL`` of the
    mean of the ranks' own; rank 0's step-1 loss (averaged over the
    group) against one process that runs the 64 images with local batch
    norm, within the larger of the training band and twice what that
    loss moves under ``NUDGE``; step ms and all-reduces a step."""
    import tempfile

    import torch.multiprocessing as mp

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import imagenet

    world = RESNET_DDP["world"]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    _log(f"R-DDP: {torch.cuda.device_count()} card(s), backend {backend}"
         + (" (both ranks share cuda:0; the all-reduces go through the host)"
            if backend == "gloo" else ""))
    # the reference: one process, the 64 images, local batch norm
    model, opt, state, _, dtype = _resnet_setup(
        dev, "O2", seed=RESNET_DDP["seed"])
    images, labels = _resnet_batch(dev, RESNET_DDP["batch"] * world,
                                   RESNET_DDP["seed"])

    def loss_fn(_p, x, y):
        return imagenet._loss_and_metrics(model(x, train=True), y)[0]

    grad_fn = amp.value_and_scaled_grad(loss_fn, opt)
    ref = {}
    for what, x in (("images", images), ("nudged", _nudged(images, dtype))):
        loss, grads, _ = grad_fn(dict(model.named_parameters()), state,
                                 x.to(dtype), labels)
        ref[what] = loss.item()
        del grads
    noise = abs(ref["nudged"] - ref["images"])
    del model, opt, state, images, labels
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_ddp_rank, args=(world, tmp, backend, card),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RESNET_DDP["timeout_s"]
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"R-DDP ranks still running after "
                                       f"{RESNET_DDP['timeout_s']} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(world)]
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]
    dloss = abs(r0["steps"][0]["loss"] - ref["images"])
    band = max(TRAIN_LOSS_BAND, 2 * noise)
    stats = {"card": card, "backend": backend, "world": world,
             "batch_per_rank": RESNET_DDP["batch"], "phase_wall_s": wall_s,
             "reference_loss": ref["images"], "loss_diff": dloss,
             "nudged_loss_move": noise, "loss_band": band,
             "ranks": [{"rank": r["rank"], "steps": r["steps"],
                        "batch_norm_held": r["batch_norm_held"],
                        "averaged_grads_rel_l2": r["averaged_grads_rel_l2"]}
                       for r in ranks]}
    _log("R-DDP: " + json.dumps(stats))
    for r in ranks:
        for s in r["steps"]:
            if not s["ranks_bit_equal"] or s["overflow"]:
                raise AssertionError(f"R-DDP rank {r['rank']} step "
                                     f"{s['step']}: {s}")
        if r["batch_norm_held"]["bad"]:
            raise AssertionError(f"R-DDP rank {r['rank']}: K17/K18 past "
                                 f"their bands: "
                                 f"{r['batch_norm_held']['bad'][:8]}")
        if not (len(r["averaged_grads_rel_l2"]) == 1
                and r["averaged_grads_rel_l2"][0] <= DDP_GRAD_TOL):
            raise AssertionError(f"R-DDP rank {r['rank']}: the averaged "
                                 f"gradients against the ranks' mean: "
                                 f"{r['averaged_grads_rel_l2']}")
    if dloss > band:
        raise AssertionError(f"R-DDP against one process on 64 images: "
                             f"loss {dloss} (band {band})")
    stats["int8"] = [{k: v for k, v in r["int8"].items() if k != "held"}
                     for r in ranks]
    stats["int8_held"] = [r["int8"]["held"]["by_kernel"] for r in ranks]
    _log("R-DDP-int8: " + json.dumps({"int8": stats["int8"],
                                      "held": stats["int8_held"]}))
    for r in ranks:
        q = r["int8"]
        if q["held"]["bad"] or any(not s["ranks_bit_equal"] or s["overflow"]
                                   for s in q["steps"]):
            raise AssertionError(f"R-DDP-int8 rank {r['rank']}: {q}")
        n = RESNET_DDP["steps"]
        if (q["launches"]["collectives_quantize"],
                q["launches"]["collectives_dequantize_sum"]) != (n, n):
            raise AssertionError(f"R-DDP-int8 launches: {q['launches']}")
    return stats


# ------------------------------------------------------ the scale-out slice
# BERT-large (BERT_LARGE, window A's recipe) at data-parallel world 2 on
# DistributedFusedLAMB (ZeRO-2): each rank 8 of window A's 16 sequences,
# three steps with the codec off, then three from the same weights with
# int8 and error feedback; NCCL with a card a rank, else gloo with both
# ranks on cuda:0 (the collectives then go through the host: their step
# times are for correctness only)
ZERO_BERT = dict(world=2, batch=8, steps=3, lr=1e-4, timeout_s=600)
# GPT-2-small (the fused head) at world 2, b = 4 a rank, on
# DistributedFusedAdam against allreduce_gradients (mean) + FusedAdam
ZERO_GPT = dict(batch=4, steps=3, lr=1e-4)
# world 4 as (inner, outer) = (2, 2): GPT-2-small's width at 2 layers, b =
# 2 a rank; the hierarchical reduction within HIER_TOL (relative L2) of the
# flat one
HIER = dict(world=4, inner=2, outer=2, layers=2, batch=2, timeout_s=300)
HIER_TOL = 1e-5
# LARC(FusedSGD) on ResNet-50 R-O2 at world 1 (b = 64 for the smoke's time):
# trust 0.02, clip mode at the recipe's lr, the recipe's decay applied by
# LARC and the inner SGD's set to 0, as the LARC class does
LARC_WINDOW = dict(batch=64, steps=3, trust=0.02, seed=4)
# K22 (and the LARC transform's K13 norms) against their plain versions:
# sums in another order (the card tests' MT_LAMB_TOL)
ZERO_TOL = MT_LAMB_TOL
# the kinds of Z-BERT's profiled step
ZERO_KINDS = ("attention_fwd", "attention_bwd", "softmax", "layer_norm",
              "matmul", "optimizer", "codec", "memcpy", "other")
# the codec on against off: after step k (k > 1) the int8 run's loss is
# within this share of the codec-off run's move since step 1 (measured at
# most 3.7e-3 of it on the H100); a route that dropped the update would be
# at 1
CODEC_MOVE_SHARE = 0.05
# Z-BERT's codec-off step 1 against the unsharded FusedLAMB step on the
# same 16 sequences: the relative L2 of the two parameter moves, within
# ZERO_MOVE_BAND times the unsharded step's own move when its learning
# rate changes by one part in 2^21 (the size of the trust ratio's
# differences from norms summed in another order); such a band of
# ZERO_BAND_CAP or more could not tell a wrong update, and fails
ZERO_LR_NUDGE = 2.0 ** -21
ZERO_MOVE_BAND = 10.0
ZERO_BAND_CAP = 1e-2


def _zero_sizes(dev):
    """BERT-large's parameter sizes (the model of window A)."""
    from apex_tpu_torch.transformer.testing import BertModel

    model = BertModel(_bert_cfg("A"), device=dev, seed=0)
    sizes = [p.numel() for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return sizes


# the codec's blocks besides its default 128 that the kernels are held at
# (JAX's quantize_blocks takes any block)
CODEC_BLOCKS = (32, 64, 256)


def _codec_blocks(x, res, flush):
    """K19 and K20 at ``CODEC_BLOCKS`` on the same rows (the reduce-
    scatter's ``[2, P / 2]`` of BERT-large), bit for bit against their
    plain versions (the sum, and the gather), each timed."""
    from apex_tpu_torch.ops import collectives as codec
    from apex_tpu_torch.ops import collectives_cuda as cc

    shard = x.shape[1]
    out = {}
    for block in CODEC_BLOCKS:
        got = cc.quantize(x, res, block=block)
        same = all(_same_bits(a, b) for a, b in zip(
            got, codec.quantize_reference(x, res, block=block)))
        q, scales = got[0], got[1]
        del got
        summed = cc.dequantize_sum(q, scales, shard)
        same_k20 = _same_bits(summed, codec.dequantize_sum_reference(
            q, scales, shard))
        del summed
        gathered = cc.dequantize_sum(q, scales, shard, gather=True)
        same_k20 &= _same_bits(gathered, codec.dequantize_sum_reference(
            q, scales, shard, gather=True))
        del gathered
        if not (same and same_k20):
            raise AssertionError(f"K19/K20 at block {block}: not their "
                                 f"plain versions' bits ({same}, "
                                 f"{same_k20})")
        nb = q.shape[1]
        out[block] = {
            "quantize": {"bitwise": same, "ms": _time_ms(
                lambda: cc.quantize(x, res, block=block), flush),
                "bound_ms": _bound(13 * x.numel() + 2 * 2 * nb, 0)[0]},
            "dequantize_sum": {"bitwise": same_k20, "ms": _time_ms(
                lambda: cc.dequantize_sum(q, scales, shard), flush),
                "bound_ms": _bound(2 * nb * block + 2 * 2 * nb
                                   + 4 * shard, 0)[0]}}
        _log(f"K19/K20 at block {block}: " + json.dumps(out[block]))
        del q, scales
    return out


def phase_scale_out_kernels(dev, flush):
    """K19-K22 at the scale-out slice's shapes, each against its plain
    version on the same inputs: K19 (the gradient hop's quantize: BERT-
    large's padded flat gradient as rows [2, P / 2] with the residual)
    and K20 (dequantize and sum of two ranks' payloads over a shard) bit
    for bit; K21 (the ZeRO Adam update on GPT-2-small's shard at world 2)
    bit for bit, with ``torch.optim.Adam(fused=True).step`` over one fp32
    tensor of the shard's size in turns as its library call; K22 (both
    stages on BERT-large's shard 0 of 2, its real segments) within
    ``ZERO_TOL``. Bounds by bytes: K19 13 an element (x, residual read;
    q, residual written; a bf16 scale a block), K20 W + 4 an output plus
    the scales, K21 32 (g, master, m, v read; master, m, v, u written),
    K22 44 (stage 1 28, stage 2 16)."""
    from apex_tpu_torch.ops import collectives as codec
    from apex_tpu_torch.ops import collectives_cuda as cc
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.ops import zero as zops
    from apex_tpu_torch.optimizers._fused import (ShardLayout,
                                                  zero_padded_total)

    rows = []
    sizes = _zero_sizes(dev)
    P = zero_padded_total(sum(sizes), 2)
    shard = P // 2
    gen = torch.Generator(device=dev).manual_seed(18)
    x = (torch.randn(2, shard, generator=gen, device=dev) * 1e-3)
    res = torch.randn(2, shard, generator=gen, device=dev) * 1e-6
    src = "apex_tpu_torch/csrc/collectives.cu"

    got = cc.quantize(x, res)
    want = codec.quantize_reference(x, res)
    same = all(_same_bits(a, b) for a, b in zip(got, want))
    if not same:
        raise AssertionError("K19 at BERT-large's flat size: not its plain "
                             "version's bits")
    q, scales = got[0], got[1]
    del want
    spread = []
    ms = _time_ms(lambda: cc.quantize(x, res), flush, spread=spread)
    plain_ms = _time_ms(lambda: codec.quantize_reference(x, res), flush,
                        reps=5)
    nb = q.shape[1]
    nbytes = 13 * P + 2 * 2 * nb
    bound = _bound(nbytes, 0)
    rows.append(dict(name="collectives_quantize", route="cuda", source=src,
                     replaces="apex_tpu/parallel/collectives.py:269",
                     counterparts=["apex_tpu/parallel/collectives.py:269 "
                                   "quantize_blocks", ":311 _compensate",
                                   ":372-382 the reduce-scatter rows"],
                     shape=[2, shard], max_abs_err=0.0, bitwise=same,
                     ms=ms, ms_spread=spread, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                     bytes=nbytes))
    _log("K19: " + json.dumps(rows[-1]))

    got = cc.dequantize_sum(q, scales, shard)
    same = _same_bits(got, codec.dequantize_sum_reference(q, scales, shard))
    gathered = cc.dequantize_sum(q, scales, shard, gather=True)
    same &= _same_bits(gathered, codec.dequantize_sum_reference(
        q, scales, shard, gather=True))
    if not same:
        raise AssertionError("K20: not its plain version's bits")
    del gathered
    spread = []
    ms = _time_ms(lambda: cc.dequantize_sum(q, scales, shard), flush,
                  spread=spread)
    plain_ms = _time_ms(lambda: codec.dequantize_sum_reference(
        q, scales, shard), flush, reps=5)
    nbytes = 2 * nb * 128 + 2 * 2 * nb + 4 * shard
    bound = _bound(nbytes, 0)
    rows.append(dict(name="collectives_dequantize_sum", route="cuda",
                     source=src,
                     replaces="apex_tpu/parallel/collectives.py:384",
                     counterparts=["apex_tpu/parallel/collectives.py:354-360 "
                                   "(gathered, summed)", ":384-387 (after "
                                   "all_to_all)", ":400-403 and :304 "
                                   "dequantize_blocks (gathered)"],
                     shape=[2, nb, 128], max_abs_err=0.0, bitwise=same,
                     ms=ms, ms_spread=spread, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                     bytes=nbytes))
    _log("K20: " + json.dumps(rows[-1]))
    del q, scales, got
    by_block = _codec_blocks(x, res, flush)
    rows[-2]["by_block"] = {b: v["quantize"] for b, v in by_block.items()}
    rows[-1]["by_block"] = {b: v["dequantize_sum"]
                            for b, v in by_block.items()}
    del x, res
    torch.cuda.empty_cache()

    # K21 on GPT-2-small's shard at world 2
    n = zero_padded_total(sum(p.numel() for p in _gpt2_leaves(dev).values()),
                          2) // 2
    g = torch.randn(n, generator=gen, device=dev) * 1e-3
    master = torch.randn(n, generator=gen, device=dev) * 0.02
    m = torch.randn(n, generator=gen, device=dev) * 1e-4
    v = torch.rand(n, generator=gen, device=dev) * 1e-7
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    new = count + 1
    bc1 = 1.0 - torch.pow(0.9, new.float())
    bc2 = 1.0 - torch.pow(0.999, new.float())
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              adam_w_mode=False, bias_correction=True)
    a = [t.clone() for t in (master, m, v, count)]
    b = [t.clone() for t in (master, m, v, count)]
    u = mt.zero_adam(g, *a, new, bc1, bc2, 1e-4, **kw)
    ur = zops.adam_reference(g, *b, new, bc1, bc2, 1e-4, **kw)
    same = _same_bits(u, ur) and all(_same_bits(s, t) for s, t in zip(a, b))
    if not same:
        raise AssertionError("K21: not its plain version's bits")
    lib_p = torch.nn.Parameter(master.clone())
    lib_p.grad = g.clone()
    lib_opt = torch.optim.Adam([lib_p], lr=1e-4, fused=True)
    src = "apex_tpu_torch/csrc/multi_tensor.cu"
    spread = []
    t = _turns(lambda: mt.zero_adam(g, *a, new, bc1, bc2, 1e-4, **kw),
               lib_opt.step, flush, src, spread=spread)
    plain_ms = _time_ms(lambda: zops.adam_reference(
        g, *b, new, bc1, bc2, 1e-4, **kw), flush, reps=5)
    bound = _bound(32 * n, 0)
    rows.append(dict(name="multi_tensor_zero_adam", route="cuda", source=src,
                     replaces="apex_tpu/contrib/optimizers/"
                              "distributed_fused_adam.py:101",
                     counterparts=["apex_tpu/contrib/optimizers/"
                                   "distributed_fused_adam.py:101-126",
                                   "apex_tpu/optimizers/fused_adam.py:41 "
                                   "_adam_flat"],
                     elements=n, max_abs_err=0.0, bitwise=same,
                     ms_spread=spread, plain_ms=plain_ms, bound_ms=bound[0],
                     bound_by=bound[1], bytes=32 * n, **t))
    _log("K21: " + json.dumps(rows[-1]))
    del g, master, m, v, a, b, u, ur, lib_p, lib_opt
    torch.cuda.empty_cache()

    # K22 on BERT-large's shard 0 of 2
    layout = ShardLayout(sizes, 2, 0)
    n = layout.shard
    g = torch.randn(n, generator=gen, device=dev) * 1e-4
    master = torch.randn(n, generator=gen, device=dev) * 0.02
    m = torch.randn(n, generator=gen, device=dev) * 1e-5
    v = torch.rand(n, generator=gen, device=dev) * 1e-9
    gsq = torch.sum(g * g) * 2.0
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w_mode=True, bias_correction=True,
              max_grad_norm=1.0, global_sq=gsq)

    def k22(state):
        uu, sums = mt.zero_lamb_stage1(g, state[0], state[1], state[2],
                                       layout, state[3], new, bc1, bc2, **kw)
        return mt.zero_lamb_stage2(uu, state[0], sums, layout, 1e-4,
                                   trust=True), sums

    def plain(state):
        uu, sums = zops.lamb_stage1_reference(
            g, state[0], state[1], state[2], layout, state[3], new, bc1, bc2,
            **kw)
        return zops.lamb_stage2_reference(uu, state[0], sums, layout, 1e-4,
                                          trust=True), sums

    a = [t.clone() for t in (master, m, v, count)]
    b = [t.clone() for t in (master, m, v, count)]
    (u, sums), (ur, sr) = k22(a), plain(b)
    errs = {"update_rel_l2": _rel_l2(u, ur),
            "sums": _rel_err(sums, sr),
            "master_rel_l2": _rel_l2(a[0] - master, b[0] - master),
            "moments_bitwise": _same_bits(a[1], b[1]) and _same_bits(
                a[2], b[2])}
    again = [t.clone() for t in (master, m, v, count)]
    repeat = _same_bits(k22(again)[0], u)
    if max(errs["update_rel_l2"], errs["sums"],
           errs["master_rel_l2"]) > ZERO_TOL or not repeat:
        raise AssertionError(f"K22: {errs} (band {ZERO_TOL}), repeatable "
                             f"{repeat}")
    spread = []
    turns = [_time_ms(lambda: k22(a), flush, spread=spread),
             _time_ms(lambda: k22(a), flush)]
    plain_ms = _time_ms(lambda: plain(b), flush, reps=3)
    bound = _bound(44 * n, 0)
    rows.append(dict(name="multi_tensor_zero_lamb", route="cuda", source=src,
                     replaces="apex_tpu/contrib/optimizers/"
                              "distributed_fused_lamb.py:117",
                     counterparts=["apex_tpu/contrib/optimizers/"
                                   "distributed_fused_lamb.py:117-149"],
                     elements=n, segments=layout.nseg, pieces=layout.count,
                     max_abs_err=max(errs["update_rel_l2"], errs["sums"]),
                     errors=errs, band=ZERO_TOL, bitwise_repeatable=repeat,
                     ms=statistics.mean(turns), ms_turns=turns,
                     ms_spread=spread, plain_ms=plain_ms, library_ms=None,
                     bound_ms=bound[0], bound_by=bound[1], bytes=44 * n))
    _log("K22: " + json.dumps(rows[-1]))
    del g, master, m, v, a, b, again, u, ur
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _zero_held(records):
    """Each K19, K20, K21 and K22 call that the block launches is held
    against its plain version on the same inputs (the tensors a kernel
    writes in place cloned before it): K19, K20 and K21 bit for bit, K22
    by relative L2 within ``ZERO_TOL``; one record a call in ``records``
    (kernel, elements, error, bitwise)."""
    from apex_tpu_torch.ops import collectives as codec
    from apex_tpu_torch.ops import collectives_cuda as cc
    from apex_tpu_torch.ops import multi_tensor_cuda as mt
    from apex_tpu_torch.ops import zero as zops

    kernel = {"quantize": cc.quantize, "dequantize_sum": cc.dequantize_sum,
              "zero_adam": mt.zero_adam,
              "zero_lamb_stage1": mt.zero_lamb_stage1,
              "zero_lamb_stage2": mt.zero_lamb_stage2}

    def note(name, n, err, bitwise):
        records.append({"kernel": name, "elements": int(n), "err": err,
                        "bitwise": bool(bitwise)})

    def quantize(x, residual=None, *, block=128):
        got = kernel["quantize"](x, residual, block=block)
        want = codec.quantize_reference(x, residual, block=block)
        same = all((a is None and b is None) or _same_bits(a, b)
                   for a, b in zip(got, want))
        note("K19", x.numel(), 0.0 if same else float("inf"), same)
        return got

    def dequantize_sum(q, scales, n, *, gather=False, divisor=None):
        got = kernel["dequantize_sum"](q, scales, n, gather=gather,
                                       divisor=divisor)
        same = _same_bits(got, codec.dequantize_sum_reference(
            q, scales, n, gather=gather, divisor=divisor))
        note("K20", got.numel(), 0.0 if same else float("inf"), same)
        return got

    def zero_adam(g, master, m, v, count, count_new, bc1, bc2, lr, **kw):
        ref = [t.clone() for t in (master, m, v, count)]
        u = kernel["zero_adam"](g, master, m, v, count, count_new, bc1, bc2,
                                lr, **kw)
        ur = zops.adam_reference(g, *ref, count_new, bc1, bc2, lr, **kw)
        same = _same_bits(u, ur) and all(
            _same_bits(a, b) for a, b in zip((master, m, v, count), ref))
        note("K21", g.numel(), 0.0 if same else float("inf"), same)
        return u

    def zero_lamb_stage1(g, master, m, v, layout, count, count_new, bc1,
                         bc2, **kw):
        ref = [t.clone() for t in (m, v, count)]
        u, sums = kernel["zero_lamb_stage1"](g, master, m, v, layout, count,
                                             count_new, bc1, bc2, **kw)
        ur, sr = zops.lamb_stage1_reference(g, master, ref[0], ref[1],
                                            layout, ref[2], count_new, bc1,
                                            bc2, **kw)
        err = max(_rel_l2(u, ur), _rel_err(sums, sr), _rel_l2(m, ref[0]),
                  _rel_l2(v, ref[1]))
        note("K22 stage 1", g.numel(), err,
             _same_bits(u, ur) and _same_bits(m, ref[0]))
        return u, sums

    def zero_lamb_stage2(u, master, sums, layout, lr, **kw):
        uc, mc = u.clone(), master.clone()
        out = kernel["zero_lamb_stage2"](u, master, sums, layout, lr, **kw)
        zops.lamb_stage2_reference(uc, mc, sums, layout, lr, **kw)
        err = max(_rel_l2(out, uc), _rel_l2(master - mc, uc)
                  if kw.get("skip") is None else 0.0)
        note("K22 stage 2", u.numel(), err, _same_bits(out, uc))
        return out

    stand_ins = {"quantize": (cc, quantize),
                 "dequantize_sum": (cc, dequantize_sum),
                 "zero_adam": (mt, zero_adam),
                 "zero_lamb_stage1": (mt, zero_lamb_stage1),
                 "zero_lamb_stage2": (mt, zero_lamb_stage2)}
    with contextlib.ExitStack() as stack:
        for name, (mod, fn) in stand_ins.items():
            fn.launches = kernel[name].launches
            stack.enter_context(mock.patch.object(mod, name, fn))
        try:
            yield
        finally:
            for name, (_, fn) in stand_ins.items():
                kernel[name].launches = fn.launches


def _zero_held_summary(records):
    """The held calls: a count and the worst error a kernel, and the calls
    past their band (K19-K21 not bit for bit, K22 past ``ZERO_TOL``)."""
    out, bad = {}, []
    for r in records:
        k = out.setdefault(r["kernel"], {"calls": 0, "worst": 0.0,
                                         "all_bitwise": True})
        k["calls"] += 1
        k["worst"] = max(k["worst"], r["err"])
        k["all_bitwise"] &= r["bitwise"]
        if (r["kernel"].startswith("K22") and r["err"] > ZERO_TOL) or (
                not r["kernel"].startswith("K22") and not r["bitwise"]):
            bad.append(r)
    return {"by_kernel": out, "bad": bad}


def _zero_counts():
    """The scale-out kernels' wrappers by row name."""
    counts = _training_counts()
    return {k: counts[k] for k in ("collectives_quantize",
                                   "collectives_dequantize_sum",
                                   "multi_tensor_zero_adam",
                                   "multi_tensor_zero_lamb_stage1",
                                   "multi_tensor_zero_lamb_stage2",
                                   "multi_tensor_l2norm",
                                   "multi_tensor_scale",
                                   "multi_tensor_adam")}


def _read_counts(counts):
    out = {k: fn.launches for k, fn in counts.items()}
    out["multi_tensor_zero_lamb"] = (out.pop("multi_tensor_zero_lamb_stage1")
                                     + out.pop("multi_tensor_zero_lamb_stage2"))
    return out


def _ranks_equal(tensors, backend):
    """Whether every rank holds the same bits (``_checksums``, all-reduced
    MAX against MIN; over the host under gloo)."""
    import torch.distributed as dist

    sums = _checksums(tensors)
    sums = sums.cpu() if backend == "gloo" else sums
    hi, lo = sums.clone(), sums.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


@contextlib.contextmanager
def _collective_clock(calls):
    """Each torch.distributed collective the block calls, timed on the
    host (the stream synchronized before and after): ``(name, bytes,
    ms)`` appended to ``calls``."""
    import torch.distributed as dist

    names = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "all_to_all_single")
    real = {n: getattr(dist, n) for n in names}

    def timed(name):
        def run(out, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[name](out, *args, **kwargs)
            torch.cuda.synchronize()
            calls.append((name, out.numel() * out.element_size(),
                          (time.perf_counter() - t0) * 1e3))
            return res
        return run

    with contextlib.ExitStack() as stack:
        for n in names:
            stack.enter_context(mock.patch.object(dist, n, timed(n)))
        yield


def _bits_sig(t):
    """A tensor's bits summed (int64) and its nonzero count."""
    t = t.contiguous()
    return [int(t.view(torch.int32).sum(dtype=torch.int64).item()),
            int(torch.count_nonzero(t).item())]


@contextlib.contextmanager
def _residuals_seen(seen):
    """Each quantize call of the collectives layer that carries a
    residual, in order: ``(residual in, new residual)`` as ``_bits_sig``
    pairs appended to ``seen``."""
    from apex_tpu_torch.ops import collectives as codec

    real = codec.quantize

    def quantize(x, residual=None, *, block=128):
        out = real(x, residual, block=block)
        if residual is not None:
            seen.append((_bits_sig(residual), _bits_sig(out[2])))
        return out

    with mock.patch.object(codec, "quantize", quantize):
        yield


def _residuals_carried(seen):
    """Whether each int8 step's K19 calls read the residuals that the
    step before wrote (the gradient hop's, then the update hop's), the
    first step's zeros, and every written residual nonzero."""
    hops = 2
    if len(seen) < 2 * hops:
        return False
    first = all(r_in[1] == 0 for r_in, _ in seen[:hops])
    written = all(r_out[1] > 0 for _, r_out in seen)
    carried = all(seen[i + hops][0] == seen[i][1]
                  for i in range(len(seen) - hops))
    return first and written and carried


def _moves_rel_l2(a, b):
    """sqrt(sum ||a_i - b_i||^2 / sum ||b_i||^2) over lists of tensors."""
    num = sum(torch.sum((x.double() - y.double()) ** 2) for x, y in zip(a, b))
    den = sum(torch.sum(y.double() ** 2) for y in b)
    return (torch.sqrt(num) / torch.sqrt(den).clamp(min=1e-300)).item()


def _unsharded_moves(model, params, init, batch, group, dev):
    """Window A's unsharded step from the initial weights on the same 16
    sequences (each rank its 8): ``allreduce_gradients`` (mean) then
    ``fused_lamb`` (K13, K15) with window A's recipe, driven by
    ``make_one_step``; each parameter's move after one step, once at
    Z-BERT's learning rate and once with it nudged by ``ZERO_LR_NUDGE``."""
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.amp import GradScaler

    runs = []
    for lr in (ZERO_BERT["lr"], ZERO_BERT["lr"] * (1.0 + ZERO_LR_NUDGE)):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        tx = _DDP(fused_lamb(learning_rate=lr), group)
        scaler = GradScaler(group=group)
        step = make_one_step(model, scaler, tx)
        state, ss = tx.init(params), scaler.init(dev)
        state, ss, loss = step(state, ss, *batch)
        runs.append({"moves": [p.detach() - init[n]
                               for n, p in params.items()],
                     "loss": loss.item(),
                     "overflow": bool(ss.overflow.item())})
        del tx, step, state
        torch.cuda.empty_cache()
    return runs


def _zero_bert(dev, rank, world, backend, card):
    """Z-BERT in one rank: BERT-large from torch seed 0, this rank's 8 of
    window A's 16 sequences, ``make_one_step`` with a ``GradScaler`` over
    the group and ``distributed_fused_lamb`` (window A's LAMB recipe),
    three steps with the codec off and three from the same weights with
    int8: step 1's calls held (``_zero_held``), step 2 timed with its
    collectives clocked, step 3 profiled on rank 0; the ranks' parameters
    compared after each step; the launches of the int8 run (K19, K20,
    K22; and K22 in the codec-off run) read from zero; the int8 run's
    residuals followed over steps 1 and 2 (``_residuals_seen``); then the
    codec-off step 1's parameter move against the unsharded FusedLAMB
    step's (``_unsharded_moves``)."""
    import torch.distributed as dist

    from apex_tpu_torch.contrib.optimizers import distributed_fused_lamb
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.testing import BertModel

    cfg = _bert_cfg("A")
    model = BertModel(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    init = {n: p.detach().clone() for n, p in params.items()}
    b = ZERO_BERT["batch"]
    ids, mask, labels = (t[rank * b:(rank + 1) * b] for t in _bert_batch(
        "A", b * world, cfg.vocab_size, dev))
    group = dist.group.WORLD
    counts = _zero_counts()
    out = {}
    for codec in (None, "int8"):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        tx = distributed_fused_lamb(learning_rate=ZERO_BERT["lr"],
                                    num_shards=world,
                                    grad_compress=codec or "off")
        scaler = GradScaler(group=group)
        step = make_one_step(model, scaler, tx)
        state, ss = tx.init(params), scaler.init(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counts.values():
            fn.launches = 0
        records, steps, calls, seen = [], [], [], []
        profile = None
        for i in range(ZERO_BERT["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                with _zero_held(records), _residuals_seen(seen):
                    state, ss, loss = step(state, ss, ids, mask, labels)
                if codec is None:
                    zero_move = [p.detach() - init[n]
                                 for n, p in params.items()]
            elif i == 1:
                with _collective_clock(calls), _residuals_seen(seen):
                    state, ss, loss = step(state, ss, ids, mask, labels)
            elif rank == 0:
                def one():
                    nonlocal state, ss, loss
                    state, ss, loss = step(state, ss, ids, mask, labels)

                # one attempt: a rerun on this rank alone would wait on
                # collectives the other rank never joins
                profile = _profile(one, ZERO_KINDS, attempts=1)
            else:
                state, ss, loss = step(state, ss, ids, mask, labels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steps.append({"step": i + 1, "ms": ms, "loss": loss.item(),
                          "overflow": bool(ss.overflow.item()),
                          "ranks_bit_equal": _ranks_equal(
                              list(params.values()), backend)})
        launches = _read_counts(counts)
        out[codec or "off"] = {
            "steps": steps, "launches": launches,
            "held": _zero_held_summary(records),
            "collectives": {
                "calls": len(calls),
                "mb": sum(c[1] for c in calls) / 1e6,
                "host_ms": sum(c[2] for c in calls),
                "by_op": {n: [sum(1 for c in calls if c[0] == n),
                              sum(c[2] for c in calls if c[0] == n)]
                          for n in sorted({c[0] for c in calls})}},
            "profile": profile, "peak_mem_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "state_shard": state.m.numel(),
            "residuals": None if state.g_residual is None else
            [state.g_residual.numel(), state.u_residual.numel()],
            "residuals_seen": seen,
            "residuals_carried": None if codec is None else
            _residuals_carried(seen)}
        del tx, step, state
        torch.cuda.empty_cache()
    ref, nudged = _unsharded_moves(model, params, init, (ids, mask, labels),
                                   group, dev)
    noise = _moves_rel_l2(nudged["moves"], ref["moves"])
    out["unsharded"] = {
        "rel_l2": _moves_rel_l2(zero_move, ref["moves"]),
        "nudge_rel_l2": noise, "band": ZERO_MOVE_BAND * noise,
        "elements_differing": sum(int((a != b).sum()) for a, b in
                                  zip(zero_move, ref["moves"])),
        "elements": sum(a.numel() for a in zero_move),
        "loss": ref["loss"], "overflow": ref["overflow"] or
        nudged["overflow"]}
    del model, params, init, zero_move, ref, nudged
    torch.cuda.empty_cache()
    return out


class _DDP:
    """The unsharded comparison of Z-GPT and Z-BERT: the gradients
    averaged by ``allreduce_gradients`` over the group, then the inner
    fused optimizer's step (``fused_adam``: K14; ``fused_lamb``: K13,
    K15): a transform ``make_one_step`` drives as it drives the ZeRO
    one."""

    def __init__(self, inner, group):
        self.inner, self.group = inner, group

    def init(self, params):
        return self.inner.init(params)

    def step(self, grads, state, params, found_inf=None, model_params=None):
        from apex_tpu_torch.parallel import allreduce_gradients

        return self.inner.step(allreduce_gradients(grads, self.group), state,
                               params, found_inf, model_params)


def _zero_gpt(dev, rank, world, backend):
    """Z-GPT in one rank: GPT-2-small (the fused head) from seed 0, this
    rank's 4 of 8 sequences, three steps on ``distributed_fused_adam``
    (codec off; step 1 held), then from the same weights three on
    ``allreduce_gradients`` + ``fused_adam``: the parameters after each
    step compared bit for bit, the launches of K21 and K14."""
    import torch.distributed as dist

    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.testing import GPTModel

    cfg = _train_cfg(fused=True)
    model = GPTModel(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    init = {n: p.detach().clone() for n, p in params.items()}
    b, s = ZERO_GPT["batch"], TRAIN["seq"]
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b * world, s))
                           ).to(dev)[rank * b:(rank + 1) * b]
    labels = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b * world, s))
                              ).to(dev)[rank * b:(rank + 1) * b]
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    group = dist.group.WORLD
    counts = _zero_counts()
    after, out = {}, {}
    for path in ("zero", "ddp"):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        tx = (distributed_fused_adam(learning_rate=ZERO_GPT["lr"],
                                     num_shards=world, grad_compress="off")
              if path == "zero" else
              _DDP(fused_adam(learning_rate=ZERO_GPT["lr"]), group))
        scaler = GradScaler(group=group)
        step = make_one_step(model, scaler, tx)
        state, ss = tx.init(params), scaler.init(dev)
        for fn in counts.values():
            fn.launches = 0
        records, losses, after[path] = [], [], []
        for i in range(ZERO_GPT["steps"]):
            with _zero_held(records) if i == 0 and path == "zero" \
                    else contextlib.nullcontext():
                state, ss, loss = step(state, ss, ids, pos, labels)
            losses.append(loss.item())
            after[path].append([p.detach().clone() for p in params.values()])
        out[path] = {"losses": losses, "launches": _read_counts(counts),
                     "ranks_bit_equal": _ranks_equal(
                         list(params.values()), backend)}
        if path == "zero":
            out[path]["held"] = _zero_held_summary(records)
        del tx, step, state
        torch.cuda.empty_cache()
    equal = []
    for z, d in zip(after["zero"], after["ddp"]):
        equal.append({"tensors_equal": sum(_same_bits(a, c)
                                           for a, c in zip(z, d)),
                      "tensors": len(z),
                      "elements_differing": sum(
                          int((a.float() != c.float()).sum())
                          for a, c in zip(z, d)),
                      "worst_rel": max(((a.float() - c.float()).abs().max()
                                        / c.float().abs().max().clamp(
                                            min=1e-30)).item()
                                       for a, c in zip(z, d))})
    out["zero_vs_ddp"] = equal
    del model, params, init, after
    torch.cuda.empty_cache()
    return out


def _zero_rank(rank, world, tmp, backend, card):
    """One rank of Z-BERT then Z-GPT (started with ``spawn``); the results
    go to ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    dev = _tp_device(rank, backend)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        bert = _zero_bert(dev, rank, world, backend, card)
        t1 = time.perf_counter()
        gpt = _zero_gpt(dev, rank, world, backend)
        torch.save({"rank": rank, "backend": backend, "bert": bert,
                    "gpt": gpt, "bert_s": t1 - t0,
                    "gpt_s": time.perf_counter() - t1},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, timeout_s, *args):
    """``fn(rank, world, tmp, *args)`` in ``world`` ranks started with
    ``spawn``; every rank's ``tmp/rank<r>.pt``."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(fn, args=(world, tmp) + args, nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__}: ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(world)]


def _window_a_losses(dev):
    """Window A's unsharded step-1 loss on its 16 sequences (the forward
    on the initial weights), and the mean of the losses of its two halves
    of 8 (each rank's batch): their difference is the band's measure."""
    from apex_tpu_torch.train_step import per_token_loss
    from apex_tpu_torch.transformer.testing import BertModel

    cfg = _bert_cfg("A")
    model = BertModel(cfg, device=dev, seed=0)
    ids, mask, labels = _bert_batch("A", BERT_TRAIN["batch"], cfg.vocab_size,
                                    dev)
    b = BERT_TRAIN["batch"] // 2
    with torch.no_grad():
        full = torch.mean(per_token_loss(model(ids, mask, None, labels))
                          ).item()
        halves = [torch.mean(per_token_loss(model(
            ids[r * b:(r + 1) * b], mask[r * b:(r + 1) * b], None,
            labels[r * b:(r + 1) * b]))).item() for r in range(2)]
    del model
    torch.cuda.empty_cache()
    return full, halves


def phase_zero(dev, card):
    """This slice's main path: Z-BERT (``_zero_bert``) and Z-GPT
    (``_zero_gpt``) in two ranks started with ``spawn``, NCCL with a card
    each where the machine has two, else gloo with both ranks on cuda:0.
    Checks: every held K19-K22 call within its band; the ranks' parameters
    bit-equal after each step; no step overflowed; Z-BERT's step-1 loss
    (the ranks' mean) against window A's unsharded one within four times
    the move between its two halves' mean and it (at least 1e-4 of it);
    the codec-off run's parameter move in step 1 against the unsharded
    FusedLAMB step's (``_unsharded_moves``) within ``ZERO_MOVE_BAND``
    times that step's move under the learning-rate nudge, a band below
    ``ZERO_BAND_CAP``; the int8 run's step-1 loss equal to the codec-off
    run's and its later losses within ``CODEC_MOVE_SHARE`` of the
    codec-off run's move since step 1; the int8 residuals carried from
    step to step (``_residuals_carried``); the launches a step: K22 3
    (codec off),
    and with int8 K19 2 and K20 2 (the gradient hop and the update hop);
    Z-GPT's parameters bit for bit those of allreduce_gradients +
    FusedAdam after each step, K21 once a step."""
    world = ZERO_BERT["world"]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    _log(f"Z-BERT / Z-GPT transport: {torch.cuda.device_count()} card(s), "
         f"backend {backend}" + (" (both ranks share cuda:0; the "
                                 "collectives go through the host: step "
                                 "times are for correctness only)"
                                 if backend == "gloo" else ""))
    full, halves = _window_a_losses(dev)
    move = abs(sum(halves) / 2 - full)
    band = max(4 * move, 1e-4 * abs(full))
    t0 = time.perf_counter()
    ranks = _spawn(_zero_rank, world, ZERO_BERT["timeout_s"], backend, card)
    wall_s = time.perf_counter() - t0
    bert = {codec: [r["bert"][codec] for r in ranks]
            for codec in ("off", "int8")}
    step1 = sum(r["steps"][0]["loss"] for r in bert["off"]) / world
    stats = {"card": card, "backend": backend, "world": world,
             "batch_per_rank": ZERO_BERT["batch"], "phase_wall_s": wall_s,
             "rank_seconds": [[r["bert_s"], r["gpt_s"]] for r in ranks],
             "window_a_loss": full, "halves": halves,
             "step1_loss_ranks_mean": step1, "step1_diff": abs(step1 - full),
             "step1_band": band,
             "unsharded": [r["bert"]["unsharded"] for r in ranks],
             "bert": {c: [{k: v for k, v in r.items()
                           if k not in ("held", "residuals_seen")}
                          for r in runs] for c, runs in bert.items()},
             "residuals_seen": [r["residuals_seen"] for r in bert["int8"]],
             "bert_held": {c: [r["held"]["by_kernel"] for r in runs]
                           for c, runs in bert.items()},
             "gpt": [{k: v for k, v in r["gpt"].items()} for r in ranks]}
    _log("Z-BERT / Z-GPT: " + json.dumps(stats, default=str))
    bad = []
    for c, runs in bert.items():
        for r, run in enumerate(runs):
            bad += [f"Z-BERT {c} rank {r}: {x}" for x in run["held"]["bad"]]
            for s in run["steps"]:
                if not s["ranks_bit_equal"] or s["overflow"]:
                    bad.append(f"Z-BERT {c} rank {r} step {s}")
    for r in ranks:
        g = r["gpt"]
        bad += [f"Z-GPT rank {r['rank']}: {x}" for x in g["zero"]["held"]
                ["bad"]]
        if not (g["zero"]["ranks_bit_equal"] and g["ddp"]["ranks_bit_equal"]):
            bad.append(f"Z-GPT rank {r['rank']}: ranks differ")
        for i, e in enumerate(g["zero_vs_ddp"]):
            if e["tensors_equal"] != e["tensors"]:
                bad.append(f"Z-GPT rank {r['rank']} step {i + 1}: ZeRO Adam "
                           f"and DDP + FusedAdam differ: {e}")
        if g["zero"]["launches"]["multi_tensor_zero_adam"] != \
                ZERO_GPT["steps"] or g["ddp"]["launches"][
                    "multi_tensor_zero_adam"]:
            bad.append(f"Z-GPT launches: {g['zero']['launches']}")
    if abs(step1 - full) > band:
        bad.append(f"Z-BERT step 1 against window A: {abs(step1 - full)} "
                   f"(band {band})")
    steps = ZERO_BERT["steps"]
    for r in range(world):
        u = ranks[r]["bert"]["unsharded"]
        if u["overflow"] or not u["band"] < ZERO_BAND_CAP or \
                not u["rel_l2"] <= u["band"]:
            bad.append(f"Z-BERT rank {r}: step 1's parameter move against "
                       f"the unsharded FusedLAMB step's: {u}")
        off, on = bert["off"][r], bert["int8"][r]
        if off["steps"][0]["loss"] != on["steps"][0]["loss"]:
            bad.append(f"Z-BERT rank {r}: step 1 differs with the codec on")
        first = off["steps"][0]["loss"]
        for a, c in zip(off["steps"][1:], on["steps"][1:]):
            if not abs(c["loss"] - a["loss"]) <= \
                    CODEC_MOVE_SHARE * abs(a["loss"] - first):
                bad.append(f"Z-BERT rank {r}: codec on {c['loss']} against "
                           f"off {a['loss']} (step 1 {first})")
        if not on["residuals_carried"]:
            bad.append(f"Z-BERT rank {r}: the int8 residuals were not "
                       f"carried: {on['residuals_seen']}")
        want = {"off": dict(multi_tensor_zero_lamb=3 * steps,
                            collectives_quantize=0,
                            collectives_dequantize_sum=0),
                "int8": dict(multi_tensor_zero_lamb=3 * steps,
                             collectives_quantize=2 * steps,
                             collectives_dequantize_sum=2 * steps)}
        for c in ("off", "int8"):
            got = bert[c][r]["launches"]
            for k, v in want[c].items():
                if got[k] != v:
                    bad.append(f"Z-BERT {c} rank {r}: {k} launched {got[k]} "
                               f"times, want {v}")
    if bad:
        raise AssertionError("Z-BERT / Z-GPT: " + "; ".join(
            str(x) for x in bad[:12]))
    return ({"zero_bert": bert["int8"][0]["launches"],
             "zero_bert_off": bert["off"][0]["launches"],
             "zero_gpt": ranks[0]["gpt"]["zero"]["launches"]}, stats)


def _hier_rank(rank, world, tmp, backend, card):
    """One rank of HIER: GPT-2-small's width at 2 layers, this rank's 2 of
    8 sequences, one backward; the fp32 gradients all-reduced flat over
    the group, hierarchically over the (2, 2) pair, and hierarchically
    with int8 (three calls, the residual threaded; every K19/K20 call
    held); each result's checksums compared over the ranks."""
    import dataclasses

    import torch.distributed as dist

    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel import allreduce_gradients, collectives
    from apex_tpu_torch.train_step import per_token_loss
    from apex_tpu_torch.transformer.testing import GPTModel

    dev = _tp_device(rank, backend)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        pair = collectives.hierarchical_groups(HIER["inner"], HIER["outer"])
        cfg = dataclasses.replace(_train_cfg(fused=True),
                                  num_layers=HIER["layers"])
        model = GPTModel(cfg, device=dev, seed=0)
        b, s = HIER["batch"], TRAIN["seq"]
        rs = np.random.RandomState(0)
        ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b * world, s))
                               ).to(dev)[rank * b:(rank + 1) * b]
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        torch.mean(per_token_loss(model(ids, pos, None, ids))).backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        del model
        counts = _zero_counts()
        for fn in counts.values():
            fn.launches = 0
        flat = allreduce_gradients(grads)
        hier = allreduce_gradients(grads, pair, hierarchical=True)
        ddp = DistributedDataParallel(process_group=pair, compress="int8",
                                      hierarchical=True)
        ef = ddp.init_ef_state(grads)
        records, int8 = [], None
        with _zero_held(records):
            for _ in range(3):
                int8, ef = ddp.average_gradients(grads, ef)
        names = list(grads)
        cat = lambda t: torch.cat([t[n].reshape(-1) for n in names])  # noqa: E731
        f, h, q = cat(flat), cat(hier), cat(int8)
        out = {"rank": rank, "hier_vs_flat_rel_l2": _rel_l2(h, f),
               "int8_vs_flat_rel_l2": _rel_l2(q, f),
               "ranks_bit_equal": {
                   k: _ranks_equal([t], backend)
                   for k, t in (("flat", f), ("hier", h), ("int8", q))},
               "ef_len": ef.numel(), "elements": f.numel(),
               "held": _zero_held_summary(records),
               "launches": _read_counts(counts)}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_hier(dev, card):
    """HIER: world 4 as (inner, outer) = (2, 2) (``_hier_rank``), NCCL with
    four cards, else gloo with every rank on cuda:0. The hierarchical
    all-reduce within ``HIER_TOL`` relative L2 of the flat one; every
    result the same bits on every rank; every K19/K20 call held (the int8
    hop is the outer one: K19 and K20 once a call)."""
    world = HIER["world"]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    t0 = time.perf_counter()
    ranks = _spawn(_hier_rank, world, HIER["timeout_s"], backend, card)
    stats = {"card": card, "backend": backend, "world": world,
             "pair": [HIER["inner"], HIER["outer"]],
             "phase_wall_s": time.perf_counter() - t0,
             "ranks": [{k: v for k, v in r.items() if k != "held"}
                       for r in ranks],
             "held": [r["held"]["by_kernel"] for r in ranks]}
    _log("HIER: " + json.dumps(stats))
    for r in ranks:
        if r["hier_vs_flat_rel_l2"] > HIER_TOL or r["held"]["bad"] or \
                not all(r["ranks_bit_equal"].values()):
            raise AssertionError(f"HIER rank {r['rank']}: {r}")
        if (r["launches"]["collectives_quantize"],
                r["launches"]["collectives_dequantize_sum"]) != (3, 3):
            raise AssertionError(f"HIER launches: {r['launches']}")
    return ranks[0]["launches"], stats


def _larc_sgd(errors):
    """LARC(FusedSGD) as a transform: ``larc`` (trust 0.02, clip at the
    recipe's lr, the recipe's decay) before ``fused_sgd`` with its decay
    zeroed, as the LARC class steps it. Each step's scaled gradients (K13's
    norms) are held against the plain LARC path's (the plain version of
    K13) on the same gradients and masters: the worst relative error is
    appended to ``errors``."""
    from apex_tpu_torch.ops import multi_tensor
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.optimizers._base import GradientTransformation
    from apex_tpu_torch.parallel import larc

    inner = fused_sgd(learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
                      weight_decay=0.0)
    scale = larc(LARC_WINDOW["trust"], clip=True, eps=1e-8,
                 weight_decay=RESNET["weight_decay"],
                 learning_rate=RESNET["lr"])

    def step(grads, state, params, found_inf=None, model_params=None):
        got = scale.update(grads, None, params)[0]
        with mock.patch.object(multi_tensor, "l2norm",
                               multi_tensor.l2norm_reference):
            want = scale.update(grads, None, params)[0]
        errors.append(max(_rel_err(got[n], want[n]) for n in grads))
        return inner.step(got, state, params, found_inf, model_params)

    return GradientTransformation(inner.init, None, step)


def phase_larc(dev, card):
    """LARC: ResNet-50 R-O2 at world 1 (``LARC_WINDOW``: b = 64, three
    steps of the ImageNet example's step with ``_larc_sgd``); in each
    step LARC's scaled gradients (K13's norms) against the plain LARC
    path's (the plain norms) on the same gradients and masters, within
    ``ZERO_TOL``; the losses finite; K13 and K16 launched."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.frontend import (Properties, build_policy,
                                             opt_levels)
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.models import resnet50

    dtype = build_policy(opt_levels["O2"](Properties())).compute_dtype
    model = resnet50(num_classes=RESNET["classes"], dtype=dtype, device=dev,
                     seed=LARC_WINDOW["seed"])
    errs = []
    model, opt = amp.initialize(model, _larc_sgd(errs), opt_level="O2",
                                verbosity=0)
    state = opt.init(dict(model.named_parameters()))
    step = imagenet.build_train_step(model, opt, None, dtype)
    images, labels = _resnet_batch(dev, LARC_WINDOW["batch"],
                                   LARC_WINDOW["seed"])
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(LARC_WINDOW["steps"]):
        state, metrics, overflow = step(state, images, labels)
        losses.append(metrics[0].item())
    launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
    stats = {"card": card, "batch": LARC_WINDOW["batch"],
             "steps": LARC_WINDOW["steps"],
             "seconds": time.perf_counter() - t0, "losses": losses,
             "scaled_grad_err": errs, "band": ZERO_TOL,
             "launches": launches}
    _log("LARC: " + json.dumps(stats))
    if max(errs) > ZERO_TOL or not all(np.isfinite(losses)) or \
            not launches.get("multi_tensor_l2norm") or \
            not launches.get("multi_tensor_sgd"):
        raise AssertionError(f"LARC: {stats}")
    del model, opt, state
    torch.cuda.empty_cache()
    return launches, stats


# the multi-tensor kernels (K12-K15) by their names in a device trace
# ------------------------------------------------ K23, weight-quant serving

# GPT-2-small's decode matmuls at ENGINE's 8 slots: (name, K, N, launches
# a decode step) for qkv, dense, h->4h, 4h->h of each of the 12 layers,
# and the logits against the padded word table
QMM_SHAPES = (("qkv", 768, 2304, 12), ("dense", 768, 768, 12),
              ("h4", 768, 3072, 12), ("4h", 3072, 768, 12),
              ("logits", 768, 50304, 1))
# relative L2 of K23 against its plain version: the card tests' bands
# (tests/port/test_torch_kernels_cuda.py QMM_L2_TOL, set from
# tests/port/kernel_l2_errors.py)
QMM_L2_TOL = {torch.bfloat16: 5e-5, torch.float16: 5e-5, torch.float32: 2e-6}


def phase_qmatmul_kernel(dev, flush):
    """K23 at GPT-2-small's five decode shapes (x ``[8, K]`` in bf16, fp16
    and fp32, int8 weights quantized by ``serving/quant.quantize_weight``
    from seeded normal weights, one all-zero row each) on the launch
    ``ops/qmatmul_cuda.plan`` picks (the tensor-core body for bf16/fp16,
    the CUDA-core body for fp32), held against its plain version by
    relative L2 (``QMM_L2_TOL``; the zero row's outputs exactly 0), two
    runs the same bits; timed in turns around the library call, cuBLAS
    ``x @ W_deq.T`` over a weight dequantized once beforehand (the port
    never calls it), with ``--parent`` the parent's K23 before and after,
    and the plain version; the bound is the bytes (x, the int8 weight, the
    scales, y), or in fp32 the operations at the CUDA cores' rate if
    larger. The row's numbers are a bf16 decode step's: 12 x each layer
    matmul + the logits, 49 launches; beside them, the floor of this
    timing: one launch that moves 4 bytes (``one_small_launch_ms``)."""
    from apex_tpu_torch.ops import qmatmul as qmm
    from apex_tpu_torch.ops import qmatmul_cuda
    from apex_tpu_torch.serving import quant

    gen = torch.Generator(device=dev).manual_seed(23)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape, step = {}, {}
    worst_abs = 0.0
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        for name, k, n, per_step in QMM_SHAPES:
            x = torch.randn(8, k, generator=gen, device=dev).to(dtype)
            w = torch.randn(n, k, generator=gen, device=dev) * 0.02
            w[n // 3] = 0.0
            wq, scale = quant.quantize_weight(w)
            del w
            y = qmatmul_cuda.qmatmul(x, wq, scale)
            ref = qmm.qmatmul_reference(x, wq, scale, dtype)
            err = _rel_l2(y, ref)
            if not err <= QMM_L2_TOL[dtype]:
                raise AssertionError(f"K23 {tag} {name}: relative L2 {err} "
                                     f"(band {QMM_L2_TOL[dtype]})")
            if (y[:, n // 3] != 0).any() or not torch.equal(
                    qmatmul_cuda.qmatmul(x, wq, scale), y):
                raise AssertionError(f"K23 {tag} {name}: the zero row is "
                                     f"not 0 or two runs differ")
            if dtype == torch.bfloat16:
                worst_abs = max(worst_abs, _max_err(y, ref))
            w_deq = (wq.float() * scale[:, None]).to(dtype)
            t = _turns(lambda: qmatmul_cuda.qmatmul(x, wq, scale),
                       lambda: x @ w_deq.t(), flush, "qmatmul")
            plain_ms = _time_ms(
                lambda: qmm.qmatmul_reference(x, wq, scale, dtype), flush,
                reps=5)
            isz = x.element_size()
            nbytes = 8 * k * isz + n * k + 4 * n + 8 * n * isz
            bound = _bound(nbytes, 2 * 8 * n * k,
                           FP32_FLOPS_PER_S if dtype == torch.float32
                           else BF16_FLOPS_PER_S)
            p = qmatmul_cuda.plan(8, n, k, dtype, sm)
            by_shape[f"{tag} {name} [8, {k}] x [{n}, {k}]"] = {
                "rel_l2": err, "ms": t["ms"], "ms_turns": t["ms_turns"],
                "parent_ms": t.get("parent_ms"),
                "parent_ms_turns": t.get("parent_ms_turns"),
                "plain_ms": plain_ms, "library_ms": t["library_ms"],
                "bound_ms": bound[0], "bound_by": bound[1],
                "bytes": nbytes, "launches_a_decode_step": per_step,
                "plan": p._asdict()}
            acc = step.setdefault(tag, dict.fromkeys(
                ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
            for key, v in (("ms", t["ms"]), ("plain_ms", plain_ms),
                           ("library_ms", t["library_ms"]),
                           ("bound_ms", bound[0]),
                           ("parent_ms", t.get("parent_ms"))):
                if v is not None:
                    acc[key] = acc.get(key, 0.0) + per_step * v
            del x, wq, scale, w_deq, y, ref
    torch.cuda.empty_cache()
    main = step["bfloat16"]
    row = dict(name="qmatmul", route="cuda",
               source="apex_tpu_torch/csrc/qmatmul.cu",
               replaces="apex_tpu/serving/quant.py:77 (qmatmul, an XLA "
                        "contraction; no Pallas site)",
               max_abs_err=worst_abs, ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by="bytes", library_ms=main["library_ms"],
               per="a bf16 decode step of GPT-2-small at 8 slots: 49 "
                   "launches (12 x qkv, dense, h->4h, 4h->h; the logits)",
               fp16_decode_step=step["float16"],
               fp32_decode_step=step["float32"], by_shape=by_shape,
               one_small_launch_ms=_time_ms(torch.zeros(1, device=dev).zero_,
                                            flush))
    if "parent_ms" in main:
        row["parent_ms"] = main["parent_ms"]
    _log("K23: " + json.dumps(row))
    return row


# K23 at K that are not a multiple of 16: [B, K, N] (one 8-column step,
# one and a half steps, one chunk and a 36-column tail, twelve chunks and
# 2 columns), and the int8-weight engine at hidden 100
QMM_ANY_K = ((8, 8, 768), (8, 24, 768), (8, 100, 768), (8, 770, 768))


def phase_qmatmul_any_k(dev, flush):
    """K23 at ``QMM_ANY_K`` in bf16, fp16 and fp32 on the launch the plan
    picks (the tensor-core body's element-load form for bf16/fp16, the
    CUDA-core body for fp32) and on forced element-load plans, within
    ``QMM_L2_TOL`` of its plain version and two runs the same bits, each
    timed; then ``ServingEngine(weight_quant=True)`` at hidden 100 (fp32,
    2 layers, greedy, eager), whose decode matrices all have K 100 or 400,
    launching K23 and serving the tokens of the same engine with K23 on
    its plain version."""
    from apex_tpu_torch.ops import qmatmul as qmm
    from apex_tpu_torch.ops import qmatmul_cuda
    from apex_tpu_torch.serving import (ServingEngine, init_gpt_params,
                                        quant, synthetic_trace)
    from apex_tpu_torch.transformer.testing import TransformerConfig

    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for b, k, n in QMM_ANY_K:
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        w[n // 2] = 0.0
        wq, scale = quant.quantize_weight(w)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(b, k, generator=gen, device=dev).to(dtype)
            ref = qmm.qmatmul_reference(x, wq, scale, dtype)
            p = qmatmul_cuda.plan(b, n, k, dtype, 132)
            plans = [None] + ([qmatmul_cuda.Plan("tc_narrow", 2, 1, 1, 2)]
                              + ([qmatmul_cuda.Plan("tc_narrow", 1, 4, 3, 4)]
                                 if k >= 12 * 64 else [])
                              if dtype != torch.float32 else [])
            errs = []
            for forced in plans:
                with (mock.patch.object(qmatmul_cuda, "plan",
                                        lambda *_, f=forced: f)
                      if forced else contextlib.nullcontext()):
                    y = qmatmul_cuda.qmatmul(x, wq, scale)
                    again = qmatmul_cuda.qmatmul(x, wq, scale)
                err = _rel_l2(y, ref)
                if not (err <= QMM_L2_TOL[dtype] and torch.equal(y, again)
                        and (y[:, n // 2] == 0).all()):
                    raise AssertionError(f"K23 at K {k} {dtype} "
                                         f"({forced or p}): rel L2 {err}")
                errs.append(err)
            key = f"[{b}, {k}] x [{n}, {k}] {str(dtype)[6:]}"
            out[key] = {"body": p.body, "rel_l2": max(errs),
                        "plans_held": len(plans), "ms": _time_ms(
                            lambda: qmatmul_cuda.qmatmul(x, wq, scale),
                            flush)}
            _log(f"K23 any K, {key}: " + json.dumps(out[key]))
    cfg = TransformerConfig(
        hidden_size=100, num_layers=2, num_attention_heads=4,
        vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False)
    params = init_gpt_params(cfg, 0, dev)
    kw = dict(num_slots=4, page_size=16, num_pages=24, max_seq=64,
              prefill_len=64, prefill_requests=1, device=dev,
              cuda_graph=False, weight_quant=True)
    tokens, launches = {}, {}
    for plain in (False, True):
        qmatmul_cuda.qmatmul.launches = 0
        with (mock.patch.object(qmatmul_cuda, "qmatmul", lambda x, w, s:
                                qmm.qmatmul_reference(x, w, s, x.dtype))
              if plain else contextlib.nullcontext()):
            eng = ServingEngine(cfg, params, **kw)
            reqs, _ = synthetic_trace(seed=4, n_requests=6, vocab=128,
                                      prompt_lo=3, prompt_hi=20, new_lo=2,
                                      new_hi=12)
            tokens[plain] = {r.rid: list(r.out_tokens)
                             for r in eng.run_trace(reqs)}
        launches[plain] = qmatmul_cuda.qmatmul.launches
        if not plain and launches[plain] != eng.decode_steps * (
                4 * cfg.num_layers + 1):
            raise AssertionError(f"the hidden-100 engine launched K23 "
                                 f"{launches[plain]} times")
    if tokens[True] != tokens[False]:
        raise AssertionError("the hidden-100 int8-weight engine's tokens "
                             "differ from its plain path's")
    out["engine_hidden_100"] = {
        "tokens": sum(len(t) for t in tokens[False].values()),
        "same_tokens_as_plain": True, "k23_launches": launches[False]}
    _log("K23, int8-weight engine at hidden 100: "
         + json.dumps(out["engine_hidden_100"]))
    return out


def _warmup_requests():
    """Two requests outside the trace that warm an engine up (cuBLAS
    handles, the allocator), as phase 4's."""
    from apex_tpu_torch.serving import Request

    return [Request(rid=10**6, prompt=[7] * 300, max_new_tokens=3),
            Request(rid=10**6 + 1, prompt=[9] * 40, max_new_tokens=3)]


def phase_weight_quant_serving(dev):
    """``TRACE`` served by the graphed bf16-KV engine at GPT-2-small's
    width (``MODEL``, ``ENGINE``, weights from torch seed 0) with
    ``weight_quant=False`` and ``True`` in turns (off, on, on, off): each
    run's tokens/s, TTFT and TPOT p50/p99 and decode-round ms (the mean of
    its two turns); in the first turn of each a traced rerun of the trace
    counts K23 on the device by name, which must be 49 a decode step with
    the int8 weights (12 layers x 4 + the logits) and 0 without, and at
    the wrapper (the warm-up and the capture: 2 x 49); the kernel path's
    decode logits (prefill, then 4 decode steps on the int8 records)
    against the plain path's (every kernel, K23 included, on its plain
    version) within ``LOGITS_BAND``."""
    from apex_tpu_torch.ops import qmatmul_cuda
    from apex_tpu_torch.serving import (ServingEngine, init_gpt_params,
                                        lifecycle, synthetic_trace)
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**MODEL)
    params = init_gpt_params(cfg, 0, dev)
    per_step = 4 * cfg.num_layers + 1
    runs = {False: [], True: []}
    out = {}
    for turn, wq in enumerate((False, True, True, False)):
        qmatmul_cuda.qmatmul.launches = 0
        engine = ServingEngine(cfg, params, device=dev, weight_quant=wq,
                               **ENGINE)
        if engine.weight_quant != wq or (engine.qparams is None) == wq:
            raise AssertionError(f"weight_quant={wq} did not resolve")
        engine.run_trace(_warmup_requests())
        reqs, _ = synthetic_trace(vocab=cfg.vocab_size, **TRACE)
        base = (engine.decode_steps, engine.tokens_generated)
        wall, rounds = _drive_trace(engine, reqs)
        lat = lifecycle.request_latencies(reqs)
        ttft = [x["ttft_s"] * 1e3 for x in lat if x["ttft_s"] is not None]
        tpot = [x["tpot_s"] * 1e3 for x in lat if x["tpot_s"] is not None]
        tokens = engine.tokens_generated - base[1]
        stats = {"tokens_per_s": tokens / wall, "tokens": tokens,
                 "dispatches": engine.decode_steps - base[0],
                 "decode_round_ms": 1e3 * sum(rounds) / max(len(rounds), 1),
                 "ttft_p50_ms": lifecycle.percentile(ttft, 50),
                 "ttft_p99_ms": lifecycle.percentile(ttft, 99),
                 "tpot_p50_ms": lifecycle.percentile(tpot, 50),
                 "tpot_p99_ms": lifecycle.percentile(tpot, 99)}
        if turn < 2:
            traced, (_, t_decodes) = _traced_serve(
                engine, _offset_rids(synthetic_trace(
                    vocab=cfg.vocab_size, **TRACE)[0], 3000))
            want = t_decodes * per_step if wq else 0
            if traced["qmatmul"] != want:
                raise AssertionError(
                    f"weight_quant={wq}: the device ran K23 "
                    f"{traced['qmatmul']} times, want {want} ({t_decodes} "
                    f"decode steps x {per_step})")
            wrapper = qmatmul_cuda.qmatmul.launches
            if wrapper != (2 * per_step if wq else 0):
                raise AssertionError(f"weight_quant={wq}: K23's wrapper "
                                     f"counted {wrapper}")
            stats["traced_k23"] = traced["qmatmul"]
            stats["traced_decode_steps"] = t_decodes
            stats["k23_wrapper_launches"] = wrapper
            if wq:
                out["logits"] = phase_paths_agree(engine, dev)
                out["launches"] = {"qmatmul": wrapper}
        runs[wq].append(stats)
        del engine
        torch.cuda.empty_cache()
    merged = {}
    for wq, turns in runs.items():
        key = "int8 weights" if wq else "bf16 weights"
        merged[key] = {m: statistics.mean(t[m] for t in turns)
                       for m in ("tokens_per_s", "decode_round_ms",
                                 "ttft_p50_ms", "ttft_p99_ms",
                                 "tpot_p50_ms", "tpot_p99_ms")}
        merged[key]["turns_tokens_per_s"] = [t["tokens_per_s"]
                                             for t in turns]
        merged[key].update({k: turns[0][k] for k in turns[0]
                            if k.startswith(("traced", "k23"))})
    out["window"] = merged
    _log("serving, bf16 vs int8 weights (graphed, bf16 KV, in turns): "
         + json.dumps(merged))
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ DCGAN

# BASELINE config 5, the upstream example's defaults (nz 100, ngf = ndf =
# 64, 64^2 images, --batchSize 64; opt level O1), synthetic images: 2
# warm-up and 5 timed steps
DCGAN = dict(batch=64, nz=100, ngf=64, ndf=64, image=64, lr=2e-4, beta1=0.5,
             warmup=2, timed=5)
# fp32 nudge of the images and z that sets the kernel-vs-plain band, and
# the gradients' floor (relative L2; K17/K18 differ from their plain
# versions by ~1e-7 in fp32, a wrong kernel by orders more)
DCGAN_NUDGE = 1e-7
DCGAN_NUDGES = 4
DCGAN_GRAD_FLOOR = 1e-5


class _DcganArgs:
    nz, ngf, ndf = DCGAN["nz"], DCGAN["ngf"], DCGAN["ndf"]
    lr, beta1 = DCGAN["lr"], DCGAN["beta1"]

    def __init__(self, level):
        self.opt_level = level


def _dcgan_setup(dev, level):
    from apex_tpu_torch.examples import dcgan

    netG, netD, optG, optD = dcgan.build_models(_DcganArgs(level), dev)
    stG = optG.init(dict(netG.named_parameters()))
    stD = optD.init(dict(netD.named_parameters()))
    step = dcgan.build_train_step(netG, netD, optG, optD)
    return netG, netD, optG, optD, stG, stD, step


def _dcgan_batches(dev, steps):
    """The example's synthetic batches (``np.random.RandomState(0)``: the
    images, then z, a step), on the card."""
    rs = np.random.RandomState(0)
    b, s = DCGAN["batch"], DCGAN["image"]
    out = []
    for _ in range(steps):
        real = (rs.rand(b, s, s, 3) * 2 - 1).astype(np.float32)
        z = rs.randn(b, 1, 1, DCGAN["nz"]).astype(np.float32)
        out.append((torch.from_numpy(real).to(dev),
                    torch.from_numpy(z).to(dev)))
    return out


def _dcgan_state(netG, netD):
    """Copies of both models' parameters and running stats (a pass changes
    the running stats)."""
    return {name: {n: t.detach().clone() for n, t in
                   itertools.chain(net.named_parameters(),
                                   net.named_buffers())}
            for name, net in (("G", netG), ("D", netD))}


@torch.no_grad()
def _dcgan_restore(netG, netD, saved):
    for net, name in ((netG, "G"), (netD, "D")):
        for n, t in itertools.chain(net.named_parameters(),
                                    net.named_buffers()):
            t.copy_(saved[name][n])


def _dcgan_passes(netG, netD, real, z):
    """One step's three passes without the optimizer, as
    ``examples/dcgan.build_train_step`` runs them: ``(the three losses
    summed, the gradients)``, D's the real and fake passes' summed, G's
    through D with D's stats left alone; fp32."""
    from apex_tpu_torch.examples import dcgan

    pG = dict(netG.named_parameters())
    pD = dict(netD.named_parameters())
    l0 = dcgan.bce_logits(netD(real, train=True), 1.0)
    g0 = torch.autograd.grad(l0, list(pD.values()))
    with torch.no_grad():
        fake = netG(z, train=True)
    l1 = dcgan.bce_logits(netD(fake, train=True), 0.0)
    g1 = torch.autograd.grad(l1, list(pD.values()))
    l2 = dcgan.bce_logits(netD(netG(z, train=True), train=True,
                               update_stats=False), 1.0)
    g2 = torch.autograd.grad(l2, list(pG.values()))
    grads = {f"D.{n}": a.float() + b.float() for n, a, b in zip(pD, g0, g1)}
    grads.update({f"G.{n}": g.float() for n, g in zip(pG, g2)})
    return (l0 + l1 + l2).item(), grads


def _dcgan_k12_k14_held(netD, optD, stD, real):
    """K12 (the unscale) and K14 (Adam) held on one D-real pass's real
    gradients: K12 against ``ops/multi_tensor.scale_reference`` and K14
    against ``apply_plain`` of ``fused_adam``'s update on copies of the
    state, each bit for bit."""
    from apex_tpu_torch.examples import dcgan
    from apex_tpu_torch.ops import multi_tensor, multi_tensor_cuda
    from apex_tpu_torch.optimizers._base import apply_plain

    params = dict(netD.named_parameters())
    scaled = torch.autograd.grad(
        optD.scale_loss(dcgan.bce_logits(netD(real, train=True), 1.0), stD),
        list(params.values()))
    scaled = [g.contiguous() for g in scaled]
    inv = 1.0 / stD.scalers[0].loss_scale
    fp32 = [torch.float32] * len(scaled)
    got, flag_k = multi_tensor_cuda.scale(scaled, fp32, inv, True,
                                          torch.bool)
    want, flag_p = multi_tensor.scale_reference(scaled, fp32, inv, True,
                                                torch.bool)
    k12 = all(_same_bits(a, b) for a, b in zip(got, want)) and bool(
        flag_k.item()) == bool(flag_p.item())
    grads = dict(zip(params, got))
    tx = optD.tx
    pk = {n: (stD.master_params or params)[n].detach().float().clone()
          for n in params}
    pp = {n: t.clone() for n, t in pk.items()}
    sk, sp = tx.init(pk), tx.init(pp)
    no = torch.tensor(False, device=real.device)
    tx.step(grads, sk, pk, no)
    apply_plain(tx.update, grads, sp, pp, no)
    k14 = (all(_same_bits(pk[n], pp[n]) for n in pk)
           and all(_same_bits(sk.m[n], sp.m[n]) and _same_bits(sk.v[n],
                                                               sp.v[n])
                   for n in pk))
    return {"k12_bitwise": k12, "k14_bitwise": k14, "leaves": len(grads)}


def phase_dcgan(dev, card, level):
    """DCGAN (BASELINE config 5: ``DCGAN``, the upstream example's
    defaults) trained by ``examples/dcgan.build_train_step`` under amp
    ``level``: the three-loss step, two Adams on K14 through
    ``amp.initialize(..., num_losses=3)``, the unscales on K12, 4 batch
    norms a G pass and 3 a D pass on K17/K18. 2 warm-up and 5 timed steps
    (host clock ending in ``synchronize``): step ms, images/s, peak
    memory, the losses; the launches a step. One more step with every
    K17/K18 call held against its plain version on its own activations
    (``_bn_held``), and K12 and K14 held bit for bit on real gradients
    (``_dcgan_k12_k14_held``). Then one step's three passes from the same
    state through the kernel path and the plain path (K17/K18 on their
    plain versions; ``_dcgan_passes``): the losses, and under O1 the
    gradients (the model's relative L2 and the worst tensor's), each
    within the larger of its floor (1e-6 of the losses, ``DCGAN_GRAD_FLOOR``)
    and twice the farthest the kernel path itself moves over
    ``DCGAN_NUDGES`` draws of the images and z moved by ``DCGAN_NUDGE``
    relative (``_held``). Last a profiled two-step
    window."""
    t0 = time.perf_counter()
    netG, netD, optG, optD, stG, stD, step = _dcgan_setup(dev, level)
    batches = _dcgan_batches(dev, DCGAN["warmup"] + DCGAN["timed"] + 1)
    n_params = sum(p.numel() for net in (netG, netD)
                   for p in net.parameters())
    _log(f"DCGAN ({level}) built in {time.perf_counter() - t0:.2f} s: "
         f"{n_params} parameters")
    losses = []
    for real, z in batches[:DCGAN["warmup"]]:
        stG, stD, lv = step(stG, stD, real, z)
        losses.append(lv)
    torch.cuda.synchronize()
    counts = _training_counts()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for real, z in batches[DCGAN["warmup"]:-1]:
        stG, stD, lv = step(stG, stD, real, z)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    vals = [x.tolist() for x in losses]
    step_ms = wall / DCGAN["timed"] * 1e3
    stats = {"card": card, "opt_level": level, "batch": DCGAN["batch"],
             "image": DCGAN["image"], "n_params": n_params,
             "param_dtypes": sorted({str(p.dtype).replace("torch.", "")
                                     for net in (netG, netD)
                                     for p in net.parameters()}),
             "step_ms": step_ms,
             "images_per_s": DCGAN["batch"] / (step_ms / 1e3),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "losses_d_g": vals,
             "launches_per_step": {k: v / DCGAN["timed"]
                                   for k, v in launches.items() if v}}
    _log(f"DCGAN {level}: " + json.dumps(stats))
    if not np.isfinite(vals).all():
        raise AssertionError(f"DCGAN {level}: losses not finite: {vals}")
    # a step's norms: forward, D on the real and the fake batch, G for the
    # fake, G and D in the G step (3 + 4 + 3 + 4 + 3); backward, D twice
    # and the G step's D and G (3 + 3 + 3 + 4)
    norms_fwd, norms_bwd = 17, 13
    want = {"batch_norm_fwd_one": norms_fwd,
            "batch_norm_bwd_one": norms_bwd,
            "batch_norm_fwd_stats": 0, "batch_norm_fwd_apply": 0,
            "batch_norm_bwd_stats": 0, "batch_norm_bwd_apply": 0,
            "multi_tensor_adam": 2, "multi_tensor_scale": None}
    for k, per in want.items():
        got = launches[k] / DCGAN["timed"]
        if (per is None and got < 3) or (per is not None and got != per):
            raise AssertionError(f"DCGAN {level}: {k} launched {got} times "
                                 f"a step, want "
                                 f"{'at least 3' if per is None else per}")
    records = []
    real, z = batches[-1]
    with _bn_held(records):
        stG, stD, _ = step(stG, stD, real, z)
    held = _bn_held_summary(records, norms_fwd, norms_bwd)
    stats["batch_norm_held"] = held
    _log(f"DCGAN {level}, each K17/K18 call of one step against its plain "
         f"version: " + json.dumps(held))
    if held["bad"]:
        raise AssertionError(f"DCGAN {level}: K17/K18 past their bands: "
                             f"{held['bad'][:8]}")
    mt = _dcgan_k12_k14_held(netD, optD, stD, real)
    stats["k12_k14_held"] = mt
    _log(f"DCGAN {level}, K12 and K14 on real gradients: " + json.dumps(mt))
    if not (mt["k12_bitwise"] and mt["k14_bitwise"]):
        raise AssertionError(f"DCGAN {level}: K12/K14 differ from their "
                             f"plain versions: {mt}")

    # kernel path vs plain path on one step's three passes from the same
    # state: the losses and the gradients, taken before Adam (whose early
    # steps move an element by ~lr whatever its gradient's size), held by
    # _held: each within the larger of its floor and twice the kernel
    # path's farthest own move when the images and z move by DCGAN_NUDGE
    # (DCGAN_NUDGES draws: at flax's init one draw moves the gradients as
    # far as the plain path does, ~1e-4 relative L2); under O2
    # the losses alone (a bf16 parameter's gradient is rounded to bf16), as
    # ResNet's O2 is held
    saved = _dcgan_state(netG, netD)
    gen = torch.Generator(device=dev).manual_seed(5)

    def nudge(t):
        return t * (1 + DCGAN_NUDGE * torch.randn(t.shape, generator=gen,
                                                  device=dev))

    def passes(r, zz):
        _dcgan_restore(netG, netD, saved)
        return _dcgan_passes(netG, netD, r, zz)

    kernel = passes(real, z)
    moves = [_distances(passes(nudge(real), nudge(z)), kernel)
             for _ in range(DCGAN_NUDGES)]
    noise = tuple(max(m[i] for m in moves) for i in range(3))
    with _plain_path(_resnet_plain_patches(bn_only=True)):
        plain = passes(real, z)
    judged = 3 if level == "O1" else 1
    floors = (1e-6 * max(1.0, abs(kernel[0])), DCGAN_GRAD_FLOOR,
              DCGAN_GRAD_FLOOR)
    stats["paths_agree"] = _held(
        f"DCGAN {level}, kernel vs plain path (one step's passes, b = "
        f"{DCGAN['batch']})", _distances(kernel, plain)[:judged],
        noise[:judged], floors[:judged])
    _dcgan_restore(netG, netD, saved)

    def two_steps():
        nonlocal stG, stD
        for _ in range(2):
            stG, stD, _ = step(stG, stD, real, z)

    stats["profile"] = _profile(two_steps, ("conv", "batch_norm",
                                            "elementwise", "optimizer",
                                            "other"))
    del netG, netD, optG, optD, stG, stD, step, batches, saved
    torch.cuda.empty_cache()
    return _with_totals(launches), stats


# ------------------------------------------------------- ImageNet --resume

# resnet18 at width 16, 64^2 images, b = 8, 3 steps an epoch, 10 classes
IMAGENET_RESUME = ["--synthetic", "--arch", "resnet18", "--num-filters",
                   "16", "-b", "8", "--steps", "3", "--image-size", "64",
                   "--num-classes", "10", "--deterministic",
                   "--print-freq", "100", "--opt-level", "O2"]


def _resume_state(path):
    """A checkpoint's tensors by name: the parameters, the running stats,
    the masters, the SGD state, the scalers."""
    rec = torch.load(path, weights_only=False)
    flat = {f"params/{k}": v for k, v in rec["params"].items()}
    flat.update({f"stats/{k}": v for k, v in rec["batch_stats"].items()})
    st = rec["amp_state"]
    flat.update({f"master/{k}": v for k, v in
                 (st.master_params or {}).items()})
    flat.update({f"buf/{k}": v for k, v in
                 st.inner.momentum_buf.items()})
    flat["count"] = st.inner.count
    for i, s in enumerate(st.scalers):
        flat[f"scaler{i}"] = torch.stack([s.loss_scale,
                                          s.unskipped.float()])
    return rec["epoch"], flat


def phase_imagenet_resume(dev):
    """The ImageNet example's ``--resume`` on the card (``IMAGENET_RESUME``):
    two epochs straight, twice, and one epoch then a resumed second; the
    final checkpoints' parameters, running stats, masters, SGD state and
    scalers compared bit for bit. ``--deterministic`` sets cuDNN's
    deterministic algorithms; where the two straight runs still differ,
    the resumed run is held within 10 x their distance instead, and the
    log says so."""
    import tempfile

    from apex_tpu_torch.examples import imagenet

    from apex_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory(dir=str(_build.BUILD_DIR.parent)) as tmp:
        paths = {k: os.path.join(tmp, f"{k}.pt")
                 for k in ("a", "a2", "resumed")}
        t0 = time.perf_counter()
        for k in ("a", "a2"):
            imagenet.main(IMAGENET_RESUME + ["--epochs", "2",
                                             "--checkpoint", paths[k]])
        imagenet.main(IMAGENET_RESUME + ["--epochs", "1", "--checkpoint",
                                         paths["resumed"]])
        imagenet.main(IMAGENET_RESUME + ["--epochs", "2", "--resume",
                                         paths["resumed"], "--checkpoint",
                                         paths["resumed"]])
        seconds = time.perf_counter() - t0
        states = {k: _resume_state(p) for k, p in paths.items()}
    if any(e != 2 for e, _ in states.values()):
        raise AssertionError(f"checkpoint epochs {states}")
    a, a2, r = (states[k][1] for k in ("a", "a2", "resumed"))

    def differ(x, y):
        return sorted(k for k in x if not _same_bits(x[k], y[k]))

    def rel(x, y):
        num = sum(((x[k].float() - y[k].float()) ** 2).sum() for k in x)
        den = sum((y[k].float() ** 2).sum() for k in y)
        return (num / den).sqrt().item()

    out = {"tensors": len(a), "seconds": seconds,
           "straight_runs_differ": differ(a, a2)[:5],
           "resumed_differs": differ(r, a)[:5],
           "cudnn_deterministic": torch.backends.cudnn.deterministic}
    if not out["straight_runs_differ"]:
        out["bit_equal"] = not out["resumed_differs"]
        if not out["bit_equal"]:
            raise AssertionError(f"--resume is not bit-equal to straight "
                                 f"training: {out}")
    else:
        out["bit_equal"] = False
        out["straight_rel_l2"] = rel(a2, a)
        out["resumed_rel_l2"] = rel(r, a)
        if not out["resumed_rel_l2"] <= 10 * out["straight_rel_l2"]:
            raise AssertionError(f"--resume outside the band: {out}")
    _log("ImageNet --resume (resnet18 at width 16, 3 steps an epoch, O2): "
         + json.dumps(out))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    return out


MT_KERNEL = re.compile(r"\b(scale|axpby|norm_partials|norm_reduce|"
                       r"adam_list|lamb_list|zero_adam|zero_lamb_stage[12]|"
                       r"zero_lamb_segments)_kernel\b")
# the int8 codec (K19, K20) by name
CODEC_KERNEL = re.compile(r"\b(quantize|dequantize_sum|dequantize_gather)"
                          r"_kernel\b")


def _kind(name, kinds=()):
    """A device kernel's kind. "batch_norm", "sgd", "conv" and
    "elementwise" (the ResNet windows' kinds) are told apart only where
    ``kinds`` lists them, so that every other window keeps the kinds (and
    the "other") that it was first recorded with."""
    low = name.lower()
    if "batch_norm" in kinds and re.search(
            r"\bbn_(stats|fwd_apply|bwd_apply|fwd|bwd)_kernel", name):
        return "batch_norm"
    if "sgd" in kinds and re.search(r"\bsgd_kernel\b", name):
        return "sgd"
    if "conv" in kinds and any(w in low for w in (
            "fprop", "dgrad", "wgrad", "implicit", "cudnn", "convolve",
            "conv2d", "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if "xent_" in name:
        return "lm_head"
    if "prefill_attention_" in name:
        return "attention_fwd"
    if "attention_bwd_" in name:
        return "attention_bwd"
    if "decode_attention_split" in name:
        return "decode_attention"
    if "layer_norm_" in name:
        return "layer_norm"
    if "softmax_fwd_kernel" in name or "softmax_bwd_kernel" in name:
        return "softmax"
    if MT_KERNEL.search(name):
        return "optimizer"
    if "codec" in kinds and CODEC_KERNEL.search(name):
        return "codec"
    if "memcpy" in kinds and "memcpy" in low:
        return "memcpy"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "sm90_")):
        return "matmul"
    if "elementwise" in kinds and ("elementwise_kernel" in name
                                   or "reduce_kernel" in name):
        return "elementwise"
    return "other"


def _profile(fn, kinds, top=8, attempts=PROFILE_ATTEMPTS):
    """Run ``fn`` under torch.profiler (``_profiled``); the window's busy
    share and its device time by kind (None when the profiler saw no
    device time); the ``top`` kernels by device time are logged."""
    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    prof, wall_us, lost = _profiled(timed, attempts=attempts)
    by_kind = dict.fromkeys(kinds, 0.0)
    by_name = []
    for evt in _device_events(prof):
        kind = _kind(evt.key, kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + evt.self_device_time_total
        by_name.append((evt.self_device_time_total, evt.count, evt.key[:60]))
    busy = sum(by_kind.values())
    if busy == 0:
        _log("device busy share: not measured (the profiler saw no "
             "device time)")
        return None
    share = {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
             "device_busy_share": busy / wall_us}
    share.update({f"{k}_ms": v / 1e3 for k, v in by_kind.items()})
    share["traced"] = _count_traced(prof)
    share["records_lost"] = lost
    _log("profiled window: " + json.dumps(share))
    for us, count, name in sorted(by_name, reverse=True)[:top]:
        _log(f"  {us / 1e3:8.3f} ms  {count:6d} x  {name}")
    return share


def phase_training_profile(state):
    """Two training steps under torch.profiler (the profiler adds host
    cost, so this window's wall is not a step time)."""
    model, scaler, step, opt_state, ss, ids, pos, labels = state
    ss = scaler.init(ids.device)

    def two_steps():
        nonlocal opt_state, ss
        for _ in range(2):
            opt_state, ss, _ = step(opt_state, ss, ids, pos, labels)

    return _profile(two_steps, ("attention_fwd", "attention_bwd",
                                "softmax", "layer_norm", "lm_head", "matmul",
                                "optimizer", "other"))


def _kernel_label(fn):
    """A mangled kernel name as "<kernel> <dtype> <instance>" for the
    attention kernels and the LM head's kernels; "" for the others."""
    dtypes = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
    att = re.search(r"(attention_bwd_(?:dq|dkv)_(?:tc2?|simt)|"
                    r"prefill_attention_(?:tc|simt))I"
                    r"(13__nv_bfloat16|6__half|f)Li(\d+)ELb([01])", fn)
    tc = re.search(r"xent_bwd_tcI(13__nv_bfloat16|6__half)Lb([01])ELi(\d+)E",
                   fn)
    general = re.search(r"(xent_(?:dx|de)_(?:simt|wmma))I"
                        r"(13__nv_bfloat16|6__half|f)E", fn)
    fwd = re.search(r"(xent_fwd_tc|xent_fwd_partial_kernel)I"
                    r"(13__nv_bfloat16|6__half|f)E", fn)
    if att:
        return (f"{att.group(1)} {dtypes[att.group(2)]} d={att.group(3)}"
                f"{' dropout' if att.group(4) == '1' else ''}")
    if tc:
        return (f"xent_bwd_tc {dtypes[tc.group(1)]} "
                f"{'dE' if tc.group(2) == '1' else 'dX'} b={tc.group(3)}")
    if general:
        return f"{general.group(1)} {dtypes[general.group(2)]}"
    if fwd:
        form = ("" if fwd.group(1) == "xent_fwd_tc" else
                " (simt)" if fwd.group(2) == "f" else " (wmma)")
        return f"{fwd.group(1)} {dtypes[fwd.group(2)]}{form}"
    return ""


def _log_ptxas(name, log):
    """ptxas's registers and spills in one source's build log (the
    attention kernels and the LM head's kernels named), how many
    warpgroup arrive/wait points it injected around wgmma (C7517/C7519:
    register hazards it resolved by waiting), and which kernels it
    serialized every wgmma of (C7510-C7520)."""
    kernel = ""
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            label = _kernel_label(entry.group(1))
            kernel = f"{label}: " if label else ""
        elif "Used" in line and "registers" in line or "spill" in line:
            _log(f"  {name}: {kernel}{line.strip()}")
    injected = sum("is injected" in line for line in log)
    if injected:
        _log(f"  {name}: ptxas injected {injected} warpgroup arrive/wait "
             f"points around wgmma")
    for line in log:
        if "instructions are serialized" in line:
            fn = re.search(r"function '(\S+)'", line)
            _log(f"  {name}: wgmma serialized in "
                 f"{_kernel_label(fn.group(1)) if fn else line.strip()}")


def _check_attention_bwd_ptxas(log):
    """Fail if ptxas spilled in a tensor-core K5/K6 instantiation at d =
    256 or serialized the wgmma of any K5/K6 instantiation (C7510-C7520,
    "instructions are serialized")."""
    kernel, spilled = "", []
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _kernel_label(entry.group(1))
        elif ("_tc" in kernel and "d=256" in kernel and "spill" in line
              and not re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", line)):
            spilled.append(f"{kernel}: {line.strip()}")
    serialized = [line.strip() for line in log
                  if "instructions are serialized" in line]
    if spilled or serialized:
        raise AssertionError(f"attention_bwd at d = 256: spills {spilled}; "
                             f"serialized wgmma {serialized}")
    _log("attention_bwd: no spills at d = 256, no serialized wgmma")


def _tensor_core_sass(lib, kernels):
    """The tensor-core instructions in each bf16 instantiation of
    ``kernels`` in a built library, from ``cuobjdump -sass`` (beside the
    ``nvcc`` that built it): ``{"<kernel> <instance>": {"HGMMA": n,
    "HMMA": n}}`` (HGMMA is wgmma, HMMA mma.sync), the instance "d=<head
    dim> [dropout]" of an attention kernel (``<T, int D, bool
    DROPOUT>``), "dX|dE b=<streamed rows>" of ``xent_bwd_tc`` (``<T,
    bool DE, int B>``), none for ``xent_fwd_tc`` (``<T>``), "bf16|fp16
    nt=<n-tiles> depth=<chunks in flight>[ element loads]" of K23's
    tensor-core ``qmatmul_kernel`` (``<T, int NT, int D, bool WIDE>``: NT
    1-2 at D 2 and 4, 3-4 at D 2, bf16 and fp16, 16-byte or element
    loads); None where the toolkit has no cuobjdump."""
    from apex_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split("\n", 1)[0]
        kernel = next((k for k in kernels if k in fn), None)
        att = re.search(r"nv_bfloat16Li(\d+)ELb([01])E", fn)
        tc = re.search(r"nv_bfloat16Lb([01])ELi(\d+)E", fn)
        fwd = re.search(r"xent_fwd_tcI13__nv_bfloat16E", fn)
        qmm = re.search(r"qmatmul_kernelI(13__nv_bfloat16|6__half)Li([1-4])ELi"
                        r"([24])ELb([01])E", fn)
        if kernel is None or (att or tc or fwd or qmm) is None:
            continue
        if qmm:
            key = (f"{kernel} {'bf16' if 'bfloat' in qmm.group(1) else 'fp16'}"
                   f" nt={qmm.group(2)} depth={qmm.group(3)}"
                   + ("" if qmm.group(4) == "1" else " element loads"))
        else:
            key = (f"{kernel} d={att.group(1)}"
                   + (" dropout" if att.group(2) == "1" else "") if att else
                   f"{kernel} {'dE' if tc.group(1) == '1' else 'dX'} "
                   f"b={tc.group(2)}" if tc else kernel)
        counts[key] = {"HGMMA": chunk.count("HGMMA"),
                       "HMMA": chunk.count("HMMA")}
    return counts


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false — this "
                 "smoke needs a CUDA card")
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--parent"):
        sys.exit("usage: python3 chip_smoke.py [--parent CHECKOUT]")
    from apex_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(smi)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"SM clock, maximum and now: {clocks} (INT32_OPS_PER_S assumes "
         f"{INT32_OPS_PER_S / (132 * 64) / 1e6:.0f} MHz)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}; allow_tf32 matmul/cudnn "
         f"False/False")
    dev = torch.device("cuda")

    phase_s = {}
    last = [time.perf_counter()]

    def mark(name):
        # the seconds since the previous mark, under the phase's name
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - last[0]
        _log(f"phase done: {name}, {now - last[0]:.1f} s (wall "
             f"{now - t_start:.1f} s)")
        last[0] = now

    mark("device")
    parent = _start_parent_build(args[1]) if args else None
    build_s = _build.build()
    _log(f"build: {build_s:.1f} s for {len(_build.SOURCES)} sources")
    if parent:
        _finish_parent_build(parent)
    for name in _build.SOURCES:
        _log_ptxas(name, _build.build_log.get(name, "").splitlines())
    _check_attention_bwd_ptxas(
        _build.build_log.get("attention_bwd", "").splitlines())
    # the bf16 instantiations (d 64, 128 and 256, with and without dropout)
    # of K5/K6 (twelve; K6 at d = 256 is attention_bwd_dkv_tc2) and K1 (d
    # 64, 128 and 256: six), those of the tensor-core K8/K9 (32- and 16-row
    # streamed tiles, four) and that of the tensor-core K7/K7p first stage
    # (one) must hold wgmma (HGMMA) instructions, and K23's tensor-core
    # body (bf16 and fp16, six (n-tiles, depth) each, 16-byte and element
    # loads: twenty-four) mma.sync (HMMA)
    sass = {}
    for source, kernels, want, op in (
            ("attention_bwd", ("attention_bwd_dq_tc", "attention_bwd_dkv_tc"),
             12, "HGMMA"),
            ("prefill_attention", ("prefill_attention_tc",), 6, "HGMMA"),
            ("xent", ("xent_bwd_tc", "xent_fwd_tc"), 5, "HGMMA"),
            ("qmatmul", ("qmatmul_kernel",), 24, "HMMA")):
        counts = _tensor_core_sass(_build.lib_path(source), kernels)
        if counts is None:
            _log("cuobjdump is not in the toolkit: the tensor-core "
                 "instructions of K1, K5-K9, K23 are not counted")
            sass = None
            break
        for key, n in sorted(counts.items()):
            _log(f"  {source} {key}: {n['HGMMA']} HGMMA, "
                 f"{n['HMMA']} HMMA")
        if len(counts) != want or any(n[op] == 0 for n in counts.values()):
            raise AssertionError(f"a tensor-core {source} kernel has no "
                                 f"{op} instructions: {counts}")
        sass.update(counts)

    mark("build")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = [phase_prefill_kernel(dev, flush), phase_decode_kernel(dev, flush)]
    rows += phase_layer_norm_kernels(dev, flush)
    bwd_rows, k1_train = phase_attention_bwd_kernels(dev, flush)
    rows += bwd_rows
    rows[0]["training_shape"] = k1_train
    rows += phase_dropout_kernels(dev, flush)
    mask_check = phase_dropout_mask_exact(dev)
    rows += phase_xent_kernels(dev, flush)
    rows.append(phase_int8_decode_kernel(dev, flush))
    rows += phase_softmax_kernels(dev, flush)
    rows += phase_long_softmax_kernels(dev, flush)
    rows.append(phase_xent_shard_kernels(dev, flush))
    torch.cuda.empty_cache()
    rows += phase_multi_tensor_kernels(dev, flush)
    torch.cuda.empty_cache()
    mark("kernels: attention, layer norm, LM head, softmax, K12-K15")
    # the scale-out kernels: K19/K20 at BERT-large's flat gradient, K21 on
    # GPT-2-small's shard, K22 on BERT-large's
    rows += phase_scale_out_kernels(dev, flush)
    torch.cuda.empty_cache()
    # the W8A16 decode matmul at GPT-2-small's five decode shapes
    rows.append(phase_qmatmul_kernel(dev, flush))
    rows[-1]["any_k"] = phase_qmatmul_any_k(dev, flush)
    torch.cuda.empty_cache()
    mark("kernels: K19-K23")
    # ResNet-50's kernels: K17/K18 at its batch-norm shapes, K16 on its
    # 161 leaves (the ResNet phases' seconds are logged against the ~120 s
    # they were given)
    t0 = time.perf_counter()
    rows += phase_batch_norm_kernels(dev, flush)
    rows.append(phase_sgd_kernel(dev, flush))
    resnet_s = {"K16-K18 kernels": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    # BERT-large's kernel modes (K1d, K5d, K6d non-causal with segment ids;
    # K10 with the extended padding mask, K11): numbers beside each row
    bert_modes = phase_bert_kernel_modes(dev, flush)
    bert_mask = phase_bert_mask_exact(dev)
    for row in rows:
        if row["name"] in bert_modes:
            row["bert_large"] = bert_modes[row["name"]]
    torch.cuda.empty_cache()
    # the attention kernels at head dims 80 and 256: numbers beside each
    # kernel's row
    wider = phase_attention_head_dims(dev, flush)
    for row in rows:
        if row["name"] in wider:
            row["by_head_dim"] = wider[row["name"]]
    torch.cuda.empty_cache()
    # the generic softmax over 8192 keys, the path of K10L/K11L
    launches_by = {"generic_softmax_long": phase_generic_softmax_path(dev)}
    torch.cuda.empty_cache()
    mark("kernels: ResNet, BERT modes, head dims, generic softmax")

    # serving over bf16 pages, then over the int8 KV tier with the same 72
    # pages, each engine on its own
    serving, logits, traced_by = {}, {}, {}
    for quant in (False, True):
        engine, counts, serving[quant] = phase_end_to_end(dev, kv_quant=quant)
        launches_by["serving_int8" if quant else "serving"] = counts
        traced_by["serving_int8" if quant else "serving"] = \
            serving[quant]["traced_run"]["kernels"]
        logits[quant] = phase_paths_agree(engine, dev)
        serving[quant]["profile"] = phase_device_share(engine)
        if quant:
            serving[quant]["codec"] = phase_codec_cost(engine, flush)
        del engine
        torch.cuda.empty_cache()
    tier = max((a - b).abs().max().item()
               for a, b in zip(logits[True], logits[False]))
    side = {k: {"bf16": serving[False][k], "int8": serving[True][k]}
            for k in ("tokens_per_s", "decode_round_ms_mean", "ttft_p50_ms",
                      "ttft_p99_ms", "tpot_p50_ms", "cache_bytes")}
    side["int8_vs_bf16_max_logit_diff"] = tier
    _log("serving, bf16 vs int8 KV cache: " + json.dumps(side))
    if not serving[True]["cache_bytes"] < serving[False]["cache_bytes"]:
        raise AssertionError("the int8 cache is not smaller")
    mark("serving")
    # the decode program's variants: eager and graphed K = 1, graphed K = 4,
    # greedy and sampled, over bf16 and int8 pages, in turns
    torch.cuda.empty_cache()
    variants = phase_serving_variants(dev)
    mark("serving variants")
    graphed = {key: {m: runs["graphed K=1"][m] / runs["eager K=1"][m]
                     for m in ("tokens_per_s", "decode_round_ms")}
               for key, runs in variants["variants"].items()}
    _log("graphed K=1 over eager K=1 (tokens/s, decode-round ms): "
         + json.dumps(graphed))
    # int8 weights on the graphed bf16-KV engine, against bf16 weights, in
    # turns: K23 49 times a decode step
    torch.cuda.empty_cache()
    weight_quant = phase_weight_quant_serving(dev)
    launches_by["serving_weight_quant"] = weight_quant["launches"]
    traced_by["serving_weight_quant"] = {
        "qmatmul": weight_quant["window"]["int8 weights"]["traced_k23"]}
    mark("serving, int8 weights")
    # PyTorch keeps a cuBLAS workspace for every stream a matmul ran on, and
    # each graphed engine captured on a stream of its own: release them, so
    # that the training windows' peak memory is their own
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        _log("this PyTorch cannot release its cuBLAS workspaces: the "
             "training windows' peak memory includes the serving engines'")
    else:
        clear()
    del flush, logits
    torch.cuda.empty_cache()
    mark("serving, int8 weights")

    # the materialized head, then the fused one (this slice's main path),
    # each window on its own so that its peak memory is its own
    windows = {}
    for fused in (False, True):
        state, counts, windows[fused] = phase_training(dev, smi, fused)
        launches_by["training_fused" if fused else "training"] = counts
        phase_training_overflow(state)
        windows[fused]["profile"] = phase_training_profile(state)
        del state
        torch.cuda.empty_cache()
    side = {k: {head: windows[fused][k] for head, fused in
                (("materialized", False), ("fused", True))}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log("training, materialized vs fused LM head: " + json.dumps(side))
    if not side["peak_mem_gb"]["fused"] < side["peak_mem_gb"]["materialized"]:
        raise AssertionError(f"the fused head's step does not use less "
                             f"memory: {side['peak_mem_gb']}")
    # the fused head trained by pretrain.py's LAMB (K12, K13, K15)
    state, counts, lamb_window = phase_training(dev, smi, True,
                                                optimizer="lamb")
    launches_by["training_lamb"] = counts
    phase_training_overflow(state)
    lamb_window["profile"] = phase_training_profile(state)
    del state
    torch.cuda.empty_cache()
    side = {k: {"adam": windows[True][k], "lamb": lamb_window[k]}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log("training, fused head, Adam vs LAMB: " + json.dumps(side))

    # GPT-2's published dropout (0.1) with the materialized head, then the
    # same with full recompute: each window on its own
    drop_windows = {}
    for recompute in ("none", "full"):
        key = "training_dropout" + ("_recompute" if recompute != "none"
                                    else "")
        state, counts, drop_windows[recompute] = phase_training(
            dev, smi, False, dropout=True, recompute=recompute)
        launches_by[key] = counts
        if recompute == "none":
            phase_training_overflow(state)
        drop_windows[recompute]["profile"] = phase_training_profile(state)
        del state
        torch.cuda.empty_cache()
    side = {k: {"no dropout": windows[False][k],
                "dropout": drop_windows["none"][k],
                "dropout + full recompute": drop_windows["full"][k]}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log("training, materialized head, without and with dropout, and with "
         "full recompute: " + json.dumps(side))
    mark("training windows: GPT-2-small")
    if not (side["peak_mem_gb"]["dropout + full recompute"]
            < side["peak_mem_gb"]["dropout"]):
        raise AssertionError(f"full recompute does not lower the peak "
                             f"memory: {side['peak_mem_gb']}")

    # the scores path (profile_gpt.py row 10): the same recipe with
    # fused_attention_dropout=False, K10/K11 between cuBLAS batched matmuls
    state, counts, scores_window = phase_training(
        dev, smi, False, dropout=True, scores=True)
    launches_by["training_scores"] = counts
    scores_window["profile"] = phase_training_profile(state)
    del state
    torch.cuda.empty_cache()
    side = {k: {"in-kernel dropout": drop_windows["none"][k],
                "scores path": scores_window[k]}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log("training with dropout 0.1, in-kernel route vs scores path: "
         + json.dumps(side))

    # BERT-large trained by FusedLAMB: window A (the scores path, K10's
    # mask mode), window B (padded, dropout 0.1: the segment-id route)
    bert = {}
    for window in ("A", "B"):
        launches_by[f"bert_large_{window.lower()}"], bert[window] = \
            phase_bert_training(dev, smi, window)
    side = {k: {w: bert[w][k] for w in bert}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log("BERT-large, window A vs window B: " + json.dumps(side))
    bert_agree = {w: phase_bert_paths_agree(dev, w) for w in bert}
    _log("BERT-large checks: " + json.dumps({"mask": bert_mask,
                                             "paths_agree": bert_agree}))
    mark("training windows: scores path, BERT-large")

    phase_training_paths_agree(dev, fused=False)
    phase_training_paths_agree(dev, fused=True)
    phase_training_paths_agree(dev, fused=False, dropout=True)
    phase_training_paths_agree(dev, fused=False, dropout=True, scores=True)
    phase_fused_vs_materialized(dev)
    phase_optimizer_paths_agree(dev)
    torch.cuda.empty_cache()
    phase_optimizer_region(dev)
    torch.cuda.empty_cache()
    recompute_agree = phase_recompute_agree(dev)
    _log("dropout checks: " + json.dumps({"mask": mask_check,
                                          "recompute": recompute_agree}))
    mark("paths agree")

    # ResNet-50 (BASELINE configs 1-2): R-O2 and R-O1 at b = 256, kernel vs
    # plain path and K16 bit for bit, then R-DDP at world 2
    torch.cuda.empty_cache()
    resnet = {}
    for level in ("O2", "O1"):
        t0 = time.perf_counter()
        launches_by[f"resnet_{level.lower()}"], resnet[level] = \
            phase_resnet_training(dev, smi, level)
        resnet_s[f"R-{level}"] = time.perf_counter() - t0
    side = {k: {level: resnet[level][k] for level in resnet}
            for k in ("step_ms", "images_per_s", "mfu", "peak_mem_gb")}
    _log("ResNet-50, R-O2 vs R-O1: " + json.dumps(side))
    t0 = time.perf_counter()
    resnet_agree = phase_resnet_paths_agree(dev)
    resnet_s["paths agree"] = time.perf_counter() - t0
    for row in rows:
        if row["name"] == "multi_tensor_sgd":
            row["bitwise_steps"] = resnet_agree["k16_steps"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resnet_ddp = phase_resnet_ddp(dev, smi)
    resnet_s["R-DDP"] = time.perf_counter() - t0
    launches_by["resnet_ddp_int8"] = resnet_ddp["int8"][0]["launches"]
    _log(f"ResNet phases' seconds: {json.dumps(resnet_s)}, in all "
         f"{sum(resnet_s.values()):.1f} s (given ~120 s)")
    _log("ResNet-50 checks: " + json.dumps({
        "paths_agree": {k: v for k, v in resnet_agree.items()
                        if k != "k16_steps"},
        "ddp_bit_equal": all(s["ranks_bit_equal"] for r in resnet_ddp["ranks"]
                             for s in r["steps"]),
        "batch_norm_held_worst": {
            **{f"R-{level}": resnet[level]["batch_norm_held"]["worst"]
               for level in resnet},
            **{f"R-DDP rank {r['rank']}": r["batch_norm_held"]["worst"]
               for r in resnet_ddp["ranks"]}}}))

    mark("ResNet-50, R-DDP and R-DDP-int8")
    # DCGAN (BASELINE config 5) at the upstream defaults under O1 and O2,
    # then the ImageNet example's --resume
    torch.cuda.empty_cache()
    dcgan = {}
    for level in ("O1", "O2"):
        launches_by[f"dcgan_{level.lower()}"], dcgan[level] = phase_dcgan(
            dev, smi, level)
    side = {k: {level: dcgan[level][k] for level in dcgan}
            for k in ("step_ms", "images_per_s", "peak_mem_gb")}
    _log("DCGAN, O1 vs O2: " + json.dumps(side))
    mark("DCGAN")
    phase_imagenet_resume(dev)
    torch.cuda.empty_cache()
    mark("ImageNet --resume")
    # GPT-3 2.7B's widths (head dim 80: the attention kernels zero-pad it
    # to 128), serving and a training step, kernel vs plain
    torch.cuda.empty_cache()
    (launches_by["gpt3_2p7b_serving"], launches_by["gpt3_2p7b_training"],
     _) = phase_gpt3_2p7b(dev)

    # GPT-J-6B's attention widths (heads of 256: K1, K5/K6 and K1d, K5d/K6d
    # at their D = 256 bodies), then heads of 320 (past the kernels: K10/K11
    # in training and K10, K2 in serving)
    torch.cuda.empty_cache()
    gptj, _ = phase_gptj_6b(dev)
    launches_by["gptj_6b_training"] = gptj["no_dropout"]
    launches_by["gptj_6b_training_dropout"] = gptj["dropout"]
    torch.cuda.empty_cache()
    hd320, _ = phase_head_dim_320(dev)
    for key, counts in hd320.items():
        launches_by["head_dim_320_" + key] = counts
    # heads of 576, past the decode kernels: serving on the scores route
    torch.cuda.empty_cache()
    launches_by["head_dim_576_serving"], _ = phase_head_dim_576(dev)

    # GPT-2-small at tensor-parallel size 2 on the vocab-sharded fused
    # head, in two ranks
    torch.cuda.empty_cache()
    launches_by["training_tp2"], tp2 = phase_training_tp2(dev, smi)
    side = {k: {"tp=1 fused head": windows[True][k],
                **{f"tp=2 rank {w['rank']}": w[k] for w in tp2["ranks"]}}
            for k in ("step_ms", "tokens_per_s", "mfu", "peak_mem_gb")}
    _log(f"training, tp=1 vs tp=2 ({tp2['backend']}): " + json.dumps(side))
    mark("wide windows, tp = 2")

    # this slice's main path: BERT-large at data-parallel world 2 on
    # DistributedFusedLAMB (Z-BERT), GPT-2-small on DistributedFusedAdam
    # against DDP + FusedAdam (Z-GPT), the (2, 2) hierarchical reduction
    # (HIER), LARC(FusedSGD) on ResNet-50 (LARC)
    torch.cuda.empty_cache()
    zero_launches, zero = phase_zero(dev, smi)
    launches_by.update(zero_launches)
    mark("Z-BERT, Z-GPT")
    torch.cuda.empty_cache()
    launches_by["hier"], hier = phase_hier(dev, smi)
    mark("HIER")
    torch.cuda.empty_cache()
    launches_by["larc"], larc_stats = phase_larc(dev, smi)
    mark("LARC")
    side = {c: {k: [r[k] if k != "steps" else [s["ms"] for s in r[k]]
                    for r in zero["bert"][c]]
                for k in ("steps", "peak_mem_gb", "collectives")}
            for c in zero["bert"]}
    _log(f"Z-BERT ({zero['backend']}), codec off and int8: "
         + json.dumps(side))

    for row in rows:
        name = row["name"]
        by_path = {path: counts[name] for path, counts in launches_by.items()
                   if name in counts}
        # the kernel's own path: the int8 serving run for K2q, the scores
        # window for K10/K11, the generic softmax over 8192 keys for
        # K10L/K11L, the tp = 2 window for K7p, the dropout training window
        # for the dropout variants, the fused training window for the other
        # training kernels; K2 runs only in serving
        main = {"decode_attention_quant": "serving_int8",
                "softmax_fwd": "training_scores",
                "softmax_bwd": "training_scores",
                "softmax_fwd_long": "generic_softmax_long",
                "softmax_bwd_long": "generic_softmax_long",
                "xent_fwd_partials": "training_tp2",
                "multi_tensor_l2norm": "training_lamb",
                "multi_tensor_lamb": "training_lamb",
                "multi_tensor_sgd": "resnet_o2",
                "batch_norm_fwd": "resnet_o2",
                "batch_norm_bwd": "resnet_o2",
                "collectives_quantize": "zero_bert",
                "collectives_dequantize_sum": "zero_bert",
                "multi_tensor_zero_lamb": "zero_bert",
                "multi_tensor_zero_adam": "zero_gpt",
                "qmatmul": "serving_weight_quant"}.get(
            name, "training_dropout" if name.endswith("_dropout")
            else "training_fused")
        row["launches"] = by_path.get(main, by_path.get("serving", 0))
        row["launches_by_path"] = by_path
        # the kernels the device ran in the traced rerun of a serving
        # trace, counted by name (a graphed decode program's replays call
        # no wrapper)
        traced = {path: counts[name] for path, counts in traced_by.items()
                  if counts.get(name)}
        if traced:
            row["device_launches_by_path"] = traced
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never ran on the main path")
        row["card"] = smi
        if sass and name.startswith(("attention_bwd_", "prefill_attention")):
            kernel = name.replace("_dropout", "") + "_tc d=64"
            row["tensor_core_sass"] = sass[
                kernel + (" dropout" if name.endswith("_dropout") else "")]
        elif sass and name in ("xent_fwd", "xent_fwd_partials"):
            row["tensor_core_sass"] = sass["xent_fwd_tc"]
        elif sass and name in ("xent_bwd_dx", "xent_bwd_de"):
            row["tensor_core_sass"] = sass[
                f"xent_bwd_tc {'dX' if name.endswith('dx') else 'dE'} b=32"]
        _log(json.dumps(row))
    mark("report")
    _log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    _log(f"smoke wall: {time.perf_counter() - t_start:.1f} s, build "
         f"{build_s:.1f} s")
    _log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
