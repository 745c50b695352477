#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and only the port.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises, exit code != 0):

  1. device: the card's name and power limit (nvidia-smi) — raises without
     CUDA;
  2. build: compiles every kernel from the sources in this checkout (one
     nvcc per source, all started together, sm_90a: flash_fwd, flash_fwd_tc,
     flash_fwd_tf32x3, flash_bwd, flash_bwd_tc, flash_bwd_tc128,
     flash_bwd_tf32x3, dynamic_conv, dynamic_conv_tc, flash_fwd_single) and
     reports the seconds and the ptxas registers and spills of each; the
     sources of the D 128 tensor-core kernels (flash_fwd_tc, the bf16
     forward; flash_fwd_tf32x3, the fp32 forward; flash_bwd_tc128, the bf16
     pair; flash_bwd_tf32x3, the fp32 pair) must spill nothing in any
     kernel (asserted);
  3. kernels at the serving shapes (those of the one-phase requests, and
     the two-phase request's auxiliary pass: bh 640, T 101, causal
     self-attention and cross-attention over 128 keys): the flash forward
     against its plain PyTorch version in fp32 (TF32 off: the tf32x3 kernel, which serving
     runs, and the CUDA-core kernel launched directly) and bf16 (the
     tensor-core kernel at kernel D 32 and 64), with kernel, plain and
     library (scaled_dot_product_attention, a yardstick the port never
     calls: the fastest of its fused backends, flash, memory-efficient
     and cuDNN, each timed alone and named, never its math fallback) times
     per call (CUDA events), the kernel's own device time (torch.profiler),
     and the card's bound for the same work;
  4. kernels at the training shapes (the train step's four attention
     calls at batch 128, the dual-decoder step's two auxiliary-decoder
     calls at batch 128, the lightconv decoder's encoder attention at
     batch 64 with keys padded on the left, the iwslt presets' at D 128
     (bh 256, T = S = 56, keys padded on the left), the long-context
     step's two at S 2048, a ragged call and a causal one with T > S), in
     fp32 and bf16, one bf16 call at D 16, one call at bh 70,000 (T 16,
     D 128, both types: past the 65,535 of a grid's y dimension, which no
     kernel caps bh at any more), and in both types the iwslt call at rate
     0 and a long D 128 call (``d128_long``: bh 32, T = S = 2048, padded
     keys, rate 0.1): the forward's dropout keep mask (at a rate above 0)
     against ``philox.keep_mask`` (exactly: probed through the CUDA-core
     kernel in fp32, the tf32x3 kernel at D 128, 64 and 32, and the bf16
     tensor-core kernel at D 128, 64 and 32, each launched directly), the
     forward at the training dropout rate (on the tensor cores at D 32, 64
     and 128: "tc" in bf16, "tf32x3" in fp32, their D 128 launches counted
     as ``flash_fwd_tc128`` and ``flash_fwd_tf32x3_128``; on the CUDA cores
     at D 16),
     and the fused backward and the split pair of the call's route (the
     same tensor-core routes, and at D 128 the D 128 tensor-core pair of
     the type: ``flash_bwd_tc128.cu`` in bf16, ``flash_bwd_tf32x3.cu`` in
     fp32, counted as ``*_tf32x3_128``; the CUDA cores at D 16), and in fp32 at D 32 and 64
     the CUDA-core forward and pair, at D 128 the CUDA-core pair and
     forward, launched directly, against the plain
     versions on the same inputs and
     seed, with the same times and bounds (the library time of a backward
     is SDPA's forward + backward at rate 0; at the iwslt call and
     ``d128_long`` SDPA's device time too, the forward and the backward
     apart, each call's kernels summed in a trace, on the fused backend
     fastest by that time, since its wall time at the iwslt call is
     host-bound); then, at the long D 64 call in each type, the tensor-core
     pair's dq, dk, dv again, and at the iwslt D 128 call (rates 0.1 and
     0) the default pair's (the D 128 tensor-core pair of each type)
     and the fused kernel's, each bitwise equal to its first (asserted); at every D 128 call of each type the D 128 tensor-core pair at
     most the CUDA-core pair's device time, the sum of dq's and dkv's median
     launches (``d128_pair_wins``: ``tc128_pair_wins`` in bf16,
     ``tf32x3_128_pair_wins`` in fp32, asserted), and the D 128
     tensor-core forward's median launch at most the CUDA-core forward's
     (``d128_fwd_wins``: ``tc128_fwd_wins`` in bf16, ``tf32x3_fwd_wins``
     in fp32, asserted), beside the fused kernel's, SDPA's, the plain time
     and the bound;
  5. dynamic-conv kernels: the tensor-core ``dynamic_conv_fwd_tc`` and
     ``dynamic_conv_bwd_tc`` (every model path's) and the first, CUDA-core
     ``dynamic_conv_fwd`` and ``dynamic_conv_bwd`` (launched directly,
     ``route="cuda_core"``) against ``dynamic_conv_reference`` /
     ``dynamic_conv_backward_reference`` in fp32 (TF32 off) and bf16 at the
     serving shapes (B 32, T 60, C 1024, H 16, centred K 3, 7, 15, 31; B 8,
     T 250, K 31), the training shapes (B 64, T 56, every K of 3, 7, 15, 31
     centred and causal), a ragged one (T 37, C 48, H 3, even K 4) and
     ``dynamicconv_iwslt_de_en``'s widths (C 512, H 4, K 31, centred and
     causal), with the wrapper's, the kernel's device (median launch), the
     plain and the bound times (no single PyTorch call computes a
     per-position band product, so no library time), the bf16
     ``train_k31`` rows also with a cold L2 (128 MB written between
     launches); the tensor-core backward bitwise equal across two launches
     (asserted); and ``dconv_tc_wins_everywhere``: the tensor-core forward's
     and backward's median launch each at most the CUDA-core one's at each
     of the 13 main-path calls in both types, the two routes' launches
     interleaved in one trace, 60 of each, of which the trace must keep at
     least half (asserted);
  6. serve (main path 1): the conv_transformer base preset at full width
     (256/768/4, 6+6 layers, 80 mels, vocabulary 8000, random weights from
     a seed) serves three requests with beam 5 through
     ``SequenceGenerator``; checks the hypotheses and the forward launches
     per request, times the encoder, profiles one request, and holds the
     flash route against the dense route and the card against the plain
     CPU path; exactly 8 tf32x3 forwards a request (serving is fp32) and
     no other kernel;
  7. train (main path 2): the ``bench.py::_measure_train`` configuration
     (label-smoothed CE 0.1, Adam (0.9, 0.98), lr 2e-3 inverse_sqrt over
     4000 warmup updates, clip-norm 10, --bf16) at full width on a fixed
     batch of 128 utterances of 409-512 frames and 48 target tokens:
     3 warm-up steps, then 20 timed steps 3 times; step ms, frames/s and
     MFU; exactly 20 tensor-core flash forward launches a step and no
     CUDA-core one (``BF16_FORWARD``), 20 + 20 tensor-core dq + dkv and no
     fused or CUDA-core backward (``BF16_BACKWARD``); the
     loss finite and falling; one profiled step; then short runs with
     each bf16 backward forced (fused, the pair) and the fp32 step by its
     rule (20 tf32x3 forwards, 20 + 20 tf32x3 dq + dkv), their launches
     exact, and one profiled fp32 step;
  8. train-step cross-checks in fp32 (TF32 off): flash against dense
     route and fused against the tf32x3 pair (training mode, every dropout
     rate 0 but the frontend's forced 0.1, drawn alike on both sides),
     their launches exact (20 tf32x3 forwards and 20 + 20 tf32x3 dq + dkv;
     none; 20 tf32x3 forwards and 20 fused), and card against the plain
     CPU path on 2 utterances (eval-mode criterion), and the card's dense
     route against the CPU as the floor of the two;
  9. serve (main path 3): ``dynamicconv_wmt_en_de_big`` at full width
     (1024/4096/16, conv_dim 1024, GLU, 7 + 6 layers, K = 3, 7, 15, 31...,
     source and target dictionaries of 32,768 symbols, random weights from
     a seed) serves three requests (32 sentences of 10-60 tokens, 8 of
     200-250, 1 of 30) collated by the port's ``LanguagePairDataset``
     (sources padded on the left), beam 5; checks the hypotheses and
     exactly 7 ``dynamic_conv_fwd_tc`` launches a request and no other
     kernel (no flash, no CUDA-core dynamic conv), source
     tokens/s, the idle share of one profiled request, the kernel route
     against the plain route on every request (fp32 encoder output and
     teacher-forced logits, and identical top hypotheses) and the card
     against the CPU on 2 sentences;
 10. train (main path 4): ``TranslationTask.build_model`` ->
     ``Trainer.train_step`` with the arguments of phase 7 and ``--bf16`` on
     one batch of 64 pairs of 40-56 source and 40-56 target tokens: step
     ms, target tokens/s, MFU, peak memory, one profiled step; exactly 13
     ``dynamic_conv_fwd_tc``, 13 ``dynamic_conv_bwd_tc``, 6 tensor-core
     flash forward and 6 + 6 tensor-core dq + dkv a step, and 0 CUDA-core
     dynamic conv; the loss finite and falling;
 11. lightconv train-step cross-checks in fp32: the kernel route against
     the plain route of the dynamic conv (training mode, dropout rates 0),
     and the card against the plain CPU path on 2 pairs (eval-mode
     criterion);
 12. the single-pass kernels: ``flash_fwd_single`` against
     ``flash_fwd_single_reference`` in fp32 (TF32 off, the CUDA-core
     kernel at t_block 8 and 16) and bf16 (the tensor-core kernel at
     t_block 64 and 128) at the sweep's shapes (bh 32, S 2048, not causal;
     bh 64, S 2048, causal) and a ragged case (bh 4, T 300, S 333, keys
     padded), and in bf16 a long ragged row (bh 2, T 700, S 8192, padded)
     past the fp32 kernel's shared memory, with the wrapper's, the device,
     the plain, the SDPA and the bound times; then the refusals: D 32 in
     both types, S 3308 at t_block 16 in fp32 and t_block 16 in bf16; then
     past the 65,535 of a grid's y dimension, which neither kernel caps its
     rows at any more: the single pass at bh 70,000 x T 16 x S 128 (fp32 and
     bf16, each t_block) and the CUDA-core dynamic conv at B 70,000 x T 16
     x C 64 x H 4 x K 3 (forward and backward, fp32 and bf16), each against
     its plain version at this phase's and phase 5's tolerances (the single
     pass's bf16 out element by element within two bf16 ulps, not one);
 13. the flash sweep (main path 5, the one path that runs the single-pass
     kernel): ``scripts/bench_flash_sweep.run`` in full, its rows and the
     inputs of the gate, forward and backward decisions in bf16 and fp32
     (the fused kernel's and the tensor-core pair's device time at each of
     the model path's backward calls, the CUDA-core pair's beside them, the
     CUDA-core and the tensor-core forward's at each of its attention
     calls, and whether the tensor-core kernels win there: they must win at
     every call they serve, in both types, asserted; at the iwslt call
     (D 128) the tensor-core pair of each type against the fused kernel
     and the CUDA-core pair, and it must beat both, asserted
     (``pair_wins``, ``tf32x3_bwd_wins``, ``d128_pair_wins`` in each type),
     the tensor-core forward of each type against the CUDA-core one
     (``tc_fwd_wins``, ``tf32x3_fwd_wins``), beside SDPA's forward +
     backward);
 14. train (main path 6), the ``bench.py::_measure_ctc_flagship``
     configuration: ``conv_transformer_big`` with ``ctc_multi_loss`` over
     label-smoothed CE 0.1, CTC after encoder layer 4 with weight 0.5 and
     CTC compression, the arguments of phase 7, through
     ``SpeechTranslationCTCTask`` -> ``Trainer.train_step`` on 128
     utterances of 409-512 frames, 48 target and 64 transcript tokens
     (a 700-symbol source dictionary; the task adds ``<ctc_blank>`` after
     its symbols): step ms, frames/s, MFU, peak memory, exactly 20 flash
     forward launches and 20 + 20 tensor-core dq + dkv a step, the
     loss finite and
     falling (20 forwards on the tensor cores), the logged ``ctc_loss``
     finite, one profiled step, and the launches and device time of the
     UER's edit distance;
 15. CTC cross-checks in fp32 (TF32 off): flash against dense route at
     batch 32 (training mode, dropout rates 0) and the card against the
     plain CPU path on 2 utterances (eval-mode criterion), with the
     compressed lengths identical on both sides (asserted);
 16. train (main path 7), ``bench.py``'s ``flash_longcontext_train``: the
     base conv_transformer on 8 utterances of 6554-8192 frames (T' = 2048
     after the frontend), ``max_source_positions`` 8192, bf16: step ms,
     frames/s, MFU, peak memory, exactly 20 tensor-core flash forward
     launches and 20 + 20 tensor-core dq + dkv a step, the loss finite, one
     profiled step; then flash against dense route in fp32 at the same
     shapes (the dense route's (8, 4, 2048, 2048) scores fit the card);
 17. serve (main path 8), ``bench.py``'s ``decode_rtf_twophase``:
     ``conv_transformer_dualdecoder`` at full width (256/768/4, 6+6 layers
     and a 6-layer auxiliary decoder, 80 mels, source and target
     dictionaries of 8,000 symbols, random weights from a seed) serves a
     request of 32 x 409-512 frames and one of 1 x 512 through
     ``TwoPhaseSequenceGenerator`` (beam 5, ``max_len_b`` 100): decode
     seconds, RTF, the idle share of one profiled request; every
     hypothesis ends in eos and carries its transcript, the scores sorted;
     exactly 20 tf32x3 forwards a request (the encoder's 8 and the 12 of
     phase 2's teacher-forced ``aux_features`` pass: 6 causal self- and 6
     cross-attentions; the decode steps attend their caches on the dense
     path) and no other kernel; then the flash route against the dense
     route (identical top hypotheses and transcripts, the ``aux_features``
     of the top transcripts within 1e-3) and the card against the plain
     CPU path on 2 utterances (the same, and the teacher-forced target and
     auxiliary logits within 1e-3);
 18. serve, ``conv_transformer_triangle`` and ``conv_transformer_2stage``
     at the same width, one request of 8 x 409-512 frames each, with the
     checks of phase 17: their phase-2 caches over the transcripts' states
     (the triangle's ``aux``, the 2-stage decoder's ``cross``) follow the
     beams;
 19. train (main path 9): ``conv_transformer_dualdecoder`` with
     ``cross_entropy_dualdecoder`` (weights 0.5 / 0.5, label smoothing
     0.1) through ``SpeechTranslationDualDecodingTask.build_model`` ->
     ``Trainer.train_step``, the arguments of phase 7 and ``--bf16``, on
     128 utterances of 409-512 frames with 48 target and 64 transcript
     tokens: step ms, frames/s, MFU (``train_flops`` plus the auxiliary
     decoder), peak memory, one profiled step; exactly 32 tensor-core
     flash forwards and 32 + 32 tensor-core dq + dkv a step (the base
     step's 20 and the auxiliary decoder's 6 causal self- and 6
     cross-attentions); the loss and the logged ``auxiliary_nll_loss``
     finite and falling; then in fp32 (TF32 off) flash against dense route
     (32 tf32x3 forwards and 32 + 32 tf32x3 dq + dkv; none) at batch 32
     and the card against the CPU on 2 utterances, at phase 8's
     tolerances;
 20. train (main path 10): ``dynamicconv_iwslt_de_en`` at full width
     (512/1024/4, 7 + 6 layers, the dictionaries of phase 9) with phase
     10's arguments and batch: head dim 128, so exactly 6 D 128
     tensor-core flash forwards (counted as ``flash_fwd_tc128``) and 6 + 6 D 128
     tensor-core dq + dkv (``csrc/flash_bwd_tc128.cu``) a step, 0
     CUDA-core forwards or dq/dkv, 0 fused and 0 other tensor-core flash
     kernels, and 13 + 13 tensor-core dynamic conv; step ms, busy ms and
     idle share of one profiled step, the loss finite and falling;
 20b. train (main path 10b): the same preset and batch in fp32 (TF32 off),
     as a user trains it without ``--bf16``: exactly 6 D 128 tf32x3 flash
     forwards (``flash_fwd_tf32x3.cu``, counted as
     ``flash_fwd_tf32x3_128``) and 6 + 6 D 128 tf32x3 dq + dkv
     (``flash_bwd_tf32x3.cu``, counted as ``*_tf32x3_128``) a step, no
     CUDA-core forward and no other flash kernel, 13 + 13 tensor-core
     dynamic conv; step ms, busy ms and idle share of one profiled step
     (beside the busy ms of the step with the CUDA-core forward, 38.47 ms
     on an H100 at 700 W), the loss finite; then, at phase 8's
     tolerances, the flash route against the dense route (one step of a
     fresh model each, dropout rates 0, the flash step's launches exact);
 21. serve from files (main path 11), the README's quick start: a corpus
     of 32 utterances of 409-512 frames x 80 mels with target and
     transcript text over phase 6's dictionary, written with the port's
     builders, the base conv_transformer's seeded weights saved with
     ``save_model_checkpoint``, and ``cli/generate``'s ``cli_main`` (task
     ``speech_translation_with_transcription``, beam 5, ``max_len_b``
     100) decoding it on the card: 8 tf32x3 forwards a batch and nothing
     else; its H- lines identical to the in-memory generator's top
     hypotheses on the same batches, scores within 1e-4 (base 2); the
     CLI's wall time, the in-memory decode's RTF and the BLEU line;
 22. serve (main path 12), the search strategies on phase 21's model: a
     top-10 sampling request and a diverse-beam request (beam 4, 2
     groups) on 8 utterances, and a top-1 sampling request on 4, whose
     every hypothesis must be greedy search's; hypotheses' counts and
     shapes checked, 8 tf32x3 forwards a request;
 23. train (main path 13), ``bench.py``'s ``realistic`` section: phase 7's
     step with ``--specaugment --specaugment-rate 1.0``, then also with
     ``--time-stretch``: step ms, busy ms and idle share of one profiled
     step, the augmentation's own device ms, phase 7's launches a step,
     the losses finite, and the share of elements one SpecAugment draw
     zeroes within its expected range;
 24. train from files (main path 14), the README's quick start on the card:
     a corpus of 640 train and 64 valid utterances of 409-512 frames x 80
     mels, target text of 20-48 and transcript text of 30-64 tokens over
     phase 6's dictionary, written with the port's builders;
     ``cli/train``'s ``cli_main`` with the quick start's arguments
     (``conv_transformer``, ``ctc_multi_loss`` over label-smoothed CE 0.1,
     CTC after encoder layer 4 with compression, Adam, lr 0.002
     inverse_sqrt over 4000 warmup updates, clip-norm 10, --max-tokens
     25000, --bf16) for 2 epochs, validating and saving at each epoch's end;
     every update launches exactly phase 7's 20 tensor-core forwards and
     20 + 20 tensor-core dq + dkv, every validation batch 20 forwards, and
     nothing else; then a second save dir stopped at ``--max-update`` 5 and
     resumed from its ``checkpoint_last.pt``: the resumed run's epoch,
     update count, iterator position, lr and best equal the straight run's
     and its losses after the stop are the straight run's within 1e-3
     relative; the CLI's median update wall beside ``Trainer.train_step``'s
     on the CLI's first batch, the busy ms and idle share of one profiled
     update, validation and save seconds, checkpoint bytes; then
     ``cli/generate`` decodes the valid split from the straight run's
     ``checkpoint_best.pt``: 8 tf32x3 forwards a batch, its weights
     bitwise the trainer's when it wrote the file, its H- lines those of
     the in-memory generator on those weights (scores within 1e-4);
 25. train and serve the multitask classifier from files (main path 15),
     on phase 24's corpus: a 2-class ``gender`` label an utterance beside
     it (the port's builder); ``cli/train`` trains
     ``multitask_conv_transformer`` at full width (256/768/4, 6 + 6 layers,
     80 mels) with ``speech_translation_multitask`` and
     ``cross_entropy_multi_task`` (label smoothing 0.1, auxiliary weight
     0.5, class weights 1 2) and the quick start's optimisation in bf16
     for 3 updates: each launches exactly 20 + 20 + 20 tensor-core flash
     kernels, each validation batch 20 forwards, the loss and
     ``auxiliary_loss`` finite; then ``cli/generate_multitask_classifier``
     classifies the valid split from ``checkpoint_last.pt`` in fp32: 8
     tf32x3 forwards a batch and nothing else, one CLASS- line an
     utterance, every row of probabilities summing to 1 within 1e-4, and
     the card's probabilities within 1e-3 of the plain CPU path's on 2
     utterances;
 26. knowledge distillation from files (main path 16), phase 24's
     ``checkpoint_best.pt`` as the teacher: ``cli/generate_topk
     --distill-topk 8`` on the train and valid splits in fp32, 20 tf32x3
     forwards a batch and nothing else, the files read back with one
     (T, 8) item an utterance; the card's top-8 against the plain CPU
     path's on 2 utterances (logits within 1e-3, the same index at every
     rank more than max(1e-4, twice the logits' difference) above the next);
     then ``cli/train`` trains the student (``conv_transformer``,
     ``speech_translation_with_transcription_kd``,
     ``knowledge_distillation`` at lambda 0.5 and temperature 2) in bf16
     for 3 updates, each launching 20 + 20 + 20 tensor-core kernels, the
     loss finite;
 27. multilingual ST from files (main path 17), on phase 24's corpus with
     a second target language (``nl``): ``cli/train`` trains
     ``multilingual_conv_transformer`` at full width on ``en-de`` and
     ``en-nl`` over one shared encoder (the target's language vector
     prepended as a frame, its token as bos), bf16, 3 updates under
     ``concat`` and 1 under ``sum``, each update launching 40 + 40 + 40
     tensor-core kernels (each pair's 20) and each validation batch 40
     forwards, each pair's loss logged; then ``cli/generate -s en -t de``
     and ``-t nl`` on the ``concat`` run's checkpoint in fp32, 8 tf32x3
     forwards a batch and nothing else, the H- lines equal to the
     in-memory generator's through the pair view, and the card's logits
     within 1e-3 of the plain CPU path's on 2 utterances;
 28. ``cli/generate_dualdecoder`` from files (main path 18): ``cli/train``
     trains ``conv_transformer_dualdecoder`` at full width on phase 24's
     corpus (``cross_entropy_dualdecoder`` 0.5 / 0.5), bf16, 2 updates of
     32 + 32 + 32 tensor-core kernels; ``cli/generate_dualdecoder``
     decodes the valid split in fp32 in batches of 32, 20 tf32x3 forwards
     a batch and nothing else, an AUX- and an AUXD- line for every H- line,
     the H- and AUX- lines equal to the in-memory two-phase generator's;
 29. context-aware ST from files (main path 19), on phase 24's corpus
     with its context files (``{split}.context.de``: line i the target of
     line i-1, line 0 ``</s>``; ``{split}.context.npz``: utterance i-1's
     frames, utterance 0 zeros of its own length; the port's builders):
     ``cli/train`` trains ``conv_transformer_context`` at full width
     (256/768/4, 6 + 6 layers, 80 mels, one context layer) from phase 24's
     ``checkpoint_best.pt`` (``--pretrained-model``, ``--freeze-pretrained
     encoder``, weight decay 0.01, ``label_smoothed_cross_entropy_ctxreg``
     alpha 0.3), bf16: ``tgt`` context with parallel gating for 3
     updates of 33 tensor-core forwards and 30 pairs each, ``src`` with
     sequential gating for 2 updates of 41 forwards and 30 pairs; every
     frozen parameter bitwise the checkpoint's after them, every trainable
     one moved, the encoder's BatchNorm statistics moved, the gate penalty
     above 0; then ``cli/generate`` in fp32, beam 5: the ``tgt`` model
     over 8 single-utterance requests chained in corpus order (15 tf32x3
     forwards each, each context the previous best hypothesis, the H-
     lines the in-memory chained generator's), the ``src`` model over the
     valid split in batches of 32 (23 forwards each); the card's logits
     within 1e-3 of the CPU's on 2 utterances for each; the update's and
     request's times, busy time and idle share; first, the flash route on
     rows with every key masked (a shape bucket's padding rows, which the
     ctxreg penalty sends a gradient) against its plain version in both
     types, every value finite;
 30. from raw files to the FBK papers' scores (main path 20), on phase
     24's corpus and save dir and phase 9's model: phase 24's valid split
     written out as a user's raw files (an npz stream of its filterbanks,
     its target and transcript lines) and brought back by
     ``cli/preprocess_audio`` and ``cli/preprocess`` (``--tgtdict`` phase
     24's dictionary, ``--dataset-impl cached``): every file byte for byte
     phase 24's and the task's items equal; ``scripts/resegment_data_mustc``
     on a segmentation of 16 utterances each cut in two, read by ``yaml``
     where it is installed and by the fallback parser: each pair of new
     lines rejoins to its original, word for word, and the parsers agree;
     ``cli/average_checkpoints
     --num-epoch-checkpoints 2``: every float tensor bitwise the float64
     mean of ``checkpoint1.pt`` and ``checkpoint2.pt``; ``cli/generate`` of
     the average in fp32, beam 5: 8 tf32x3 forwards a batch and nothing
     else; ``cli/generate --score-reference``: 20 tf32x3 forwards a batch
     and nothing else, the P- and H- scores within 1e-4 of the in-memory
     ``SequenceScorer`` on the card, within 1e-3 of the CPU's on 2
     utterances, each H- score its P- scores' mean; ``cli/score`` on the D-
     lines: ``cli/generate``'s BLEU line exactly, and 100 on the
     references; the FBK evaluation scripts (MuST-SHE accuracy, the word
     and agreement full tables with their aggregates under the bundled
     configs, NE/terminology accuracy) on the D- lines (every table well
     formed: one row a term, a group or a metric, the system's columns) and
     on the references (every score 1.0), ``combine_ne_terms`` on two IOB
     streams; then ``cli/interactive`` (``--buffer-size 8 --max-sentences
     8``, beam 5) serving 32 lines of 10-60 tokens from phase 9's
     ``dynamicconv_wmt_en_de_big`` saved by ``save_model_checkpoint``: 7
     ``dynamic_conv_fwd_tc`` a batch and nothing else, one S- and one H-
     line a line, the H- lines the in-memory generator's on the same
     batches (scores within 1e-4); the CLIs' walls, the busy ms and idle
     share of one scorer batch and one interactive batch, the phase's
     seconds;
 31. the rest of the wiring from files (main path 21, ``wiring_from_files``):
     the JSON audio route trained with sharded asynchronous checkpoints and
     resumed bitwise, alignments, sharded and pruned decoding, the
     fork-checkpoint CLIs, the codecs (``--bpe gpt2`` held to the CPU
     test's ids, ``GPT2_IDS``) and ``--user-dir``;
 32. the fork's ASR side from files (main path 22, ``asr_from_files``), on
     phase 31's JSON corpus: ``vggtransformer_base`` with
     ``cross_entropy_acc`` (3 updates, bf16, 24 tensor-core forwards and
     pairs an update) decoded by ``cli/infer`` with beam 5 in fp32 (12
     tf32x3 forwards a batch); ``vggtransformer_enc_1`` with ``ctc_loss``
     (2 updates, 16 an update) decoded greedily and by the lexicon beam
     with a 3-gram ARPA LM (16 a batch); ``w2l_conv_glu_enc`` with
     ``asg_loss`` (2 updates, no attention) decoded by ASG Viterbi and the
     ASG beam; each decode against ``cli/infer --cpu`` on the same
     checkpoint, and each leg's peak memory;
 33. multi-GPU, on phase 24's corpus: (a) the ring attention's kernel route
     in one process, N = 2 and 4 shards of the long-context call (bh 32,
     T = S = 2048, D 64, ragged key padding), fp32 and bf16, causal and
     not, against the plain dense attention at phase 4's tolerances, each
     run's launches exactly N^2 (causal N(N+1)/2) forwards, dq and dkv; (b)
     the quick start at full width through the distributed launcher over
     NCCL (world size ``torch.cuda.device_count()``, dropout 0, 3 updates;
     20 + 20 + 20 tensor-core launches a rank an update), its losses within
     1e-3 relative of the plain ``cli/train``'s, the largest parameter
     difference and bitwise equality printed; (c) the spawning launcher
     with ``--fsdp`` and with ``--use-bmuf``: finite losses, FSDP's the
     plain run's; with two cards or more, world size 2 (1e-2 relative),
     TP 2 with sequence parallelism and ring attention at TP 2; the NCCL
     version, the peak GB a rank and the phase's seconds;
 34. the text transformer family from files (``text_transformer_from_files``),
     on corpora binarized by ``cli/preprocess``: (a)
     ``transformer_vaswani_wmt_en_de_big`` at full width with
     ``--share-all-embeddings`` over a joined 32,768-symbol dictionary,
     trained by ``cli/train`` (bf16, 3 updates of ``--max-tokens 3584``:
     18 tensor-core forwards, dq and dkv an update), decoded by
     ``cli/generate`` (fp32, beam 5, 32 sentences a batch: 6 tf32x3
     forwards a batch) with its H- lines the in-memory generator's, scored
     with ``--score-reference`` (18 a batch), then
     ``transformer_wmt_en_de_big_align`` with ``--load-alignments`` (2
     updates, 27 an update); (b) ``transformer_lm_wiki103`` at full width
     (D 128, adaptive input and softmax tied over 267,744 symbols) trained
     on 3072-token blocks (bf16, 3 updates: 16 D 128 tensor-core forwards,
     dq and dkv an update; the tied tables one storage after them), then
     ``cli/eval_lm --context-window 2560`` (fp32, 16 D 128 tf32x3 forwards
     a window) within 1e-4 of the in-memory scorer and, on a 512-token
     window, within 1e-3 of ``--cpu``; (c) ``transformer_lm_gbw
     --character-embeddings`` (D 32) scored by one ``cli/eval_lm`` batch (12
     tf32x3 forwards), card against ``--cpu`` within 1e-3; each leg's
     update or batch seconds, device busy and idle share, peak GB; the
     wiki103 call (bh 8, T = S = 3072, D 128, causal) timed in both types as
     phase 4 times a call;
 35. the ``kernels`` line (the D 128 tensor-core kernels timed at the
     iwslt call and at ``d128_long`` in their type; the CUDA-core dynamic-conv kernels with 0
     main-path launches, marked as reached by a direct call only), the card
     line, and the final ``ok`` line.

Tolerances (stated here, checked below):
  * kernels against their plain versions: atol 1e-4 in fp32 (the same
    sums in another order; the tf32x3 kernels' three tf32 products a
    product leave about 2^-21 of |a||b| each, where one tf32 product would
    miss 1e-4, tests/test_torch_tf32x3.py); in bf16 2e-2 for out (one bf16 rounding of
    |out| < 4); lse 1e-4 (fp32 in both types); the keep mask exactly (the
    probe's 0/1 test within 1e-3 in fp32 and 2^-8 in bf16, where only the
    output's final rounding, 2^-9 of it, differs); the
    flash dq, dk and dv in bf16 each within 1e-2 of its own max|plain|
    (one bf16 rounding of the output, 2^-8 of it at most, with ds and w_v
    rounded to bf16 alike on both sides; the fused kernel keeps them in
    fp32, which moves a sum of S terms by about 2^-9 of it): at S = 2048
    every gradient is a sum of ~2048 terms of weight ~1/2048 and typically
    0.02-0.04, so the 5e-2 atol it replaces passed a kernel that returned
    zeros, and a zero gradient now misses by its whole max; the single-pass
    kernel's bf16 out
    besides element by element within 1e-3 + 8e-3 |plain| (one bf16 ulp of
    the plain value, 2^-7 of it at most, and P rounded alike on both
    sides): at S = 2048 a typical |out| is about 0.03, so 2e-2 alone would
    pass a dropped key chunk;
  * dynamic conv against its plain version, both routes: out and dx at
    atol 1e-4 in fp32 (the tensor-core kernels' 3xTF32 products leave
    about 2^-21 of |a||b| each; one TF32 product misses dw's limit,
    tests/test_torch_dynamic_conv_tc.py), in bf16 out at 2e-2 and dx at
    5e-2 (out and dx are sums of K products, convex in x for out, with
    |out|, |dx| < 5: one bf16 rounding); dw, a sum of C/H = 64 products
    that reaches |dw| ~ 40, at 1e-5 (fp32) and 1e-2 (bf16, one rounding at
    2^-8) of max|dw|;
  * ``cli/generate`` and ``cli/interactive`` against the in-memory
    generator, and ``cli/generate --score-reference`` against the in-memory
    scorer, on the same batches and weights: the same hypotheses, scores
    within 1e-4 (the same kernels on the same inputs; a P- value is printed
    at 4 decimals, 5e-5 of rounding);
  * ``cli/train`` resumed against the straight run: the losses after the
    stop within 1e-3 relative (bf16 compute, and ``F.ctc_loss``'s CUDA
    backward sums with atomics, so two runs of the same update may part in
    their last bits), the best valid loss within the same, and the epoch,
    update count, iterator position and lr equal;
  * the serving models, flash vs dense, kernel vs plain route and card vs
    CPU: atol 1e-3 in fp32 (8 attention or 13 conv layers summed in
    another order; two-phase: the auxiliary decoder's states and the
    teacher-forced logits after 6 more layers), and the top hypotheses
    (two-phase: and their transcripts) identical;
  * train-step cross-checks: the loss rtol 1e-5 (the same forward in fp32);
    gnorm and the gradients' global relative difference 5e-3 where the two
    sides compute the forward differently (flash vs dense, conv kernel vs
    plain route, card vs CPU) and
    1e-5 where they share it (fused vs split). A forward that differs in its
    last bits flips the ReLU derivative of the pre-activations that lie
    within rounding of 0, and each flip moves whole rows of a weight
    gradient: two correct fp32 paths, the dense route on the card and on the
    CPU, differ by 1.8e-4 at 32 utterances and 7.3e-4 at 4 (H100, fp32, TF32
    off, a chip run of this script's checks at both batch sizes), while
    the same path run twice on the card differs by 2e-7; the
    ``dense_card_vs_cpu`` line measures that floor in every run. The
    largest parameter difference is reported and held to 2 lr + 1e-6,
    since one Adam step moves a weight by up to lr whatever its gradient's
    size, and a gradient that is 0 up to rounding may take either sign.

MFU counts 3x the forward's matmul, conv and attention FLOPs (2 per
multiply-add) at the shapes the step computes (``train_flops``,
``lightconv_train_flops``), against the H100's 989 TFLOP/s of dense bf16.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the timers, the card line and the SDPA yardstick: the sweep module's
from fbk_fairseq_st_tpu_torch.scripts.bench_flash_sweep import (  # noqa: E402
    BWD_KERNEL_NAMES, FWD_KERNEL_NAMES, TRAIN_BACKWARD_SHAPES, card_line, device_busy, device_ms,
    library_device_ms, time_library, time_ms)

# H100 SXM data sheet (dense): memory 3.35 TB/s; bf16 tensor cores 989
# TFLOP/s. fp32 products at fp32 accuracy: 165 TFLOP/s, the tensor cores'
# 495 TFLOP/s of TF32 over the three TF32 products that make one fp32-faithful
# product (3xTF32, the rate the memory-efficient SDPA backend's fp32 products
# and the port's tf32x3 kernels run at); the CUDA cores' 67 TFLOP/s of fp32
# is below it, so a bound at 67 would not be the card's least time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BF16 = 989e12

ATOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PLAIN_ITERS = 5  # calls a mean of the plain attention's timings (milliseconds a call at S 2048)
ATOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
RTOL_GRAD_BF16 = 1e-2  # flash dq / dk / dv in bf16: of max|plain|, tensor by tensor
ATOL_LSE = 1e-4
KEEP_PROBE_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -8}
# the keep-mask probes: (forward route, kernel head dim; None: the CUDA-core
# kernel at kernel_head_dim(min(S, 128))), each route's type
KEEP_PROBES = (("cuda_core", None), ("tf32x3", 128), ("tf32x3", 64), ("tf32x3", 32), ("tc", 128), ("tc", 64),
               ("tc", 32))
KEEP_PROBE_DTYPES = {"cuda_core": torch.float32, "tf32x3": torch.float32, "tc": torch.bfloat16}
SINGLE_BF16_LIMIT = (1e-3, 8e-3)  # (atol, rtol of |plain|), element by element
RTOL_DW = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ATOL_MODEL = 1e-3
RTOL_STEP_LOSS = 1e-5
RTOL_STEP_GRAD = {"other_forward": 5e-3, "same_forward": 1e-5}

N_MELS = 80
VOCAB = 8000
BEAM = 5
# the decode loops' length: random weights run every hypothesis to it, and
# each step is a host loop on the card and on the CPU, so it sets much of the
# script's time (its 1,200 s limit holds on a slower host too)
MAX_LEN_B = 30
FRAME_SECONDS = 0.01  # 10 ms fbank hop
FLASH_LAUNCHES_PER_REQUEST = 8  # 2 ConvAttention2D blocks + 6 encoder layers

# the train step (bench.py:43-82)
TRAIN_BATCH = 128
TRAIN_FRAMES = 512
TGT_LEN = 48
WARMUP_STEPS = 3
TIMED_STEPS = 20
REPEATS = 3
SPLIT_STEPS = 5  # the short runs with each backward forced

# (name, bh, T, S, D, causal, padded keys): the flash calls of the serving
# paths; the last two are phase 2's teacher-forced auxiliary pass of a
# two-phase request (32 x beam 5 transcripts of up to 101 tokens, 4 heads)
KERNEL_SHAPES = [
    ("encoder_self_attention", 128, 128, 128, 64, False, True),
    ("time_attention", 128, 128, 128, 20, False, True),
    ("decoder_causal_self_attention", 32, 100, 100, 64, True, True),
    ("cross_attention", 32, 37, 128, 64, False, True),
    ("long_encoder_self_attention", 32, 750, 750, 64, False, True),
    ("twophase_aux_causal_self_attention", 640, 101, 101, 64, True, True),
    ("twophase_aux_cross_attention", 640, 101, 128, 64, False, True),
]

# (name, bh, T, S, D, causal, dropout rate, keys padded on the left,
# types): the flash calls of the train steps (the sweep's
# TRAIN_BACKWARD_SHAPES: the conv_transformer step at batch 128 and the
# dual-decoder step's auxiliary decoder beside it, the lightconv decoder's
# encoder attention at batch 64, the iwslt lightconv presets' at D 128
# (batch 64 x 4 heads), the long-context step at T' = 2048; all with
# padded keys) in fp32 and bf16, a ragged call and a causal one with T > S,
# unaligned, one bf16 call at D 16, and one at bh 70,000 (past the 65,535
# of a grid's y dimension: every kernel puts bh on x); at D 16 the forward
# and the pair run on the CUDA cores
TRAIN_KERNEL_SHAPES = [(*shape, (torch.float32, torch.bfloat16)) for shape in TRAIN_BACKWARD_SHAPES] + [
    ("ragged_bh3_T77_S333", 3, 77, 333, 64, False, 0.1, False, (torch.float32, torch.bfloat16)),
    ("causal_bh6_T130_S77", 6, 130, 77, 64, True, 0.1, False, (torch.float32, torch.bfloat16)),
    ("d16_bf16", 64, 100, 100, 16, False, 0.1, False, (torch.bfloat16,)),
    ("bh70000_T16_D128", 70000, 16, 16, 128, False, 0.1, False, (torch.float32, torch.bfloat16)),
    # the iwslt call at rate 0, and a long D 128 call whose products bound
    # the tensor-core kernels (bf16: forward 0.069 ms, dq 0.104, dkv 0.139
    # at 989 TFLOP/s; fp32: forward 0.416, dq 0.62, dkv 0.83 at 165)
    ("lightconv_iwslt_cross_attention_rate0", 256, 56, 56, 128, False, 0.0, True, (torch.float32, torch.bfloat16)),
    ("d128_long", 32, 2048, 2048, 128, False, 0.1, False, (torch.float32, torch.bfloat16)),
]
# each forward kernel's row name and worst-error kind, by ``fwd_name``
FWD_ROWS = {"tc": "flash_attention_fwd_tc", "tc128": "flash_attention_fwd_tc128",
            "tf32x3": "flash_attention_fwd_tf32x3", "tf32x3_128": "flash_attention_fwd_tf32x3_128",
            "cuda_core": "flash_attention_fwd"}
FWD_KINDS = {"tc": "fwd_tc", "tc128": "fwd_tc128", "tf32x3": "fwd_tf32x3", "tf32x3_128": "fwd_tf32x3_128",
             "cuda_core": "fwd"}
# each backward pair's worst-error kind and row suffix, by ``pair_name``
BWD_KINDS = {"fused": "bwd_fused", "cuda_core": "bwd_cuda_core", "tc": "bwd_tc", "tc128": "bwd_tc128",
             "tf32x3": "bwd_tf32x3", "tf32x3_128": "bwd_tf32x3_128"}
ROW_SUFFIX = {"cuda_core": "", "tc": "_tc", "tc128": "_tc128", "tf32x3": "_tf32x3", "tf32x3_128": "_tf32x3_128"}
# each type's default pair and the fused kernel, bits compared across
# launches: the tensor-core pair at D 64 at the long call; at the iwslt call
# (rates 0.1 and 0) the D 128 tensor-core pair of each type
DETERMINISM_AT = ("long_encoder_self_attention", "lightconv_iwslt_cross_attention",
                  "lightconv_iwslt_cross_attention_rate0")
# the calls whose SDPA yardstick is also taken as device time (a trace):
# at the iwslt call the library's wall time is host-bound
LIBRARY_DEVICE_AT = ("lightconv_iwslt_cross_attention", "d128_long")

# flash calls a conv_transformer train step makes: 2 time attention (F' =
# 20 padded to 32), 6 encoder self-attention, 6 decoder causal
# self-attention, 6 cross-attention; each one forward and one backward
CT_FLASH_CALLS_PER_STEP = 20
# the routes every call of the train steps takes (kernel D 32 and 64): the
# tensor-core forward and the tensor-core dq + dkv pair of the step's type
# (bf16 "tc", fp32 "tf32x3"), since the sweep measured each faster than its
# CUDA-core or fused counterpart at each of them (phase 13 asserts that
# they still are); the step phases hold their launch counts to them, and
# serving (fp32) to FP32_FORWARD
BF16_FORWARD = "flash_fwd_tc"
FP32_FORWARD = "flash_fwd_tf32x3"
BF16_BACKWARD = "split_tc"
FP32_BACKWARD = "split_tf32x3"
BACKWARD_KERNELS = {"fused": ("flash_bwd_fused",), "split_tc": ("flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
                    "split_tc128": ("flash_bwd_dq_tc128", "flash_bwd_dkv_tc128"),
                    "split_tf32x3": ("flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3"),
                    "split_tf32x3_128": ("flash_bwd_dq_tf32x3_128", "flash_bwd_dkv_tf32x3_128"),
                    "split_cuda_core": ("flash_bwd_dq", "flash_bwd_dkv")}
# kernel head dim 128 (the iwslt presets' decoder cross-attention), by
# launch counter: in bf16 the D 128 tensor-core forward (csrc/flash_fwd_tc.cu)
# and pair (csrc/flash_bwd_tc128.cu); in fp32 the D 128 tf32x3 forward
# (csrc/flash_fwd_tf32x3.cu) and pair (csrc/flash_bwd_tf32x3.cu); both
# pairs bitwise repeatable
D128_FORWARD = "flash_fwd_tc128"
D128_BACKWARD = "split_tc128"
FP32_D128_FORWARD = "flash_fwd_tf32x3_128"
# the fp32 step's busy ms when its D 128 forward ran on the CUDA cores
# (this script's phase 20b on an NVIDIA H100 80GB HBM3 at 700 W), printed
# beside phase 20b's
FP32_D128_CUDA_CORE_BUSY_MS = 38.47
FP32_D128_BACKWARD = "split_tf32x3_128"

# the multi-decoder paths (models/multi_task.py): two-phase serving
# (bench.py::_measure_decode with twophase=True) and the dual-decoder step
TWOPHASE_ARCHS = ("conv_transformer_dualdecoder", "conv_transformer_triangle", "conv_transformer_2stage")
# a two-phase request: the encoder's 8, and phase 2's teacher-forced
# aux_features pass, 6 causal self- and 6 cross-attentions; the decode
# steps of both phases attend their caches on the dense path
TWOPHASE_LAUNCHES_PER_REQUEST = 8 + 12
DUAL_ARCH = "conv_transformer_dualdecoder"
DUAL_FLASH_CALLS_PER_STEP = CT_FLASH_CALLS_PER_STEP + 12  # the auxiliary decoder's self- and cross-attentions
DUAL_TR_LEN = 64
DUAL_TIMED_STEPS = 10

# the lightconv paths (dynamicconv_wmt_en_de_big, models/lightconv.py)
LC_ARCH = "dynamicconv_wmt_en_de_big"
LC_VOCAB = 32768  # each of the source and target dictionaries, a 32 k BPE
LC_TRAIN_BATCH = 64
LC_TRAIN_LEN = (40, 56)  # source and target tokens a pair
LC_TIMED_STEPS = 10
DCONV_LAUNCHES_PER_REQUEST = 7  # the encoder's layers
DCONV_LAUNCHES_PER_STEP = 13  # 7 encoder + 6 teacher-forced decoder layers
# the dynamic conv's route on every model path: the tensor-core kernels
# (csrc/dynamic_conv_tc.cu); the first, CUDA-core kernels (csrc/dynamic_conv.cu)
# are launched by phase 5's direct calls only
DCONV_FORWARD, DCONV_BACKWARD = "dconv_fwd_tc", "dconv_bwd_tc"
DCONV_DIRECT_ONLY = ("dconv_fwd", "dconv_bwd")
LC_FLASH_LAUNCHES_PER_STEP = 6  # the decoder's encoder attention
# dynamicconv_iwslt_de_en (512/1024/4, 7 + 6 layers; head dim 128), trained
# on LC_TRAIN_BATCH pairs over the same dictionaries, in fewer timed steps
IWSLT_ARCH = "dynamicconv_iwslt_de_en"
IWSLT_TIMED_STEPS = 5
IWSLT_FP32_STEPS = 3  # phase 20b's timed fp32 steps

# serving from files (cli/generate): phase 6's request sizes written as a
# corpus, one batch of all of them
FILES_UTTERANCES = 32
FILES_TGT_LEN = (10, 40)
FILES_SCORE_ATOL = 1e-4  # H- scores (base 2) against the in-memory generator's
# the search strategies on the card (phase 6's model): a sampling request
# and a diverse-beam one on 8 utterances, a top-k 1 request on 4 against
# greedy search
SEARCH_UTTERANCES = 8
SAMPLING_TOPK = 10
DIVERSE_BEAM, DIVERSE_GROUPS = 4, 2

# training from files (cli/train), the README's quick start at full width:
# utterances of 409-512 frames x 80 mels a split, target and transcript
# tokens over phase 6's dictionary; a second run stopped mid epoch 1 and
# resumed; a bh/B past the 65,535 of a grid's y dimension for A3's checks
FILES_TRAIN_SPLITS = {"train": 640, "valid": 64}
FILES_TRAIN_TGT_LEN = (20, 48)
FILES_TRAIN_TR_LEN = (30, 64)
FILES_RESUME_AT = 5  # updates: mid epoch 1
RTOL_RESUME_LOSS = 1e-3  # bf16 compute, and F.ctc_loss's CUDA backward sums with atomics
QUICK_START = ["--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
               "--arch", "conv_transformer", "--input-feat-per-channel", str(N_MELS), "--criterion", "ctc_multi_loss",
               "--underlying-criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
               "--ctc-encoder-layer", "4", "--ctc-compress-out", "--optimizer", "adam", "--lr", "0.002",
               "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4000", "--clip-norm", "10",
               "--max-tokens", "25000", "--bf16", "--max-epoch", "2", "--log-format", "json", "--log-interval", "1"]
CLI_TIMED_STEPS = 5  # Trainer.train_step on the CLI's first batch, beside the CLI's update wall
# phases 25-26 (on phase 24's corpus): the quick start's optimisation, bf16
OPTIM_ARGS = ["--optimizer", "adam", "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4000",
              "--clip-norm", "10", "--max-tokens", "25000", "--bf16", "--log-format", "json", "--log-interval", "1"]
MT_UPDATES = 3  # the multitask model's updates through cli/train
MT_CLASSIFY_LAUNCHES = FLASH_LAUNCHES_PER_REQUEST  # the encoder's: 2 time attention + 6 self-attention
KD_TOPK = 8
KD_TOPK_LAUNCHES = CT_FLASH_CALLS_PER_STEP  # the teacher-forced forward: encoder 8, decoder 6 + 6
KD_UPDATES = 3  # the student's updates through cli/train
# phase 27 (on phase 24's corpus plus nl targets): multilingual ST, two
# pairs over one shared encoder; each pair's passes are a conv_transformer
# step's 20 flash calls
ML_PAIRS = ("en-de", "en-nl")
ML_FLASH_CALLS_PER_UPDATE = len(ML_PAIRS) * CT_FLASH_CALLS_PER_STEP
ML_UPDATES = {"concat": 3, "sum": 1}  # cli/train's updates under each merge strategy
ML_ARGS = ["--task", "multilingual_speech_translation", "--lang-pairs", ",".join(ML_PAIRS), "--share-encoders",
           "--encoder-langtok", "tgt", "--decoder-langtok", "--arch", "multilingual_conv_transformer",
           "--input-feat-per-channel", str(N_MELS), "--criterion", "label_smoothed_cross_entropy",
           "--label-smoothing", "0.1"]
# phase 28: the dual decoder trained through cli/train, then served by
# cli/generate_dualdecoder in batches of 32 (phase 17's request size)
DUAL_CLI_UPDATES = 2
DUAL_CLI_BATCH = 32
# phase 29: context-aware ST (conv_transformer_context) on phase 24's
# corpus, its context files beside it; the pretrained model phase 24's
# checkpoint_best.pt with --freeze-pretrained encoder. The launches an
# update, from the code (written down before the first run): tgt, 33
# forwards (phase 7's 20, the text context encoder's 1, the encoder's 6 and
# the decoder's 6 context attentions) and 30 pairs (the frozen front end's
# 2 time attentions and encoder layer 0's self-attention have no input that
# needs a gradient); src, 41 forwards (the frozen audio context encoder's
# 8 more, in eval mode, and its context layer's 1 in place of the text
# encoder's) and 30 pairs; a validation batch the forwards. A request
# (cli/generate, fp32): the encoder's 8, the context encoder's 1 and the
# encoder's 6 context attentions, 15 tf32x3 forwards, and the audio
# encoder's 8 more for src; the decoder's context attention reads its
# precomputed K/V (the dense route)
CTX_ARCH = "conv_transformer_context"
CTX_UPDATES = {"tgt": 3, "src": 2}
CTX_FORWARDS = {"tgt": 33, "src": 41}
CTX_BACKWARDS = {"tgt": 30, "src": 30}
CTX_REQUEST_LAUNCHES = {"tgt": 15, "src": 23}
CTX_ATTENTION = {"tgt": "parallel", "src": "sequential"}
CTX_SERVE_UTTERANCES = 8  # chained single-utterance requests (tgt), --max-sentences 1
CTX_SRC_BATCH = 32
CTX_ARGS = ["--task", "speech_recognition_context", "-t", "de", "--arch", CTX_ARCH, "--input-feat-per-channel",
            str(N_MELS), "--context-encoder-layers", "1", "--criterion", "label_smoothed_cross_entropy_ctxreg",
            "--label-smoothing", "0.1", "--ctx-reg-alpha", "0.3", "--freeze-pretrained", "encoder",
            "--weight-decay", "0.01"]
# phase 30: from raw files to the papers' scores, on phase 24's corpus and save dir
RESEG_SEGMENTS = 16  # MuST-C segments cut in two by the resegmentation
SCORE_REF_LAUNCHES = CT_FLASH_CALLS_PER_STEP  # the teacher-forced fp32 forward: encoder 8, decoder 6 + 6
SCORE_REF_ATOL = 1e-4  # --score-reference and cli/interactive against the in-memory scorer / generator
INTERACTIVE_LINES = 32
INTERACTIVE_BUFFER = 8  # --buffer-size and --max-sentences: one batch a buffer
# phase 31 (after phase 30, in its directory): the wiring from files. The
# JSON route: seeded 16 kHz WAVs of 4.1-5.1 s (409-509 frames), the
# quick start's conv_transformer with one target an utterance (label-smoothed
# CE), bf16, sharded asynchronous checkpoints, stopped at update 2 and
# resumed to 3 against a straight 3-update run
JSON_SPLITS = {"train": 64, "valid": 16}
JSON_SECONDS = (4.1, 5.1)
JSON_RATE = 16000
JSON_STOP, JSON_END = 2, 3
JSON_ARGS = ["--task", "speech_recognition", "--dataset-from-json", "--arch", "conv_transformer",
             "--input-feat-per-channel", str(N_MELS), "--criterion", "label_smoothed_cross_entropy",
             "--label-smoothing", "0.1", *OPTIM_ARGS, "--checkpoint-format", "sharded", "--async-checkpoint"]
# the alignments' teacher-forced fp32 forward: encoder 8, decoder 6 self +
# 5 cross (the last layer's cross-attention takes the dense route for its
# weights), beside the search's 8 a batch
ALIGN_LAUNCHES = CT_FLASH_CALLS_PER_STEP - 1
ALIGN_ATTN_ATOL = 1e-5  # the attention rows, card against CPU
ALIGN_MARGIN = 1e-4  # A- pairs held equal where the top two weights differ by more
PRUNE_KEEP = "0,2,4"
GEN_MAX_TOKENS = 25000  # phase 24's decode batching: the valid split in 2 batches, one a shard
PRUNED_LAUNCHES = 2 + 3  # the front end's 2 time attentions + the 3 kept encoder layers
CODEC_LINES = 16
USER_ARCH = "user_conv_transformer"
# the codecs' libraries, each run where the card's machine has it
CODEC_PACKAGES = ("sacremoses", "nltk", "sentencepiece", "subword_nmt", "transformers", "fastBPE", "tokenizers",
                  "sacrebleu", "torchaudio")
# ``--bpe gpt2`` on ``codec_runs``' sentence and GPT-2-format files: the ids
# tests/test_torch_encoders.py::test_gpt2_ids_of_the_chip_check gets on the
# CPU (transformers 4.57.6) from the same files (``write_gpt2_files``)
GPT2_TEXT = "Hello,  world! It's a well-known test."
GPT2_IDS = "39 260 78 11 220 262 263 75 67 0 220 40 83 6 82 220 64 262 260 12 74 77 78 86 77 256 68 82 83 13"
GRID_CAP_ROWS = 70_000
# the single pass's bf16 out at bh 70,000 element by element: two bf16 ulps
# of |plain| (72 M outputs reach further into the tail of P's rounding than
# phase 12's 4 M, whose SINGLE_BF16_LIMIT is one ulp); max|err| still within
# ATOL_KERNEL, so a block that computes the wrong row misses by |out|
GRID_CAP_BF16_LIMIT = (1e-3, 2.0 ** -6)

# the realistic train step (bench.py:164-171, :497): the base step with
# SpecAugment at rate 1.0, then with TimeStretch too
REALISTIC_TIMED_STEPS = 10
# the share of nonzero input elements SpecAugment zeroes at its defaults:
# two frequency masks of floor(U[0, 13)) of 80 mels (~0.145) and two time
# masks of floor(U[1, 13)) of 512 frames (~0.025), ~0.167 together
MASKED_SHARE_RANGE = (0.13, 0.21)

# (name, B, T, C, H, K, padding_l): the dynamic conv's calls on the main
# paths, every (K, padding_l) pair of the encoder (centred) and of the
# teacher-forced decoder (causal), and the long serving request
DCONV_SHAPES = [
    ("serve_k3", 32, 60, 1024, 16, 3, 1),
    ("serve_k7", 32, 60, 1024, 16, 7, 3),
    ("serve_k15", 32, 60, 1024, 16, 15, 7),
    ("serve_k31", 32, 60, 1024, 16, 31, 15),
    ("serve_long_k31", 8, 250, 1024, 16, 31, 15),
    ("train_k31_centred", 64, 56, 1024, 16, 31, 15),
    ("train_k3", 64, 56, 1024, 16, 3, 1),
    ("train_k7", 64, 56, 1024, 16, 7, 3),
    ("train_k15", 64, 56, 1024, 16, 15, 7),
    ("train_k3_causal", 64, 56, 1024, 16, 3, 2),
    ("train_k7_causal", 64, 56, 1024, 16, 7, 6),
    ("train_k15_causal", 64, 56, 1024, 16, 15, 14),
    ("train_k31_causal", 64, 56, 1024, 16, 31, 30),
    ("ragged", 4, 37, 48, 3, 4, 1),
    # dynamicconv_iwslt_de_en's widths (C 512, H 4: r = 128, two channel chunks)
    ("iwslt_k31_centred", 64, 56, 512, 4, 31, 15),
    ("iwslt_k31_causal", 64, 56, 512, 4, 31, 30),
]
# the 13 main-path calls, where the tensor-core kernels must win
DCONV_MAIN_SHAPES = tuple(name for name, *_ in DCONV_SHAPES if name.startswith(("serve_", "train_")))
DCONV_COLD_AT = ("train_k31_centred", "train_k31_causal")  # bf16 rows also timed with a cold L2
L2_FLUSH_BYTES = 128 << 20  # written between launches: over the H100's 50 MB L2
# each route's (forward, backward) kernels, by row name; a trace names each
# kernel "<row name>_kernel"
DCONV_ROUTES = {"tc": ("dynamic_conv_fwd_tc", "dynamic_conv_bwd_tc"),
                "cuda_core": ("dynamic_conv_fwd", "dynamic_conv_bwd")}
DCONV_PAIRED_ROUNDS = 60  # launches of each route in the trace that compares them

# the single-pass kernels' checks: (name, bh, T, S, causal, padded keys,
# types), each at every t_block the type's kernel takes
# (flash_fwd_single.T_BLOCKS); S 8192 is past the fp32 kernel's shared memory
SINGLE_SHAPES = [
    ("bh32_S2048", 32, 2048, 2048, False, False, (torch.float32, torch.bfloat16)),
    ("bh64_S2048_causal", 64, 2048, 2048, True, False, (torch.float32, torch.bfloat16)),
    ("ragged_bh4_T300_S333", 4, 300, 333, False, True, (torch.float32, torch.bfloat16)),
    ("ragged_bh2_T700_S8192", 2, 700, 8192, False, True, (torch.bfloat16,)),
]
SINGLE_TIMED_AT = ("bh32_S2048", "bfloat16", 64)  # the kernels line's row

# the CTC flagship (bench.py:344-423)
CTC_ARCH = "conv_transformer_big"
CTC_SRC_SYMBOLS = 700
CTC_TR_LEN = 64
CTC_TIMED_STEPS = 10

# the long-context train step (bench.py:505-507)
LONG_BATCH = 8
LONG_FRAMES = 8192
LONG_TIMED_STEPS = 5

KERNEL_SOURCES = ("flash_fwd", "flash_fwd_tc", "flash_fwd_tf32x3", "flash_bwd", "flash_bwd_tc", "flash_bwd_tc128",
                  "flash_bwd_tf32x3", "dynamic_conv", "dynamic_conv_tc", "flash_fwd_single")
# sources whose every kernel must report 0 bytes of spill stores: those of
# the D 128 tensor-core kernels
NO_SPILL_SOURCES = ("flash_fwd_tc", "flash_fwd_tf32x3", "flash_bwd_tc128", "flash_bwd_tf32x3")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _device_events(prof):
    """The trace's device-side events (kernels, copies), not the host-side
    runtime calls that also report their kernels' durations."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


CARD = [None]  # the card's nvidia-smi line, set by main


# kernel classes of a profile: (class, a name substring that marks it)
KERNEL_CLASSES = (("dynamic_conv", "dynamic_conv_"), ("flash", "flash_"), ("gemm", "gemm"),
                  ("gemm", "nvjet"), ("gemm", "gemv"))


def profile_window(fn):
    """Device busy time, the kernels that take it and its split by kernel
    class while ``fn`` runs (torch.profiler, device activity only), beside
    the host wall time. A trace that caught no device event (a chip run
    saw one, for a long-context step) is taken again."""
    from torch.profiler import ProfilerActivity, profile

    by_name = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        for e in _device_events(prof):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
        if by_name:
            break
    busy_s = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    classes = {}
    for name, sec in by_name.items():
        cls = next((c for c, mark in KERNEL_CLASSES if mark in name), "other")
        classes[cls] = classes.get(cls, 0.0) + sec
    return wall_s, busy_s, [(name[:80], s) for name, s in top], classes


def causal_pairs(t: int, s: int, causal: bool) -> int:
    return sum(min(r + 1, s) for r in range(t)) if causal else t * s


def bound_ms(nbytes: float, flops: float, dtype):
    """Least time for the function on this card: the bytes it must move at
    the memory rate against its operations at the peak rate of the type."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def attention_bound_ms(bh, t, s, d, causal, dtype):
    """The forward: q, k, v, bias in, out and lse out; 2 products."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * bh * d * (2 * t + 2 * s) + 4 * bh * s + 4 * bh * t
    return bound_ms(nbytes, 4.0 * bh * causal_pairs(t, s, causal) * d, dtype)


def backward_bound_ms(kind, bh, t, s, d, causal, dtype):
    """A backward: q, k, v, dO, bias, lse, delta in; its gradients out.
    Products of 2*T*S*D per bh: fused 5 (s, dO V^T, dV, dK, dQ), dq 3
    (s, dO V^T, dQ), dkv 4 (s, dO V^T, dV, dK)."""
    item = torch.tensor([], dtype=dtype).element_size()
    inputs = item * bh * d * (2 * t + 2 * s) + 4 * bh * s + 8 * bh * t
    outputs = {"fused": item * bh * d * (t + 2 * s), "dq": item * bh * d * t, "dkv": item * bh * d * 2 * s}[kind]
    products = {"fused": 5, "dq": 3, "dkv": 4}[kind]
    return bound_ms(inputs + outputs, 2.0 * products * bh * causal_pairs(t, s, causal) * d, dtype)


def random_attention_inputs(gen, bh, t, s, d, dtype, padded=True, left=False):
    q = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros((bh, s), device="cuda")
    if padded:  # ragged key lengths, as the batches give them
        lengths = torch.randint(s // 2, s + 1, (bh,), generator=gen, device="cuda")
        lengths[0] = s
        pos = torch.arange(s, device="cuda")[None, :]
        pads = pos < (s - lengths)[:, None] if left else pos >= lengths[:, None]
        bias = torch.where(pads, -1e9, 0.0)
    return q, k, v, bias


def build_kernels(kernel_build):
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        path = kernel_build.build(name)
        return name, path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(one, KERNEL_SOURCES))
    total_s = time.perf_counter() - t0
    for name, path, seconds in built:
        ptxas = [line.strip() for line in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "spill" in line or "Compiling entry" in line]
        emit({"phase": "build", "kernel": name, "seconds": seconds, "ptxas": ptxas})
        spills = [line for line in ptxas if "spill stores" in line]
        if name in NO_SPILL_SOURCES and (not spills or any("0 bytes spill stores" not in line for line in spills)):
            raise AssertionError(f"{name}.cu spills registers (or ptxas reported nothing): {spills}")
    emit({"phase": "build", "all_seconds": total_s})


# ---------------------------------------------------------------------------
# 3. kernels at the serving shapes
# ---------------------------------------------------------------------------

def check_serving_kernels(fa):
    """Each serving-shape call in fp32 and bf16: the forward of the call's
    route through ``flash_attention`` (the tensor cores at kernel D 32 and
    64: "tf32x3" in fp32, "tc" in bf16), and in fp32 there also the
    CUDA-core forward, launched directly, against the plain version; times
    and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {}
    for name, bh, t, s, d, causal, padded in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype, padded)
            scale = d ** -0.5
            dk = fa.kernel_head_dim(d)
            route = fa.fwd_route(dtype, dk)
            calls = {route: lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)}
            if route == "tf32x3":
                qp, kp, vp = (_pad_d(x, dk) for x in (q, k, v))
                calls["cuda_core"] = lambda: fa.forward_cuda_core(qp, kp, vp, bias, scale, causal, 0.0, 0)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal)
            library_ms, library_backend = time_library(q, k, v, bias, scale, causal)
            plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal), iters=PLAIN_ITERS)
            for r, call in calls.items():
                out_k, lse_k = call()
                torch.cuda.synchronize()
                err = (out_k[..., :d].float() - out_p.float()).abs().max().item()
                lse_err = (lse_k - lse_p).abs().max().item()
                if not (err <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE):
                    raise AssertionError(f"{FWD_KERNEL_NAMES[r]} disagrees with its plain version at {name} {dtype}: "
                                         f"max|out| err {err}, max|lse| err {lse_err}")
                key = (FWD_KINDS[r], dtype)
                worst[key] = max(worst.get(key, 0.0), err)
                row = {
                    "phase": "kernel_check", "kernel": FWD_ROWS[r], "route": r,
                    "launch": "flash_attention" if r == route else "direct", "shape": name,
                    "bh": bh, "T": t, "S": s, "D": d, "causal": causal, "rate": 0.0,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": ATOL_KERNEL[dtype],
                    "kernel_ms": time_ms(call), "kernel_device_ms": device_ms(call, FWD_KERNEL_NAMES[r]),
                    "plain_ms": plain_ms, "library_ms": library_ms, "library_backend": library_backend,
                    "card": CARD[0],
                }
                row["bound_ms"], row["bound_by"] = attention_bound_ms(bh, t, s, d, causal, dtype)
                emit(row)
                rows.append(row)
    return rows, worst


# ---------------------------------------------------------------------------
# 4. kernels at the training shapes
# ---------------------------------------------------------------------------

def kernel_keep_mask(fa, bh, t, s, causal, rate, seed, route, d, device="cuda"):
    """The keep mask as the forward kernel of ``route`` at kernel head dim
    ``d`` applies it, launched directly ("cuda_core" in fp32, "tf32x3" in
    fp32, "tc" in bf16). With q = k = 0 and bias 0 every unmasked weight is
    exactly 1 and l_i counts row i's keys, so with V the identity on a
    window of D keys (0 elsewhere, exact in bf16 and in tf32) out[i, c] =
    keep(i, j0 + c) / (l_i (1 - rate)); the windows tile the S keys, one
    launch each. In bf16 only the output's final rounding (2^-9 of it)
    differs, so the 0/1 test takes ``KEEP_PROBE_TOL``. Returns (mask, the
    entries it is defined on)."""
    dtype = KEEP_PROBE_DTYPES[route]
    launch = fa.FORWARDS[route]
    q = torch.zeros((bh, t, d), device=device, dtype=dtype)
    k = torch.zeros((bh, s, d), device=device, dtype=dtype)
    bias = torch.zeros((bh, s), device=device)
    windows = []
    for j0 in range(0, s, d):
        n = min(d, s - j0)
        v = torch.zeros((s, d), device=device, dtype=dtype)
        v[j0:j0 + n, :n] = torch.eye(n, device=device, dtype=dtype)
        windows.append(launch(q, k, v.expand(bh, s, d), bias, 1.0, causal, rate, seed)[0][..., :n])
    out = torch.cat(windows, dim=-1).float()
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    keys = torch.clamp(rows + 1, max=s) if causal else torch.full_like(rows, s)
    scaled = out * keys[None].float() * (1.0 - rate)
    if not torch.all((scaled - scaled.round()).abs() < KEEP_PROBE_TOL[dtype]):
        raise AssertionError(f"the {route} probe's output is not a 0/1 mask times 1 / (l (1 - rate))")
    valid = (cols <= rows) if causal else torch.ones((t, s), dtype=torch.bool, device=device)
    return scaled.round() == 1, valid.expand(bh, t, s)


def _pad_d(x, d_kernel):
    return torch.nn.functional.pad(x, (0, d_kernel - x.shape[-1])).contiguous()


def grad_errors(got, want, dtype):
    """Against the plain gradients: fp32 the largest absolute difference of
    dq, dk, dv; bf16 the largest of each tensor's max|kernel - plain| over
    its max|plain|. Returns (max abs err, that ratio, the max|plain| of dq,
    dk, dv, within the limit)."""
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    tops = [b.float().abs().max().item() for b in want]
    ratio = max(e / max(t, 1e-30) for e, t in zip(errs, tops))
    ok = ratio <= RTOL_GRAD_BF16 if dtype == torch.bfloat16 else max(errs) <= ATOL_GRAD[dtype]
    return max(errs), ratio, tops, ok


def pair_name(route, d_kernel):
    """The name of the split pair ``route`` runs at kernel head dim
    ``d_kernel``: "tc128" for the bf16 pair at D 128 (its own source),
    "tf32x3_128" for the fp32 one (its own launch counters)."""
    if d_kernel == 128 and route != "cuda_core":
        return {"tc": "tc128", "tf32x3": "tf32x3_128"}[route]
    return route


def fwd_name(route, d_kernel):
    """The name of the forward ``route`` runs at kernel head dim
    ``d_kernel``: "tc128" and "tf32x3_128" for the forwards at D 128 (their
    own launch counters)."""
    return {"tc": "tc128", "tf32x3": "tf32x3_128"}[route] if d_kernel == 128 and route != "cuda_core" else route


def check_training_kernels(fa, philox):
    """Each training-shape call in its types: the keep mask through every
    forward kernel that draws it (at a rate above 0); the forward of the
    call's route (on the tensor cores at D 32, 64 and 128: "tc" in bf16,
    "tf32x3" in fp32; on the CUDA cores otherwise), the split
    pair of the call's route (the same, and at D 128 the tensor cores in
    both types: ``csrc/flash_bwd_tc128.cu``, ``flash_bwd_tf32x3.cu``) and
    the fused backward, and in fp32 at D 32 and 64 also the
    CUDA-core forward and pair, at D 128 the CUDA-core pair and forward,
    which no default route takes there, launched
    directly, all against the plain versions; the tensor-core pairs'
    determinism; times and bounds. At every D 128 call the tensor-core
    kernels must beat their CUDA-core counterparts (``check_d128_wins``,
    asserted)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    worst = {(kind, dtype): 0.0 for kind in (*FWD_KINDS.values(), *BWD_KINDS.values())
             for dtype in (torch.float32, torch.bfloat16)}
    worst_ratio = {}
    for name, bh, t, s, d, causal, rate, left, dtypes in TRAIN_KERNEL_SHAPES:
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=torch.Generator().manual_seed(len(rows))))
        want = philox.keep_mask(seed, bh, t, s, rate, device="cuda")
        for probe_route, probe_d in KEEP_PROBES if rate > 0 else ():
            probe_d = probe_d or fa.kernel_head_dim(min(s, fa.KERNEL_HEAD_DIMS[-1]))
            got, valid = kernel_keep_mask(fa, bh, t, s, causal, rate, seed, probe_route, probe_d)
            mismatches = int((got != want)[valid].sum())
            keep_frac = float(want[valid].float().mean())
            probe_kernel = "flash_" + FWD_KINDS[fwd_name(probe_route, probe_d)]
            emit({"phase": "keep_mask_check", "shape": name, "bh": bh, "T": t, "S": s, "rate": rate,
                  "dtype": str(KEEP_PROBE_DTYPES[probe_route]).replace("torch.", ""), "D": probe_d,
                  "kernel": probe_kernel, "elements": int(valid.sum()), "mismatches": mismatches,
                  "keep_fraction": keep_frac})
            if mismatches:
                raise AssertionError(f"{name}: {probe_kernel}'s keep mask differs from philox.keep_mask "
                                     f"at {mismatches} elements")
            del got, valid
        del want

        for dtype in dtypes:
            q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype, left=left)
            g = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            drop = dict(dropout_rate=rate, dropout_seed=seed)
            dk = fa.kernel_head_dim(d)
            route, pair_route = fa.fwd_route(dtype, dk), fa.split_route(dtype, dk)
            # the CUDA-core kernels at the tensor-core routes' head dims (in
            # fp32 the forward and the pair, at D 128 both in both types),
            # which no default route takes, launched directly
            routes = [route] + (["cuda_core"] if route == "tf32x3" or (route == "tc" and dk == 128) else [])
            direct_pair = pair_route != "cuda_core" and (route == "tf32x3" or dk == 128)
            pair_routes = [pair_route] + (["cuda_core"] if direct_pair else [])
            qp, kp, vp, gp = (_pad_d(x, dk) for x in (q, k, v, g))
            fwd_calls = {route: lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True,
                                                           **drop)}
            if "cuda_core" in routes[1:]:
                fwd_calls["cuda_core"] = lambda: fa.forward_cuda_core(qp, kp, vp, bias, scale, causal, rate, seed)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)
            out_k, lse_k = fwd_calls[route]()
            fwd_errs = {}
            for r, call in fwd_calls.items():
                out_r, lse_r = call()
                fwd_errs[r] = ((out_r[..., :d].float() - out_p.float()).abs().max().item(),
                               (lse_r - lse_p).abs().max().item())
            # every backward against the plain one, on the public forward's out and lse
            bwd_args = (qp, kp, vp, bias, _pad_d(out_k, dk), lse_k, gp, scale, causal, rate, seed)
            want_grads = fa.flash_attention_backward_reference(q, k, v, bias, out_k, lse_k, g, scale,
                                                               causal, rate, seed)
            bwd_calls = {"fused": lambda: fa.backward_fused(*bwd_args)}
            for r in pair_routes:
                bwd_calls[r] = lambda r=r: fa.backward_pair(r, *bwd_args)
            grads = {r: [x[..., :d] for x in call()] for r, call in bwd_calls.items()}
            torch.cuda.synchronize()
            checks = {r: grad_errors(gr, want_grads, dtype) for r, gr in grads.items()}
            for r, (out_err, _) in fwd_errs.items():
                kind = FWD_KINDS[fwd_name(r, dk)]
                worst[(kind, dtype)] = max(worst[(kind, dtype)], out_err)
            for r, (err, ratio, _, _) in checks.items():
                kind = BWD_KINDS["fused" if r == "fused" else pair_name(r, dk)]
                worst[(kind, dtype)] = max(worst.get((kind, dtype), 0.0), err)
                if dtype == torch.bfloat16:
                    worst_ratio[kind] = max(worst_ratio.get(kind, 0.0), ratio)
            ok = (all(e <= ATOL_KERNEL[dtype] and le <= ATOL_LSE for e, le in fwd_errs.values())
                  and all(c[3] for c in checks.values()))

            library_ms, library_backend = time_library(q, k, v, bias, scale, causal)
            plain_fwd_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed),
                                   iters=PLAIN_ITERS)
            plain_bwd_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, bias, out_k, lse_k, g, scale, causal, rate, seed), iters=PLAIN_ITERS)
            library_bwd_ms, library_bwd_backend = time_library(q, k, v, bias, scale, causal, grad=g)
            base = {"phase": "train_kernel_check", "shape": name, "bh": bh, "T": t, "S": s, "D": d,
                    "causal": causal, "rate": rate, "keys_padded_on_the_left": left,
                    "dtype": str(dtype).replace("torch.", ""), "card": CARD[0]}
            bwd_common = dict(plain_ms=plain_bwd_ms, library_ms=library_bwd_ms, library_backend=library_bwd_backend,
                              library="sdpa forward+backward, rate 0")
            fwd_library = {}
            if name in LIBRARY_DEVICE_AT:
                # SDPA's device time (its host-bound wall time is no yardstick
                # here): the forward, and the backward apart, each on the
                # fused backend fastest by device time
                fwd_library["library_device_ms"], fwd_library["library_device_backend"] = library_device_ms(
                    q, k, v, bias, scale, causal)
                bwd_common["library_device_ms"], bwd_common["library_device_backend"] = library_device_ms(
                    q, k, v, bias, scale, causal, grad=g)
                bwd_common["library_device"] = "sdpa backward alone, rate 0"

            def grad_fields(r):
                err, ratio, tops, _ = checks[r]
                limit = ({"max_err_over_max_plain": ratio, "rtol_of_max_plain": RTOL_GRAD_BF16}
                         if dtype == torch.bfloat16 else {"atol": ATOL_GRAD[dtype]})
                return dict(max_abs_err=err, max_abs_plain_dq_dk_dv=tops, **limit)

            timings = {}
            for r, call in fwd_calls.items():
                timings[FWD_ROWS[fwd_name(r, dk)]] = dict(
                    kernel_ms=time_ms(call), kernel_device_ms=device_ms(call, FWD_KERNEL_NAMES[r]), route=r,
                    launch="flash_attention" if r == route else "direct", plain_ms=plain_fwd_ms,
                    library_ms=library_ms, library_backend=library_backend, **fwd_library, max_abs_err=fwd_errs[r][0],
                    lse_max_abs_err=fwd_errs[r][1], atol=ATOL_KERNEL[dtype],
                    bound=attention_bound_ms(bh, t, s, d, causal, dtype))
            fused = bwd_calls["fused"]
            timings["flash_attention_bwd_fused"] = dict(
                kernel_ms=time_ms(fused), kernel_device_ms=device_ms(fused, BWD_KERNEL_NAMES["fused"][0]),
                wrapper_device_ms=device_busy(fused)[1], bound=backward_bound_ms("fused", bh, t, s, d, causal, dtype),
                **grad_fields("fused"), **bwd_common)
            pair_device = {}
            for r in pair_routes:
                pair = bwd_calls[r]
                pair_ms, pair_device_ms = time_ms(pair), device_busy(pair)[1]
                for kind, match in zip(("dq", "dkv"), BWD_KERNEL_NAMES[r]):
                    timings[f"flash_attention_bwd_{kind}{ROW_SUFFIX[pair_name(r, dk)]}"] = dict(
                        kernel_ms=pair_ms, wrapper_device_ms=pair_device_ms, split_route=r,
                        kernel_device_ms=device_ms(pair, match),
                        bound=backward_bound_ms(kind, bh, t, s, d, causal, dtype), **grad_fields(r), **bwd_common)
                pair_device[r] = sum(timings[f"flash_attention_bwd_{kind}{ROW_SUFFIX[pair_name(r, dk)]}"]
                                     ["kernel_device_ms"] or math.inf for kind in ("dq", "dkv"))
            for kernel, tm in timings.items():
                tm["bound_ms"], tm["bound_by"] = tm.pop("bound")
                row = {**base, "kernel": kernel, **tm}
                emit(row)
                rows.append(row)
            if not ok:
                raise AssertionError(f"training-shape check failed at {name} {dtype}: forward {fwd_errs}, "
                                     f"{ {r: c[:3] for r, c in checks.items()} }")
            if name in DETERMINISM_AT:
                check_determinism(name, bwd_calls[pair_route], bwd_calls["fused"], grads[pair_route], grads["fused"],
                                  d, dtype)
            if dk == 128:
                check_d128_wins(name, bh, t, s, rate, dtype, route, pair_route, timings, pair_device,
                                fwd_library, bwd_common, plain_fwd_ms, plain_bwd_ms)
            del q, k, v, bias, g, out_k, out_p, want_grads, grads
            torch.cuda.empty_cache()
    return rows, worst, worst_ratio


def check_d128_wins(name, bh, t, s, rate, dtype, route, pair_route, timings, pair_device, fwd_library,
                    bwd_common, plain_fwd_ms, plain_bwd_ms):
    """At a D 128 call: the tensor-core pair of the type at most the
    CUDA-core pair's device time, the sum of dq's and dkv's median launches
    (``tc128_pair_wins`` in bf16, ``tf32x3_128_pair_wins`` in fp32), and
    the tensor-core forward's median launch at most the CUDA-core forward's
    (``tc128_fwd_wins`` in bf16, ``tf32x3_fwd_wins`` in fp32); each
    asserted, beside the fused
    kernel's and SDPA's device times, the plain times and the bounds. A
    kernel whose launches no trace kept raises: no flag stands on a time
    not measured."""
    pair = pair_name(pair_route, 128)
    fwd = fwd_name(route, 128)
    compared = [f"flash_attention_bwd_{k}{ROW_SUFFIX[pair_name(r, 128)]}" for r in (pair_route, "cuda_core")
                for k in ("dq", "dkv")] + [FWD_ROWS[fwd], FWD_ROWS["cuda_core"]]
    unmeasured = [row for row in compared if timings[row]["kernel_device_ms"] is None]
    if unmeasured:
        raise RuntimeError(f"{name} {dtype}: no trace kept a launch of {unmeasured}")
    base = {"shape": name, "bh": bh, "T": t, "S": s, "rate": rate, "dtype": str(dtype).replace("torch.", ""),
            "card": CARD[0]}
    wins = pair_device[pair_route] <= pair_device["cuda_core"]
    rows = [timings[f"flash_attention_bwd_{k}{ROW_SUFFIX[pair]}"] for k in ("dq", "dkv")]
    emit({"phase": "d128_pair_wins", **base, f"{pair}_pair_device_ms": pair_device[pair_route],
          "cuda_core_pair_device_ms": pair_device["cuda_core"],
          "fused_device_ms": timings["flash_attention_bwd_fused"]["kernel_device_ms"],
          "sdpa_backward_device_ms": bwd_common.get("library_device_ms"),
          "sdpa_backward_backend": bwd_common.get("library_device_backend"),
          "bound_ms_dq_dkv": [r["bound_ms"] for r in rows], "bound_by": [r["bound_by"] for r in rows],
          "plain_ms": plain_bwd_ms, f"{pair}_pair_wins": wins})
    if not wins:
        raise AssertionError(f"the CUDA-core pair beat the D 128 tensor-core pair at {name} {dtype}: {pair_device}")
    tc, cc = timings[FWD_ROWS[fwd]], timings[FWD_ROWS["cuda_core"]]
    wins = tc["kernel_device_ms"] <= cc["kernel_device_ms"]
    flag = {"tc": "tc128_fwd_wins", "tf32x3": "tf32x3_fwd_wins"}[route]
    emit({"phase": "d128_fwd_wins", **base, f"{fwd}_fwd_device_ms": tc["kernel_device_ms"],
          "cuda_core_fwd_device_ms": cc["kernel_device_ms"],
          "sdpa_forward_device_ms": fwd_library.get("library_device_ms"),
          "sdpa_forward_backend": fwd_library.get("library_device_backend"),
          "bound_ms": tc["bound_ms"], "bound_by": tc["bound_by"], "plain_ms": plain_fwd_ms, flag: wins})
    if not wins:
        raise AssertionError(f"the CUDA-core forward beat the D 128 tensor-core forward at {name} {dtype}: "
                             f"{tc['kernel_device_ms']} against {cc['kernel_device_ms']}")


def check_determinism(name, pair_call, fused_call, pair, fused, d, dtype):
    """The call's default pair (tensor cores at D 32, 64 and 128) and the
    fused kernel (its dQ added in kv-tile order) again on the same inputs:
    each bitwise equal to its first run, in dq, dk and dv (asserted)."""
    pair2 = [x[..., :d] for x in pair_call()]
    fused2 = [x[..., :d] for x in fused_call()]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(pair, pair2)]
    fused_same = [torch.equal(a, b) for a, b in zip(fused, fused2)]
    spread = [(a.float() - b.float()).abs().max().item() for a, b in zip(fused, fused2)]
    emit({"phase": "backward_determinism", "shape": name, "dtype": str(dtype).replace("torch.", ""),
          "pair_bitwise_equal_dq_dk_dv": same, "fused_bitwise_equal_dq_dk_dv": fused_same,
          "fused_max_abs_spread_dq_dk_dv": spread, "card": CARD[0]})
    if not all(same):
        raise AssertionError(f"the {dtype} split pair is not deterministic at {name}: {same}")
    if not all(fused_same):
        raise AssertionError(f"the {dtype} fused backward is not deterministic at {name}: {fused_same}, "
                             f"spread {spread}")


# ---------------------------------------------------------------------------
# 6. serve
# ---------------------------------------------------------------------------

def make_request(rng, n, lo, hi, max_frames):
    lengths = rng.randint(lo, hi + 1, size=n).astype(np.int64)
    lengths[0] = max_frames
    feats = rng.randn(n, max_frames, N_MELS).astype(np.float32)
    return {"net_input": {"src_tokens": feats, "src_lengths": lengths}}


def check_hypotheses(hypos, eos, n):
    if len(hypos) != n:
        raise AssertionError(f"{len(hypos)} hypothesis lists for {n} utterances")
    for sent in hypos:
        if not sent:
            raise AssertionError("an utterance finished without hypotheses")
        scores = [h["score"] for h in sent]
        if not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"scores not finite and sorted: {scores}")
        for h in sent:
            if len(h["tokens"]) == 0 or int(h["tokens"][-1]) != eos:
                raise AssertionError(f"hypothesis does not end in eos: {h['tokens']}")
            if not np.isfinite(h["positional_scores"]).all():
                raise AssertionError("non-finite positional scores")


def teacher_forced_tokens(hypos, pad, eos, key="tokens"):
    """The top hypotheses' ``key`` (tokens, or the two-phase
    ``transcript_tokens``) shifted right after eos, pads at the tails."""
    tops = [sent[0][key] for sent in hypos]
    width = max(len(t) for t in tops)
    prev = np.full((len(tops), width), pad, np.int64)
    for i, t in enumerate(tops):
        prev[i, 0] = eos
        prev[i, 1:len(t)] = t[:-1]
    return prev


def serve(card, d, fa, dconv, single, attention, build_model, SequenceGenerator):
    model = build_model(
        "conv_transformer", d, seed=0, input_feat_per_channel=N_MELS,
        max_source_positions=2048, max_target_positions=512,
    )
    gen = SequenceGenerator(d, beam_size=BEAM, max_len_b=MAX_LEN_B)
    rng = np.random.RandomState(0)
    requests = [
        ("bench_decode_32x409-512", make_request(rng, 32, 409, 512, 512)),
        ("long_8x2400-3000", make_request(rng, 8, 2400, 3000, 3000)),
        ("single_1x512", make_request(rng, 1, 512, 512, 512)),
    ]
    attention.set_flash_attention(None)  # auto: every eligible call on the card
    gen.generate([model], requests[2][1])  # warm-up (cuDNN plans, allocator)

    reset_counts(fa, dconv, single)
    served = []
    for name, sample in requests:
        before = launch_counts(fa, dconv, single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n = len(sample["net_input"]["src_lengths"])
        check_hypotheses(hypos, d.eos(), n)
        grew = {k: c - before[k] for k, c in launch_counts(fa, dconv, single).items()}
        want = {k: FLASH_LAUNCHES_PER_REQUEST if k == FP32_FORWARD else 0 for k in grew}
        if grew != want:
            raise AssertionError(f"{name}: launches grew by {grew}, expected {FLASH_LAUNCHES_PER_REQUEST} "
                                 f"{FP32_FORWARD} and nothing else")
        grew = grew[FP32_FORWARD]
        audio_s = float(sample["net_input"]["src_lengths"].sum()) * FRAME_SECONDS
        served.append((name, sample, hypos))
        emit({"phase": "serve", "request": name, "utterances": n, "decode_s": decode_s,
              "audio_s": audio_s, "rtf": decode_s / audio_s, "flash_launches": grew, "forward": FP32_FORWARD,
              "mean_hyp_len": float(np.mean([len(s[0]["tokens"]) for s in hypos])),
              "card": card})
    launches = launch_counts(fa, dconv, single)

    # where the time goes in the first request: the encoder alone, then the
    # device's busy time over a profiled run of the whole request
    name, sample, hypos = served[0]
    src = torch.as_tensor(sample["net_input"]["src_tokens"], device="cuda")
    lengths = torch.as_tensor(sample["net_input"]["src_lengths"], device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(src, lengths)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
    wall_s, busy_s, top, classes = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile", "request": name, "encode_s": encode_s,
          "decode_s_profiled": wall_s, "device_busy_s": busy_s,
          "device_idle_share_profiled": 1.0 - busy_s / wall_s,
          "top_kernels_s": top, "busy_by_class_s": classes, "card": card})

    # flash route against the dense route on the first request
    batch = {"src_tokens": src, "src_lengths": lengths,
             "prev_output_tokens": torch.as_tensor(teacher_forced_tokens(hypos, d.pad(), d.eos()), device="cuda")}
    with torch.no_grad():
        before = fa.launches
        logits_flash, extra_flash = model(batch)
        tf_launches = fa.launches - before
        attention.set_flash_attention(False)
        logits_dense, extra_dense = model(batch)
        hypos_dense = gen.generate([model], sample)
        attention.set_flash_attention(None)
    enc_err = (extra_flash["encoder_out"].encoder_out - extra_dense["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_flash - logits_dense).abs().max().item()
    same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos, hypos_dense))
    emit({"phase": "flash_vs_dense", "request": name, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL,
          "teacher_forced_flash_launches": tf_launches,
          "identical_top_hypotheses": f"{same}/{len(hypos)}"})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("flash and dense routes disagree on the full-width model")

    # the card against the plain CPU path on the small request
    name, sample, hypos = served[2]
    cpu_model = build_model(
        "conv_transformer", d, device="cpu", seed=0, input_feat_per_channel=N_MELS,
        max_source_positions=2048, max_target_positions=512,
    )
    prev = teacher_forced_tokens(hypos, d.pad(), d.eos())
    batch_cpu = {"src_tokens": torch.as_tensor(sample["net_input"]["src_tokens"]),
                 "src_lengths": torch.as_tensor(sample["net_input"]["src_lengths"]),
                 "prev_output_tokens": torch.as_tensor(prev)}
    with torch.no_grad():
        logits_cpu, extra_cpu = cpu_model(batch_cpu)
        logits_gpu, extra_gpu = model({k: v.cuda() for k, v in batch_cpu.items()})
    enc_err = (extra_gpu["encoder_out"].encoder_out.cpu() - extra_cpu["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    hypos_cpu = gen.generate([cpu_model], sample)
    same = list(hypos_cpu[0][0]["tokens"]) == list(hypos[0][0]["tokens"])
    emit({"phase": "card_vs_cpu", "request": name, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL, "identical_top_hypothesis": same})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("the card and the plain CPU path disagree on the full-width model")
    return launches


# ---------------------------------------------------------------------------
# 7. train
# ---------------------------------------------------------------------------

def train_args(**overrides):
    """The arguments of bench.py:63-82 under the JAX package's names."""
    args = dict(
        arch="conv_transformer", criterion="label_smoothed_cross_entropy", label_smoothing=0.1,
        optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-8, weight_decay=0.0,
        lr=[0.002], lr_scheduler="inverse_sqrt", warmup_updates=4000, warmup_init_lr=-1.0,
        clip_norm=10.0, bf16=True, max_source_positions=2048, max_target_positions=512,
        input_feat_per_channel=N_MELS, seed=1,
    )
    args.update(overrides)
    return types.SimpleNamespace(**args)


def train_sample(d, rng, batch=TRAIN_BATCH, frames=TRAIN_FRAMES):
    """bench.py::_host_sample: lengths in [0.8 frames, frames], random
    target tokens after eos."""
    lengths = rng.randint(int(frames * 0.8), frames + 1, size=batch).astype(np.int64)
    lengths[0] = frames
    prev = rng.randint(4, VOCAB - 1, size=(batch, TGT_LEN)).astype(np.int64)
    prev[:, 0] = d.eos()
    target = np.concatenate([prev[:, 1:], np.full((batch, 1), d.eos())], axis=1).astype(np.int64)
    return {
        "net_input": {
            "src_tokens": rng.randn(batch, frames, N_MELS).astype(np.float32),
            "src_lengths": lengths,
            "prev_output_tokens": prev,
        },
        "target": target,
        "ntokens": int((target != d.pad()).sum()),
        "nsentences": batch,
    }


def staged(sample, dtype, device="cuda"):
    """The sample's arrays on the device ahead of the step, the features in
    the compute type (bench.py's stage_sample)."""
    put = lambda x, fl=False: torch.as_tensor(x).to(device, dtype if fl else None)  # noqa: E731
    net = sample["net_input"]
    return {**sample, "target": put(sample["target"]),
            "net_input": {"src_tokens": put(net["src_tokens"], True), "src_lengths": put(net["src_lengths"]),
                          "prev_output_tokens": put(net["prev_output_tokens"])}}


def train_flops(enc, dec, batch, frames, tgt_len):
    """FLOPs of one train step: 3x the forward's, counting 2 per multiply-add
    of every matmul, conv and attention product at the padded shapes:

      conv i (c_in -> c_out, k_t x k_f, stride 2):  2 B c_out T_i F_i k_t k_f c_in
      ConvAttention2D (H heads, C channels), per block:
          qkv conv 2 B 3H T F 9 C + out conv 2 B C T F 9 2H
          + time attention 4 B H T T F + frequency attention 4 B H F F T
      fc3: 2 B T (C F) E
      encoder layer: 8 B T E^2 (q, k, v, out) + 4 B T E FFN + 4 B T T E
      decoder layer: 8 B L E^2 (self) + 4 B L E^2 + 4 B T E^2 (cross q/out,
          k/v on the encoder) + 4 B L E FFN + 4 B E (L(L+1)/2 + L T)
      output projection: 2 B L E V
    """
    fr = enc.frontend
    b, f, t, c_in = batch, fr.audio_features, frames, 1
    fwd = 0.0
    for c_out, kt, kf in fr.convolutions:
        t, f = math.ceil(t / fr.stride), math.ceil(f / fr.stride)
        fwd += 2.0 * b * c_out * t * f * kt * kf * c_in
        c_in = c_out
    if fr.attn_2d:
        h, c = fr.attn_2d_heads, c_in
        per_block = (2.0 * b * 3 * h * t * f * 9 * c + 2.0 * b * c * t * f * 9 * 2 * h
                     + 4.0 * b * h * t * t * f + 4.0 * b * h * f * f * t)
        fwd += 2 * per_block
    e = enc.embed_dim
    fwd += 2.0 * b * t * (c_in * f) * e
    fwd += enc.layers * (8.0 * b * t * e * e + 4.0 * b * t * e * enc.ffn_dim + 4.0 * b * t * t * e)
    return 3.0 * (fwd + decoder_flops(dec, b, t, tgt_len))


def decoder_flops(dec, b, t, l):
    """The forward FLOPs of a teacher-forced decoder of ``l`` positions
    over ``t`` encoder rows (``train_flops``' decoder terms)."""
    ed = dec.embed_dim
    fwd = dec.layers * (8.0 * b * l * ed * ed + 4.0 * b * l * ed * ed + 4.0 * b * t * ed * ed
                        + 4.0 * b * l * ed * dec.ffn_dim + 4.0 * b * ed * (l * (l + 1) / 2 + l * t))
    return fwd + 2.0 * b * l * ed * dec.vocab_size


def train(card, d, fa, dconv, single, modules):
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args()
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged(train_sample(d, np.random.RandomState(0)), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    flops = train_flops(model.encoder_cfg, model.decoder_cfg, TRAIN_BATCH, TRAIN_FRAMES, TGT_LEN)

    outs = []
    for _ in range(WARMUP_STEPS):
        outs.append(trainer.train_step([sample]))
    torch.cuda.synchronize()

    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite(gnorms).all()):
        raise AssertionError("non-finite loss or gnorm in the train phase")
    first, last = float(np.mean(per_token[1:6])), float(np.mean(per_token[-5:]))
    if not last < first:
        raise AssertionError(f"the loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    emit({"phase": "train", "arch": "conv_transformer", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "tgt_len": TGT_LEN, "dtype": "bfloat16", "forward": BF16_FORWARD, "backward": BF16_BACKWARD,
          "step_ms_median": median, "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "flash_launches_per_step":
          {k: v / steps for k, v in launches.items()}, "peak_memory_gb": peak_gb,
          "loss_per_token_first": per_token[0], "loss_per_token_steps_1_5": first,
          "loss_per_token_last5": last, "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]),
          "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})

    # the same path with each backward forced, in short runs: the fused
    # kernel and the split pair in bf16; then the fp32 step by its own rule,
    # the tf32x3 forward and pair
    total = dict(launches)
    fp32_args = train_args(bf16=False)
    fp32_trainer = Trainer(fp32_args, task, task.build_model(fp32_args), task.build_criterion(fp32_args))
    fp32_sample = staged(train_sample(d, np.random.RandomState(0)), torch.float32)
    for route, fused, tr, smp, dtype, n in (("fused", True, trainer, sample, torch.bfloat16, SPLIT_STEPS),
                                             ("split_tc", False, trainer, sample, torch.bfloat16, SPLIT_STEPS),
                                             (FP32_BACKWARD, None, fp32_trainer, fp32_sample, torch.float32, 2)):
        forward = BF16_FORWARD if dtype == torch.bfloat16 else FP32_FORWARD
        with fa.backward_forced(fused):
            tr.train_step([smp])
            torch.cuda.synchronize()
            reset_counts(fa, dconv, single)
            t0 = time.perf_counter()
            for _ in range(n):
                tr.train_step([smp])
            torch.cuda.synchronize()
            forced_ms = (time.perf_counter() - t0) / n * 1e3
            got = launch_counts(fa, dconv, single)
            want = step_launches(got, n, CT_FLASH_CALLS_PER_STEP, route, forward)
        if got != want:
            raise AssertionError(f"{route} backward ({dtype}) launches {got}, expected {want}")
        emit({"phase": "train", "backward": route, "forward": forward,
              "dtype": str(dtype).replace("torch.", ""), "steps": n, "step_ms": forced_ms,
              "flash_launches_per_step": {k: v / n for k, v in got.items()}, "card": card})
        total = {k: total[k] + got[k] for k in total}
    wall_s, busy_s, top, classes = profile_window(lambda: fp32_trainer.train_step([fp32_sample]))
    emit({"phase": "train_fp32_profile", "forward": FP32_FORWARD, "backward": FP32_BACKWARD, "step_s": wall_s,
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top,
          "busy_by_class_s": classes, "card": card})
    del fp32_trainer
    return total


def step_launches(counts, steps, calls, route=BF16_BACKWARD, forward=BF16_FORWARD):
    """The launches ``steps`` train steps make, as ``counts``' keys:
    ``calls`` flash forwards a step by the kernel ``forward`` and as many
    backwards by ``route`` (``BACKWARD_KERNELS``), besides nothing else."""
    want = {k: 0 for k in counts}
    for name in (forward,) + BACKWARD_KERNELS[route]:
        want[name] = steps * calls
    return want


class _EvalCriterion:
    """The criterion in eval mode (no dropout, BatchNorm running stats):
    the deterministic step of tests/test_corpus_parity.py."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, model, batch, generator=None, training=False):
        return self.criterion(model, batch, generator, training=False)


def one_step(d, modules, device, sample, deterministic=False, **overrides):
    """A fresh full-width fp32 model (seed 1) after one train step with
    lr 2e-3 from the first update; returns (model, step outputs)."""
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                      warmup_updates=1, warmup_init_lr=0.002, **overrides)
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    out = trainer.train_step([sample])
    return model, out


def compare_steps(label, a, b, forward, lr=0.002):
    """One train step of two paths: loss, gnorm, the gradients' global
    relative difference and the largest parameter difference, against the
    tolerances of ``forward`` ("same_forward" or "other_forward")."""
    (model_a, out_a), (model_b, out_b) = a, b
    loss_a, loss_b = float(out_a["loss"]), float(out_b["loss"])
    gn_a, gn_b = float(out_a["gnorm"]), float(out_b["gnorm"])
    pa = dict(model_a.named_parameters())
    num = den = 0.0
    max_dp = 0.0
    apart = {}
    for name, p in model_b.named_parameters():
        q = pa[name]
        ga, gb = q.grad.detach().double().cpu(), p.grad.detach().double().cpu()
        num += float((ga - gb).square().sum())
        den += float(ga.square().sum())
        dp = (q.detach().cpu() - p.detach().cpu()).abs()
        max_dp = max(max_dp, float(dp.max()))
        apart[name] = int((dp > lr).sum())
    moved_apart = sum(apart.values())
    most_apart = sorted(((n, c) for n, c in apart.items() if c), key=lambda nc: -nc[1])[:4]
    grad_rel = (num / max(den, 1e-30)) ** 0.5
    rtol = RTOL_STEP_GRAD[forward]
    row = {"phase": "train_step_check", "check": label, "loss": [loss_a, loss_b], "gnorm": [gn_a, gn_b],
           "loss_rel_err": abs(loss_a - loss_b) / abs(loss_b), "gnorm_rel_err": abs(gn_a - gn_b) / abs(gn_b),
           "grad_global_rel_diff": grad_rel, "max_param_abs_diff": max_dp,
           "param_elements_apart_by_more_than_lr": moved_apart, "most_apart": most_apart,
           "loss_rtol": RTOL_STEP_LOSS, "grad_rtol": rtol}
    emit(row)
    if not (row["loss_rel_err"] <= RTOL_STEP_LOSS and row["gnorm_rel_err"] <= rtol
            and grad_rel <= rtol and max_dp <= 2 * lr + 1e-6):
        raise AssertionError(f"train-step check {label} failed: {row}")


def counted_step(fa, want, *args, step_fn=None, **kwargs):
    """``step_fn(*args)`` (``one_step`` by default) with the flash launches
    of its step held to ``want`` ({kernel: launches}, every other flash
    kernel 0)."""
    fa.reset_launches()
    step = (step_fn or one_step)(*args, **kwargs)
    got = {"flash_" + name.removeprefix("launches_"): getattr(fa, name) for name in fa._COUNTERS}
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"an fp32 cross-check step launched {got}, expected {want}")
    return step


def check_train_steps(d, fa, attention, modules):
    """fp32 steps (TF32 off): flash (the tf32x3 forward and pair, 20 + 20 +
    20 launches) against dense (none), the fused backward (20 tf32x3
    forwards + 20 fused) against the tf32x3 pair, and the card against the
    CPU."""
    calls = CT_FLASH_CALLS_PER_STEP
    tf32x3 = {FP32_FORWARD: calls, **{k: calls for k in BACKWARD_KERNELS[FP32_BACKWARD]}}
    sample = staged(train_sample(d, np.random.RandomState(1), batch=32), torch.float32)
    attention.set_flash_attention(None)
    flash = counted_step(fa, tf32x3, d, modules, "cuda", sample)
    attention.set_flash_attention(False)
    dense = counted_step(fa, {}, d, modules, "cuda", sample)
    attention.set_flash_attention(None)
    compare_steps("flash_vs_dense", flash, dense, "other_forward")

    with fa.backward_forced(True):  # fp32: the fused kernel after the tf32x3 forward
        fused = counted_step(fa, {FP32_FORWARD: calls, "flash_bwd_fused": calls}, d, modules, "cuda", sample)
    compare_steps("fused_vs_split", fused, flash, "same_forward")

    # the plain CPU path (dense: auto mode sends no CPU call to the flash
    # route) against the card's flash route, and the floor: its dense route
    small = train_sample(d, np.random.RandomState(2), batch=2)
    cpu = one_step(d, modules, "cpu", staged(small, torch.float32, device="cpu"), deterministic=True)
    card = one_step(d, modules, "cuda", staged(small, torch.float32), deterministic=True)
    compare_steps("card_vs_cpu", card, cpu, "other_forward")
    attention.set_flash_attention(False)
    card_dense = one_step(d, modules, "cuda", staged(small, torch.float32), deterministic=True)
    attention.set_flash_attention(None)
    compare_steps("dense_card_vs_cpu", card_dense, cpu, "other_forward")


# ---------------------------------------------------------------------------
# 5. dynamic-conv kernels
# ---------------------------------------------------------------------------

def valid_taps(t: int, k: int, padding_l: int) -> int:
    """(position, tap) pairs whose input t + tap - padding_l lies in [0, T):
    the multiply-adds a channel needs (taps on the zero halo need none)."""
    return sum(max(0, min(t, pos + k - padding_l) - max(0, pos - padding_l)) for pos in range(t))


def dconv_bound_ms(kind, b, t, c, h, k, padding_l, dtype):
    """The forward moves x, w in and out back; the backward x, w, g in and
    dx, dw out. Multiply-adds: B C valid_taps for out, twice that for dx
    and dw."""
    item = torch.tensor([], dtype=dtype).element_size()
    xs, ws = b * t * c, b * t * h * k
    nbytes = item * ((2 * xs + ws) if kind == "fwd" else (3 * xs + 2 * ws))
    macs = b * c * valid_taps(t, k, padding_l) * (1 if kind == "fwd" else 2)
    return bound_ms(nbytes, 2.0 * macs, dtype)


def dconv_device_ms(fn, kernel, cold=None):
    """The median device launch of ``kernel`` in calls of ``fn``; with
    ``cold``, a buffer over the L2's size written before each call. A trace
    may catch no launch at all (one chip run saw three such in a row at one
    call), so up to six are taken."""
    call = fn if cold is None else (lambda: (cold.zero_(), fn()))
    ms = device_ms(call, kernel + "_kernel", tries=6)
    if ms is None:
        raise AssertionError(f"no {kernel} launch in six traces")
    return ms


def dconv_paired_device_ms(calls, rounds=DCONV_PAIRED_ROUNDS, tries=6):
    """The median device launch of each kernel of ``calls`` ({kernel: fn},
    each fn launching that kernel once), the calls interleaved round by
    round in one trace, so that every kernel sees the same clocks and the
    same L2, and the number of launches the trace kept of each. A trace
    that kept fewer than half the launches of some kernel (chip runs saw
    traces keep 2 of 10) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                for fn in calls.values():
                    fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        times = {kernel: [e.device_time_total for e in events if kernel + "_kernel" in e.name]
                 for kernel in calls}
        if all(2 * len(t) >= rounds for t in times.values()):
            return {kernel: (float(np.median(t)) / 1e3, len(t)) for kernel, t in times.items()}
    raise AssertionError(f"no trace kept half of {rounds} launches of each of {sorted(calls)} in {tries} tries")


def check_dconv_kernels(dconv):
    """Each dynamic-conv call in fp32 and bf16: the tensor-core forward and
    backward (every model path's) and the CUDA-core pair (a direct call)
    against the plain versions on the same inputs, the tensor-core backward
    bitwise equal across two launches; times and bounds, the bf16
    ``DCONV_COLD_AT`` rows also with a cold L2; and whether the tensor-core
    kernels' median launch is at most the CUDA-core ones' at every main-path
    call in both types (``dconv_tc_wins_everywhere``, asserted), the two
    routes' launches interleaved in one trace (``dconv_paired_device_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cold = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    rows = []
    worst = {(kind, dtype): 0.0 for kind in ("fwd", "bwd", "fwd_tc", "bwd_tc")
             for dtype in (torch.float32, torch.bfloat16)}
    wins = {}
    for name, b, t, c, h, k, pad_l in DCONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            w = torch.softmax(torch.randn((b, t, h, k), generator=gen, device="cuda"), dim=-1).to(dtype)
            g = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            out_p = dconv.dynamic_conv_reference(x, w, pad_l)
            dx_p, dw_p = dconv.dynamic_conv_backward_reference(x, w, g, pad_l)
            dw_tol = RTOL_DW[dtype] * dw_p.float().abs().max().item()
            err = lambda a, b_: (a.float() - b_.float()).abs().max().item()  # noqa: E731
            base = {"phase": "dconv_kernel_check", "shape": name, "B": b, "T": t, "C": c, "H": h, "K": k,
                    "padding_l": pad_l, "dtype": str(dtype).replace("torch.", ""), "library_ms": None}
            plain = {"fwd": time_ms(lambda: dconv.dynamic_conv_reference(x, w, pad_l)),
                     "bwd": time_ms(lambda: dconv.dynamic_conv_backward_reference(x, w, g, pad_l))}
            bounds = {kind: dconv_bound_ms(kind, b, t, c, h, k, pad_l, dtype) for kind in ("fwd", "bwd")}
            calls = {}
            for route, (fwd_name, bwd_name) in DCONV_ROUTES.items():
                out_k = dconv.dynamic_conv_forward(x, w, pad_l, route=route)
                dx_k, dw_k = dconv.dynamic_conv_backward(x, w, g, pad_l, route=route)
                torch.cuda.synchronize()
                errs = {"fwd": err(out_k, out_p), "dx": err(dx_k, dx_p), "dw": err(dw_k, dw_p)}
                suffix = "_tc" if route == "tc" else ""
                worst[("fwd" + suffix, dtype)] = max(worst[("fwd" + suffix, dtype)], errs["fwd"])
                worst[("bwd" + suffix, dtype)] = max(worst[("bwd" + suffix, dtype)], errs["dx"], errs["dw"])
                repeat = None
                if route == "tc":
                    dx_2, dw_2 = dconv.dynamic_conv_backward(x, w, g, pad_l, route=route)
                    repeat = bool(torch.equal(dx_2, dx_k) and torch.equal(dw_2, dw_k))
                fwd = lambda route=route: dconv.dynamic_conv_forward(x, w, pad_l, route=route)  # noqa: E731
                bwd = lambda route=route: dconv.dynamic_conv_backward(x, w, g, pad_l, route=route)  # noqa: E731
                calls[fwd_name], calls[bwd_name] = fwd, bwd
                timings = {
                    fwd_name: dict(kernel_ms=time_ms(fwd), kernel_device_ms=dconv_device_ms(fwd, fwd_name),
                                   plain_ms=plain["fwd"], max_abs_err=errs["fwd"], atol=ATOL_KERNEL[dtype],
                                   bound=bounds["fwd"]),
                    bwd_name: dict(kernel_ms=time_ms(bwd), kernel_device_ms=dconv_device_ms(bwd, bwd_name),
                                   plain_ms=plain["bwd"], max_abs_err=max(errs["dx"], errs["dw"]),
                                   dx_max_abs_err=errs["dx"], dw_max_abs_err=errs["dw"], atol=ATOL_GRAD[dtype],
                                   dw_tol=dw_tol, bitwise_repeat=repeat, bound=bounds["bwd"]),
                }
                if name in DCONV_COLD_AT and dtype == torch.bfloat16:
                    timings[fwd_name]["kernel_device_ms_cold"] = dconv_device_ms(fwd, fwd_name, cold)
                    timings[bwd_name]["kernel_device_ms_cold"] = dconv_device_ms(bwd, bwd_name, cold)
                for kernel, tm in timings.items():
                    tm["bound_ms"], tm["bound_by"] = tm.pop("bound")
                    row = {**base, "kernel": kernel, "route": route, **tm}
                    emit(row)
                    rows.append(row)
                ok = errs["fwd"] <= ATOL_KERNEL[dtype] and errs["dx"] <= ATOL_GRAD[dtype] and errs["dw"] <= dw_tol
                if not ok:
                    raise AssertionError(f"dynamic conv ({route}) disagrees with its plain version at {name} "
                                         f"{dtype}: {errs}, dw tolerance {dw_tol}")
                if repeat is False:
                    raise AssertionError(f"dynamic_conv_bwd_tc is not bitwise repeatable at {name} {dtype}")
            if name in DCONV_MAIN_SHAPES:
                call = wins[f"{name} {base['dtype']}"] = {}
                for i, kind in enumerate(("fwd", "bwd")):
                    tc, cc = DCONV_ROUTES["tc"][i], DCONV_ROUTES["cuda_core"][i]
                    paired = dconv_paired_device_ms({tc: calls[tc], cc: calls[cc]})
                    call[kind] = paired[tc][0] <= paired[cc][0]
                    call[kind + "_ms"] = [paired[tc][0], paired[cc][0]]
                    call[kind + "_launches_kept"] = [paired[tc][1], paired[cc][1]]
    everywhere = all(v["fwd"] and v["bwd"] for v in wins.values())
    emit({"phase": "dconv_tc_wins", "dconv_tc_wins_everywhere": everywhere, "calls": len(wins), "by_call": wins,
          "card": CARD[0]})
    if not everywhere:
        lost = sorted(call for call, v in wins.items() if not (v["fwd"] and v["bwd"]))
        raise AssertionError(f"the tensor-core dynamic conv is slower than the CUDA-core kernels at {lost}")
    return rows, worst


# ---------------------------------------------------------------------------
# 9.-11. the lightconv paths
# ---------------------------------------------------------------------------

def lc_dictionary(Dictionary):
    d = Dictionary()
    for i in range(LC_VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)
    return d


def text_pairs(rng, n, lo, hi, vocab, tgt=None):
    """n random sentences of lo-hi tokens (the last one eos), and targets
    of ``tgt`` = (lo, hi) tokens when given; the first source is hi long."""
    lengths = rng.randint(lo, hi + 1, size=n)
    lengths[0] = hi
    src = [np.append(rng.randint(4, vocab, size=m - 1), 2) for m in lengths]
    if tgt is None:
        return src, None
    tgt_lengths = rng.randint(tgt[0], tgt[1] + 1, size=n)
    return src, [np.append(rng.randint(4, vocab, size=m - 1), 2) for m in tgt_lengths]


def collate(LanguagePairDataset, src_dict, tgt_dict, src, tgt=None):
    """The port's collater over all pairs (sources padded on the left)."""
    ds = LanguagePairDataset(src, [len(s) for s in src], src_dict, tgt,
                             None if tgt is None else [len(t) for t in tgt], tgt_dict)
    return ds.collater([ds[i] for i in range(len(src))])


def launch_counts(fa, dconv, single):
    counts = {"flash_" + name.removeprefix("launches_"): getattr(fa, name) for name in fa._COUNTERS}
    return {**counts, "dconv_fwd": dconv.launches_fwd, "dconv_bwd": dconv.launches_bwd,
            "dconv_fwd_tc": dconv.launches_fwd_tc, "dconv_bwd_tc": dconv.launches_bwd_tc,
            "flash_fwd_single": single.launches}


def reset_counts(fa, dconv, single):
    fa.reset_launches()
    dconv.reset_launches()
    single.reset_launches()


def serve_lightconv(card, dicts, fa, dconv, single, modules):
    build_model, SequenceGenerator = modules["build_model"], modules["SequenceGenerator"]
    LanguagePairDataset = modules["LanguagePairDataset"]
    src_dict, tgt_dict = dicts
    model = build_model(LC_ARCH, tgt_dict, src_dict, seed=0)
    params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    emit({"phase": "lightconv_model", "arch": LC_ARCH, "params": params, "embed_dim": cfg.embed_dim,
          "ffn_dim": cfg.ffn_dim, "heads": cfg.encoder_layers[0].heads, "conv_dim": cfg.encoder_layers[0].conv_dim,
          "encoder_kernels": [lc.kernel_size for lc in cfg.encoder_layers],
          "decoder_kernels": [lc.kernel_size for lc in cfg.decoder_layers],
          "glu": cfg.encoder_layers[0].glu, "dropout": cfg.dropout,
          "attention_dropout": cfg.encoder_layers[0].attention_dropout,
          "weight_dropout": cfg.encoder_layers[0].weight_dropout,
          "input_dropout": cfg.encoder_layers[0].input_dropout,
          "src_vocab": cfg.src_vocab, "tgt_vocab": cfg.tgt_vocab, "use_kernel": model.use_kernel})
    gen = SequenceGenerator(tgt_dict, beam_size=BEAM, max_len_b=MAX_LEN_B)
    rng = np.random.RandomState(3)
    requests = [(name, collate(LanguagePairDataset, src_dict, tgt_dict, text_pairs(rng, n, lo, hi, LC_VOCAB)[0]))
                for name, n, lo, hi in (("wmt_32x10-60", 32, 10, 60), ("long_8x200-250", 8, 200, 250),
                                        ("single_1x30", 1, 30, 30))]
    gen.generate([model], requests[2][1])  # warm-up

    reset_counts(fa, dconv, single)
    served = []
    for name, sample in requests:
        before = launch_counts(fa, dconv, single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n = len(sample["net_input"]["src_lengths"])
        check_hypotheses(hypos, tgt_dict.eos(), n)
        grew = {k: v - before[k] for k, v in launch_counts(fa, dconv, single).items()}
        want = {k: DCONV_LAUNCHES_PER_REQUEST if k == DCONV_FORWARD else 0 for k in grew}
        if grew != want:
            raise AssertionError(f"{name}: launches grew by {grew}, expected {want}")
        src_tokens = int(sample["net_input"]["src_lengths"].sum())
        served.append((name, sample, hypos))
        emit({"phase": "serve_lightconv", "request": name, "sentences": n, "decode_s": decode_s,
              "source_tokens": src_tokens, "source_tokens_per_s": src_tokens / decode_s,
              "launches": grew, "mean_hyp_len": float(np.mean([len(s[0]["tokens"]) for s in hypos])),
              "card": card})
    launches = launch_counts(fa, dconv, single)

    name, sample, hypos = served[0]
    wall_s, busy_s, top, classes = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile_lightconv", "request": name, "decode_s_profiled": wall_s, "device_busy_s": busy_s,
          "device_idle_share_profiled": 1.0 - busy_s / wall_s, "top_kernels_s": top,
          "busy_by_class_s": classes, "card": card})

    # the kernel route against the plain route of the dynamic conv
    def teacher_forced(sample, hypos, device="cuda"):
        net = sample["net_input"]
        return {"src_tokens": torch.as_tensor(net["src_tokens"], device=device),
                "src_lengths": torch.as_tensor(net["src_lengths"], device=device),
                "prev_output_tokens": torch.as_tensor(
                    teacher_forced_tokens(hypos, tgt_dict.pad(), tgt_dict.eos()), device=device)}

    for name, sample, hypos in served:
        batch = teacher_forced(sample, hypos)
        with torch.no_grad():
            logits_k, extra_k = model(batch)
            model.use_kernel = False
            logits_p, extra_p = model(batch)
            hypos_p = gen.generate([model], sample)
            model.use_kernel = True
        enc_err = (extra_k["encoder_out"].encoder_out - extra_p["encoder_out"].encoder_out).abs().max().item()
        logit_err = (logits_k - logits_p).abs().max().item()
        same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos, hypos_p))
        del logits_k, logits_p
        emit({"phase": "lightconv_kernel_vs_plain", "request": name, "encoder_max_abs_err": enc_err,
              "logits_max_abs_err": logit_err, "atol": ATOL_MODEL,
              "identical_top_hypotheses": f"{same}/{len(hypos)}"})
        if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL and same == len(hypos)):
            raise AssertionError(f"{name}: the dynamic conv's kernel and plain routes disagree on the "
                                 "full-width model")

    # the card against the plain CPU path on 2 sentences
    two_src, _ = text_pairs(np.random.RandomState(4), 2, 20, 30, LC_VOCAB)
    two = collate(LanguagePairDataset, src_dict, tgt_dict, two_src)
    hypos_two = gen.generate([model], two)
    cpu_model = build_model(LC_ARCH, tgt_dict, src_dict, device="cpu", seed=0)
    with torch.no_grad():
        logits_cpu, extra_cpu = cpu_model(teacher_forced(two, hypos_two, "cpu"))
        logits_gpu, extra_gpu = model(teacher_forced(two, hypos_two))
    enc_err = (extra_gpu["encoder_out"].encoder_out.cpu() - extra_cpu["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    hypos_cpu = gen.generate([cpu_model], two)
    same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos_two, hypos_cpu))
    emit({"phase": "lightconv_card_vs_cpu", "sentences": 2, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL, "identical_top_hypotheses": f"{same}/2"})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("the card and the plain CPU path disagree on the full-width lightconv model")
    return launches


def lightconv_train_flops(cfg, batch, src_len, tgt_len):
    """FLOPs of one lightconv train step: 3x the forward's, 2 per
    multiply-add, at the padded shapes (B, S source, L target tokens;
    E embed, Cd conv_dim, F ffn, H heads, K taps, V target vocabulary):

      conv layer on N tokens: 2 B N E Cd (x2 with GLU) + 2 B N Cd H K
          (kernel prediction) + 2 B N Cd K (band) + 2 B N Cd E + 4 B N E F
      decoder layer adds encoder attention: 4 B L E^2 (q, out)
          + 4 B S E^2 (k, v) + 4 B L S E
      output projection: 2 B L E V
    """
    def conv_layer(lc, n):
        lin1 = 2 * lc.conv_dim if lc.glu else lc.conv_dim
        return batch * n * (2.0 * lc.embed_dim * lin1 + 2.0 * lc.conv_dim * lc.heads * lc.kernel_size
                            + 2.0 * lc.conv_dim * lc.kernel_size + 2.0 * lc.conv_dim * lc.embed_dim
                            + 4.0 * lc.embed_dim * lc.ffn_dim)

    e = cfg.embed_dim
    fwd = sum(conv_layer(lc, src_len) for lc in cfg.encoder_layers)
    fwd += sum(conv_layer(lc, tgt_len) + 4.0 * batch * tgt_len * e * e + 4.0 * batch * src_len * e * e
               + 4.0 * batch * tgt_len * src_len * e for lc in cfg.decoder_layers)
    fwd += 2.0 * batch * tgt_len * e * cfg.tgt_vocab
    return 3.0 * fwd


def lc_train_sample(modules, dicts, rng, batch):
    src_dict, tgt_dict = dicts
    src, tgt = text_pairs(rng, batch, *LC_TRAIN_LEN, LC_VOCAB, tgt=LC_TRAIN_LEN)
    return collate(modules["LanguagePairDataset"], src_dict, tgt_dict, src, tgt)


def staged_text(sample, device="cuda"):
    """The collated sample's arrays on the device ahead of the step."""
    put = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    return {**sample, "target": put(sample["target"]),
            "net_input": {k: put(v) for k, v in sample["net_input"].items()}}


def lc_train_args(arch=LC_ARCH, **overrides):
    return train_args(arch=arch, max_source_positions=1024, max_target_positions=1024, **overrides)


def train_lightconv(card, dicts, fa, dconv, single, modules, arch=LC_ARCH, timed_steps=LC_TIMED_STEPS,
                    forward=BF16_FORWARD, backward=BF16_BACKWARD, phase="train_lightconv"):
    """The lightconv step at ``arch``: ``forward`` and ``backward`` are the
    flash routes its decoder's encoder attention takes (the tensor cores at
    head dim 64, and at the iwslt presets' 128 the D 128 tensor-core
    forward and pair)."""
    Trainer, TranslationTask = modules["Trainer"], modules["TranslationTask"]
    args = lc_train_args(arch)
    task = TranslationTask(args, *dicts)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged_text(lc_train_sample(modules, dicts, np.random.RandomState(5), LC_TRAIN_BATCH))
    net = sample["net_input"]
    src_len, tgt_len = net["src_tokens"].shape[1], net["prev_output_tokens"].shape[1]
    flops = lightconv_train_flops(model.cfg, LC_TRAIN_BATCH, src_len, tgt_len)

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / timed_steps * 1e3)
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * timed_steps
    want = step_launches(launches, steps, LC_FLASH_LAUNCHES_PER_STEP, backward, forward)
    want.update({DCONV_FORWARD: DCONV_LAUNCHES_PER_STEP * steps, DCONV_BACKWARD: DCONV_LAUNCHES_PER_STEP * steps})
    if launches != want:
        raise AssertionError(f"{arch} train launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite(gnorms).all()):
        raise AssertionError("non-finite loss or gnorm in the lightconv train phase")
    first, last = float(np.mean(per_token[1:6])), float(np.mean(per_token[-5:]))
    if not last < first:
        raise AssertionError(f"the lightconv loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    tgt_tokens = int(sample["ntokens"])
    emit({"phase": phase, "arch": arch, "batch": LC_TRAIN_BATCH, "src_len": src_len,
          "tgt_len": tgt_len, "target_tokens": tgt_tokens, "dtype": "bfloat16",
          "forward": forward, "backward": backward, "heads": model.cfg.decoder_layers[0].heads,
          "embed_dim": model.cfg.embed_dim, "layers": [len(model.cfg.encoder_layers), len(model.cfg.decoder_layers)],
          "params": sum(p.numel() for p in model.parameters()),
          "step_ms_median": median, "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "target_tokens_per_s": tgt_tokens / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "peak_memory_gb": peak_gb, "loss_per_token_first": per_token[0], "loss_per_token_steps_1_5": first,
          "loss_per_token_last5": last, "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]), "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": phase + "_profile", "arch": arch, "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
    return launches


def one_lc_step(dicts, modules, device, sample, use_kernel, deterministic=False, arch=LC_ARCH):
    """A fresh full-width fp32 lightconv of ``arch`` (seed 1) after one
    train step with lr 2e-3 from the first update; returns (model, step
    outputs)."""
    Trainer, TranslationTask = modules["Trainer"], modules["TranslationTask"]
    args = lc_train_args(arch, bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                         weight_dropout=0.0, input_dropout=0.0, warmup_updates=1, warmup_init_lr=0.002)
    task = TranslationTask(args, *dicts)
    model = task.build_model(args, device=device)
    model.use_kernel = use_kernel
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    return model, trainer.train_step([sample])


def check_lightconv_steps(dicts, modules):
    sample = staged_text(lc_train_sample(modules, dicts, np.random.RandomState(6), 32))
    kernel = one_lc_step(dicts, modules, "cuda", sample, use_kernel=True)
    plain = one_lc_step(dicts, modules, "cuda", sample, use_kernel=False)
    compare_steps("lightconv_kernel_vs_plain", kernel, plain, "other_forward")
    del kernel, plain
    small = lc_train_sample(modules, dicts, np.random.RandomState(7), 2)
    cpu = one_lc_step(dicts, modules, "cpu", staged_text(small, "cpu"), use_kernel=False, deterministic=True)
    card = one_lc_step(dicts, modules, "cuda", staged_text(small), use_kernel=True, deterministic=True)
    compare_steps("lightconv_card_vs_cpu", card, cpu, "other_forward")


def train_iwslt_fp32(card, dicts, fa, dconv, single, modules, attention):
    """20b. ``dynamicconv_iwslt_de_en`` in fp32 (TF32 off) at phase 10's
    batch, as a user trains it without ``--bf16``: the flash calls take the
    D 128 tf32x3 forward and pair, exactly 6 + 6 + 6 a step
    and no other flash kernel, with 13 + 13 tensor-core dynamic conv; step
    ms, the loss finite, one profiled step. Returns the timed steps'
    launches. Then the flash route against the dense route, one step of a
    fresh model each with dropout 0, at phase 8's tolerances."""
    Trainer, TranslationTask = modules["Trainer"], modules["TranslationTask"]
    args = lc_train_args(IWSLT_ARCH, bf16=False)
    task = TranslationTask(args, *dicts)
    trainer = Trainer(args, task, task.build_model(args), task.build_criterion(args))
    sample = staged_text(lc_train_sample(modules, dicts, np.random.RandomState(5), LC_TRAIN_BATCH))
    trainer.train_step([sample])
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    t0 = time.perf_counter()
    outs = [trainer.train_step([sample]) for _ in range(IWSLT_FP32_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / IWSLT_FP32_STEPS * 1e3
    launches = launch_counts(fa, dconv, single)
    want = step_launches(launches, IWSLT_FP32_STEPS, LC_FLASH_LAUNCHES_PER_STEP, FP32_D128_BACKWARD, FP32_D128_FORWARD)
    want.update({DCONV_FORWARD: DCONV_LAUNCHES_PER_STEP * IWSLT_FP32_STEPS,
                 DCONV_BACKWARD: DCONV_LAUNCHES_PER_STEP * IWSLT_FP32_STEPS})
    if launches != want:
        raise AssertionError(f"{IWSLT_ARCH} fp32 train launches {launches}, expected {want}")
    losses = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    if not (np.isfinite(losses).all() and all(np.isfinite(float(o["gnorm"])) for o in outs)):
        raise AssertionError("non-finite loss or gnorm in the fp32 iwslt step")
    emit({"phase": "train_iwslt_fp32", "arch": IWSLT_ARCH, "batch": LC_TRAIN_BATCH, "dtype": "float32",
          "forward": FP32_D128_FORWARD, "backward": FP32_D128_BACKWARD, "steps": IWSLT_FP32_STEPS, "step_ms": step_ms,
          "launches_per_step": {k: v / IWSLT_FP32_STEPS for k, v in launches.items()},
          "loss_per_token": losses, "card": card})
    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_iwslt_fp32_profile", "arch": IWSLT_ARCH, "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes,
          "device_busy_ms_with_the_cuda_core_forward": FP32_D128_CUDA_CORE_BUSY_MS, "card": card})
    del trainer
    torch.cuda.empty_cache()

    calls = LC_FLASH_LAUNCHES_PER_STEP
    d128 = {FP32_D128_FORWARD: calls, **{k: calls for k in BACKWARD_KERNELS[FP32_D128_BACKWARD]}}
    step = lambda: one_lc_step(dicts, modules, "cuda", sample, use_kernel=True, arch=IWSLT_ARCH)  # noqa: E731
    attention.set_flash_attention(None)
    flash = counted_step(fa, d128, step_fn=step)
    attention.set_flash_attention(False)
    dense = counted_step(fa, {}, step_fn=step)
    attention.set_flash_attention(None)
    compare_steps("iwslt_fp32_flash_vs_dense", flash, dense, "other_forward")
    return launches


# ---------------------------------------------------------------------------
# 12.-13. the single-pass kernel and the flash sweep
# ---------------------------------------------------------------------------

def check_single_kernel(single):
    """flash_fwd_single against its plain version in fp32 and bf16 at the
    sweep's shapes and ragged ones, at every t_block each type's kernel
    takes; then the shapes it refuses."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, bh, t, s, causal, padded, dtypes in SINGLE_SHAPES:
        d = 64
        scale = d ** -0.5
        for dtype in dtypes:
            q, k, v, bias = random_attention_inputs(gen, bh, s, s, d, dtype, padded)
            q = q[:, :t].contiguous()
            out_p, lse_p = single.flash_fwd_single_reference(q, k, v, bias, scale, causal)
            plain_ms = time_ms(lambda: single.flash_fwd_single_reference(q, k, v, bias, scale, causal), iters=5)
            library_ms, library_backend = time_library(q, k, v, bias, scale, causal, iters=5)
            for tb in single.T_BLOCKS[dtype]:
                run = lambda: single.flash_fwd_single(q, k, v, bias, scale, causal=causal, t_block=tb)  # noqa: E731
                out_k, lse_k = run()
                torch.cuda.synchronize()
                diff = (out_k.float() - out_p.float()).abs()
                err = diff.max().item()
                lse_err = (lse_k - lse_p).abs().max().item()
                atol, rtol = SINGLE_BF16_LIMIT if dtype == torch.bfloat16 else (ATOL_KERNEL[dtype], 0.0)
                limit_ratio = (diff / (atol + rtol * out_p.float().abs())).max().item()
                row = {"phase": "single_kernel_check", "kernel": "flash_fwd_single", "shape": name, "bh": bh,
                       "T": t, "S": s, "D": d, "causal": causal, "rate": 0.0, "t_block": tb,
                       "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "lse_max_abs_err": lse_err,
                       "atol": ATOL_KERNEL[dtype], "elementwise_limit": [atol, rtol],
                       "max_err_over_elementwise_limit": limit_ratio, "kernel_ms": time_ms(run, iters=5),
                       "kernel_device_ms": device_ms(run, "flash_fwd_single_kernel", iters=5),
                       "plain_ms": plain_ms, "library_ms": library_ms, "library_backend": library_backend}
                row["bound_ms"], row["bound_by"] = attention_bound_ms(bh, t, s, d, causal, dtype)
                emit(row)
                rows.append(row)
                if not (err <= ATOL_KERNEL[dtype] and limit_ratio <= 1.0 and lse_err <= ATOL_LSE):
                    raise AssertionError(f"flash_fwd_single disagrees with its plain version at {name} {dtype} "
                                         f"t_block {tb}: max|out| err {err} ({limit_ratio} of the element-wise "
                                         f"limit), max|lse| err {lse_err}")
                worst[dtype] = max(worst[dtype], err)
            del q, k, v, bias, out_p, lse_p
            torch.cuda.empty_cache()
    # another head dim in either type, past the fp32 kernel's shared memory
    # (t_block 16 at S 3308), or a tile the bf16 kernel is not built for:
    # the wrapper raises before any launch and nothing falls back
    for dtype, s, d, tb in ((torch.float32, 256, 32, 8), (torch.bfloat16, 256, 32, 64),
                            (torch.float32, 3308, 64, 16), (torch.bfloat16, 256, 64, 16)):
        q, k, v, bias = random_attention_inputs(gen, 1, s, s, d, dtype, padded=False)
        before = single.launches
        try:
            single.flash_fwd_single(q, k, v, bias, d ** -0.5, t_block=tb)
        except ValueError as exc:
            emit({"phase": "single_kernel_refuses", "dtype": str(dtype).replace("torch.", ""), "S": s, "D": d,
                  "t_block": tb, "error": str(exc)})
        else:
            raise AssertionError(f"flash_fwd_single took {dtype} S {s} D {d} t_block {tb}, past what it is built for")
        if single.launches != before:
            raise AssertionError("flash_fwd_single launched a shape it refuses")
    return rows, worst


def flash_sweep(card, sweep, fa, dconv, single):
    """The port's flash sweep in full (its own asserts hold each
    single-pass tile against the flash forward)."""
    t0 = time.perf_counter()
    reset_counts(fa, dconv, single)
    rows = sweep.run()
    launches = launch_counts(fa, dconv, single)
    sweep.print_table(rows)
    for r in rows:
        emit({"phase": "flash_sweep", **r})
    decision = sweep.gate_from(rows)
    emit({"phase": "flash_sweep_decision_inputs", **decision, "seconds": time.perf_counter() - t0, "card": card})
    if not decision["pair_wins_everywhere"]:
        raise AssertionError(f"the fused backward beat the tensor-core pair at a train step's call, so the "
                             f"committed route {BF16_BACKWARD} needs a gate: {decision['pair_wins_by_call']}")
    if not decision["tc_fwd_wins_everywhere"]:
        raise AssertionError(f"the CUDA-core forward beat the tensor-core forward at a train step's call, so "
                             f"the committed route {BF16_FORWARD} needs a gate: {decision['tc_fwd_wins_by_call']}")
    if not decision["tf32x3_fwd_wins_everywhere"]:
        raise AssertionError(f"the CUDA-core forward beat the tf32x3 forward at a train step's fp32 call, so the "
                             f"committed route {FP32_FORWARD} needs a gate: {decision['tf32x3_fwd_wins_by_call']}")
    if not decision["tf32x3_bwd_wins_everywhere"]:
        raise AssertionError(f"the fused backward beat the tf32x3 pair at a train step's fp32 call, so the "
                             f"committed route {FP32_BACKWARD} needs a gate: {decision['tf32x3_bwd_wins_by_call']}")
    for prefix, route in (("", D128_BACKWARD), ("tf32x3_", FP32_D128_BACKWARD)):
        wins = decision[f"{prefix}d128_pair_wins_by_call"]
        if not (wins and decision[f"{prefix}d128_pair_wins_everywhere"]):
            raise AssertionError(f"the CUDA-core pair beat the D 128 tensor-core pair at a call, so the committed "
                                 f"route {route} needs a gate: {wins}")
    return launches


# ---------------------------------------------------------------------------
# 14.-15. the CTC flagship
# ---------------------------------------------------------------------------

def ctc_dictionaries(Dictionary, d):
    """The target dictionary and a 700-symbol source dictionary; the task
    adds <ctc_blank> after the source symbols."""
    sd = Dictionary()
    for i in range(CTC_SRC_SYMBOLS):
        sd.add_symbol(f"s{i}")
    sd.finalize(padding_factor=8)
    return d, sd


def ctc_args(**overrides):
    """bench.py:367-380 under the JAX package's names."""
    return train_args(arch=CTC_ARCH, criterion="ctc_multi_loss",
                      underlying_criterion="label_smoothed_cross_entropy", ctc_encoder_layer=4,
                      ctc_weight=0.5, ctc_compress_out=True, **overrides)


def ctc_sample(d, rng, batch=TRAIN_BATCH):
    """bench.py:390-398: the train sample plus 64 transcript tokens a row
    over the source symbols (4 .. 703, never the blank at 704)."""
    sample = train_sample(d, rng, batch=batch)
    tr = rng.randint(4, 4 + CTC_SRC_SYMBOLS, size=(batch, CTC_TR_LEN)).astype(np.int64)
    sample["transcript_target"] = tr
    sample["transcript_target_lengths"] = np.full((batch,), CTC_TR_LEN, np.int64)
    sample["net_input"]["transcript_prev_output_tokens"] = np.concatenate(
        [np.full((batch, 1), d.eos(), np.int64), tr[:, :-1]], axis=1)
    return sample


def staged_transcripts(sample, dtype, device="cuda"):
    """``staged`` with the transcripts' fields."""
    out = staged(sample, dtype, device)
    for key in ("transcript_target", "transcript_target_lengths"):
        out[key] = torch.as_tensor(sample[key]).to(device)
    out["net_input"]["transcript_prev_output_tokens"] = torch.as_tensor(
        sample["net_input"]["transcript_prev_output_tokens"]).to(device)
    return out


def timed_steps(trainer, sample, steps, repeats=REPEATS):
    outs, step_ms = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / steps * 1e3)
    return outs, step_ms


def train_ctc(card, dicts, fa, dconv, single, modules):
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationCTCTask"]
    args = ctc_args()
    task = Task(args, *dicts)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged_transcripts(ctc_sample(dicts[0], np.random.RandomState(0)), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    enc = model.encoder_cfg
    t_out = enc.frontend.out_length(TRAIN_FRAMES)
    flops = (train_flops(enc, model.decoder_cfg, TRAIN_BATCH, TRAIN_FRAMES, TGT_LEN)
             + 3 * 2.0 * TRAIN_BATCH * t_out * enc.embed_dim * enc.ctc_vocab_size)  # ctc_fc

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms = timed_steps(trainer, sample, CTC_TIMED_STEPS)
    outs += timed
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * CTC_TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)  # compression keeps T' static rows
    if launches != want:
        raise AssertionError(f"ctc flagship launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_sample = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    ctc_losses = [float(o["ctc_loss"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_sample).all() and np.isfinite(gnorms).all() and np.isfinite(ctc_losses).all()):
        raise AssertionError("non-finite loss, ctc_loss or gnorm in the ctc flagship phase")
    first, last = float(np.mean(per_sample[1:6])), float(np.mean(per_sample[-5:]))
    if not last < first:
        raise AssertionError(f"the ctc flagship loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    metrics = modules["CTCMultiLoss"].reduce_metrics([outs[-1]])
    emit({"phase": "train_ctc_flagship", "arch": CTC_ARCH, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "tgt_len": TGT_LEN, "transcript_len": CTC_TR_LEN, "ctc_vocab": enc.ctc_vocab_size,
          "blank": dicts[1].index("<ctc_blank>"), "dtype": "bfloat16",
          "forward": BF16_FORWARD, "backward": BF16_BACKWARD,
          "step_ms_median": median,
          "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "peak_memory_gb": peak_gb, "loss_per_sample_size_first": per_sample[0],
          "loss_per_sample_size_steps_1_5": first, "loss_per_sample_size_last5": last,
          "ctc_loss_first": ctc_losses[0], "ctc_loss_last": ctc_losses[-1], "metrics_last": metrics,
          "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]), "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    # the UER's edit distance at the step's shapes: (B, T') predictions
    # against (B, 64) transcripts
    model.eval()
    with torch.no_grad():
        enc_out = model.encode(sample["net_input"]["src_tokens"], sample["net_input"]["src_lengths"])
        pred, counts = modules["ctc_greedy_decode"](enc_out.ctc_out, enc_out.ctc_lengths, dicts[1].index("<ctc_blank>"))
    lev = lambda: modules["levenshtein"](pred, counts, sample["transcript_target"],  # noqa: E731
                                         sample["transcript_target_lengths"])
    lev_kernels, lev_busy_ms = device_busy(lev, iters=3)
    emit({"phase": "train_ctc_flagship_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes,
          "edit_distance_kernels": lev_kernels, "edit_distance_device_ms": lev_busy_ms,
          "compressed_len_mean": float(enc_out.src_lengths.float().mean()), "card": card})
    return launches


def one_ctc_step(dicts, modules, device, sample, deterministic=False):
    """A fresh full-width fp32 CTC flagship model (seed 1) after one train
    step; returns (model, step outputs, the compressed lengths of the
    step's forward)."""
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationCTCTask"]
    args = ctc_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                    warmup_updates=1, warmup_init_lr=0.002)
    task = Task(args, *dicts)
    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    seen = []
    hook = model.encoder.register_forward_hook(lambda m, i, out: seen.append(out.src_lengths.detach().cpu()))
    out = trainer.train_step([sample])
    hook.remove()
    return (model, out), seen[0]


def check_ctc_steps(dicts, modules, attention):
    sample = staged_transcripts(ctc_sample(dicts[0], np.random.RandomState(9), batch=32), torch.float32)
    attention.set_flash_attention(None)
    flash, len_flash = one_ctc_step(dicts, modules, "cuda", sample)
    attention.set_flash_attention(False)
    dense, len_dense = one_ctc_step(dicts, modules, "cuda", sample)
    attention.set_flash_attention(None)
    check_lengths("ctc_flash_vs_dense", len_flash, len_dense)
    compare_steps("ctc_flash_vs_dense", flash, dense, "other_forward")
    del flash, dense
    small = ctc_sample(dicts[0], np.random.RandomState(10), batch=2)
    cpu, len_cpu = one_ctc_step(dicts, modules, "cpu", staged_transcripts(small, torch.float32, "cpu"),
                                deterministic=True)
    card, len_card = one_ctc_step(dicts, modules, "cuda", staged_transcripts(small, torch.float32), deterministic=True)
    check_lengths("ctc_card_vs_cpu", len_card, len_cpu)
    compare_steps("ctc_card_vs_cpu", card, cpu, "other_forward")


def check_lengths(label, a, b):
    same = torch.equal(a, b)
    emit({"phase": "ctc_compressed_lengths", "check": label, "identical": same,
          "mean_length": float(a.float().mean()), "rows": int(a.numel())})
    if not same:
        raise AssertionError(f"{label}: the compressed lengths differ: {a.tolist()} vs {b.tolist()}")


# ---------------------------------------------------------------------------
# 16. the long-context train step
# ---------------------------------------------------------------------------

def train_long(card, d, fa, dconv, single, modules):
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args(max_source_positions=LONG_FRAMES)
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged(train_sample(d, np.random.RandomState(0), batch=LONG_BATCH, frames=LONG_FRAMES), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    flops = train_flops(model.encoder_cfg, model.decoder_cfg, LONG_BATCH, LONG_FRAMES, TGT_LEN)

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms = timed_steps(trainer, sample, LONG_TIMED_STEPS)
    outs += timed
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * LONG_TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)
    if launches != want:
        raise AssertionError(f"long-context launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite([float(o["gnorm"]) for o in outs]).all()):
        raise AssertionError("non-finite loss or gnorm in the long-context phase")
    median = float(np.median(step_ms))
    emit({"phase": "train_longcontext", "arch": "conv_transformer", "batch": LONG_BATCH, "frames": LONG_FRAMES,
          "encoder_len": model.encoder_cfg.frontend.out_length(LONG_FRAMES), "tgt_len": TGT_LEN,
          "dtype": "bfloat16", "forward": BF16_FORWARD, "backward": BF16_BACKWARD, "step_ms_median": median,
          "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3),
          "flops_per_step": flops, "mfu": flops / (median / 1e3) / PEAK_BF16,
          "launches_per_step": {k: v / steps for k, v in launches.items()}, "peak_memory_gb": peak_gb,
          "loss_per_token_first": per_token[0], "loss_per_token_last": per_token[-1], "card": card})
    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_longcontext_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
    return launches


def check_long_steps(d, modules, attention):
    """Flash against dense route on one fp32 long-context step."""
    sample = staged(train_sample(d, np.random.RandomState(11), batch=LONG_BATCH, frames=LONG_FRAMES), torch.float32)
    attention.set_flash_attention(None)
    flash = one_step(d, modules, "cuda", sample, max_source_positions=LONG_FRAMES)
    attention.set_flash_attention(False)
    torch.cuda.reset_peak_memory_stats()
    dense = one_step(d, modules, "cuda", sample, max_source_positions=LONG_FRAMES)
    emit({"phase": "longcontext_dense_step", "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    attention.set_flash_attention(None)
    compare_steps("longcontext_flash_vs_dense", flash, dense, "other_forward")


# ---------------------------------------------------------------------------
# 17.-18. two-phase serving
# ---------------------------------------------------------------------------

def build_twophase_model(modules, arch, d, device=None):
    """``arch`` at full width, the source and the target dictionary both
    ``d`` (bench.py's two-phase configuration)."""
    return modules["build_model"](arch, d, d, device=device, seed=0, input_feat_per_channel=N_MELS,
                                  max_source_positions=2048, max_target_positions=512)


def check_transcripts(hypos, eos):
    for sent in hypos:
        for h in sent:
            t = h.get("transcript_tokens")
            if t is None or len(t) == 0 or int(t[-1]) != eos or not np.isfinite(h["transcript_score"]):
                raise AssertionError(f"a two-phase hypothesis without a finished transcript: {t}")


def same_tops(a, b):
    """How many sentences have the same top hypothesis and transcript."""
    return sum(list(x[0]["tokens"]) == list(y[0]["tokens"])
               and list(x[0]["transcript_tokens"]) == list(y[0]["transcript_tokens"]) for x, y in zip(a, b))


def twophase_batch(sample, hypos, d, device):
    """The request with its top hypotheses and transcripts as the
    teacher-forced inputs of both decoders."""
    put = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    net = sample["net_input"]
    return {"src_tokens": put(net["src_tokens"]), "src_lengths": put(net["src_lengths"]),
            "prev_output_tokens": put(teacher_forced_tokens(hypos, d.pad(), d.eos())),
            "transcript_prev_output_tokens": put(teacher_forced_tokens(hypos, d.pad(), d.eos(), "transcript_tokens"))}


def twophase_outputs(model, batch):
    """Phase 2's preparation on the top transcripts (``aux_features`` over
    the encoder output) and the teacher-forced target and auxiliary
    logits."""
    with torch.no_grad():
        enc = model.encode(batch["src_tokens"], batch["src_lengths"])
        feats = model.aux_features(batch["transcript_prev_output_tokens"], enc)
        (logits, _), (aux_logits, _) = model(batch)
    return feats, logits, aux_logits


def max_errs(a, b):
    return [(x.float().cpu() - y.float().cpu()).abs().max().item() for x, y in zip(a, b)]


def serve_twophase(card, d, fa, dconv, single, attention, modules, arch, requests):
    """Serve ``requests`` two-phase with ``arch``; returns the launches of
    the served requests, then holds the flash route against the dense one
    on the first request and the card against the CPU on 2 utterances."""
    model = build_twophase_model(modules, arch, d)
    gen = modules["TwoPhaseSequenceGenerator"](d, d, beam_size=BEAM, max_len_b=MAX_LEN_B)
    attention.set_flash_attention(None)
    gen.generate([model], requests[-1][1])  # warm-up (cuDNN plans, allocator)

    reset_counts(fa, dconv, single)
    served = []
    for name, sample in requests:
        before = launch_counts(fa, dconv, single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n = len(sample["net_input"]["src_lengths"])
        check_hypotheses(hypos, d.eos(), n)
        check_transcripts(hypos, d.eos())
        grew = {k: c - before[k] for k, c in launch_counts(fa, dconv, single).items()}
        want = {k: TWOPHASE_LAUNCHES_PER_REQUEST if k == FP32_FORWARD else 0 for k in grew}
        if grew != want:
            raise AssertionError(f"{arch} {name}: launches grew by {grew}, expected {TWOPHASE_LAUNCHES_PER_REQUEST} "
                                 f"{FP32_FORWARD} and nothing else")
        audio_s = float(sample["net_input"]["src_lengths"].sum()) * FRAME_SECONDS
        served.append((name, sample, hypos))
        emit({"phase": "serve_twophase", "arch": arch, "request": name, "utterances": n, "decode_s": decode_s,
              "audio_s": audio_s, "rtf": decode_s / audio_s, "flash_launches": grew[FP32_FORWARD],
              "forward": FP32_FORWARD, "mean_hyp_len": float(np.mean([len(s[0]["tokens"]) for s in hypos])),
              "mean_transcript_len": float(np.mean([len(s[0]["transcript_tokens"]) for s in hypos])),
              "card": card})
    launches = launch_counts(fa, dconv, single)

    name, sample, hypos = served[0]
    wall_s, busy_s, top, classes = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile_twophase", "arch": arch, "request": name, "decode_s_profiled": wall_s,
          "device_busy_s": busy_s, "device_idle_share_profiled": 1.0 - busy_s / wall_s,
          "top_kernels_s": top, "busy_by_class_s": classes, "card": card})

    # the flash route against the dense route on the first request
    batch = twophase_batch(sample, hypos, d, "cuda")
    flash = twophase_outputs(model, batch)
    attention.set_flash_attention(False)
    dense = twophase_outputs(model, batch)
    hypos_dense = gen.generate([model], sample)
    attention.set_flash_attention(None)
    same = same_tops(hypos, hypos_dense)
    errs = max_errs(flash, dense)
    emit({"phase": "twophase_flash_vs_dense", "arch": arch, "request": name, "aux_features_max_abs_err": errs[0],
          "logits_max_abs_err": errs[1], "aux_logits_max_abs_err": errs[2], "atol": ATOL_MODEL,
          "identical_top_hypotheses_and_transcripts": f"{same}/{len(hypos)}"})
    if max(errs) > ATOL_MODEL or same != len(hypos):
        raise AssertionError(f"{arch}: the flash and dense routes disagree")

    # the card against the plain CPU path on 2 utterances
    small = make_request(np.random.RandomState(7), 2, 409, 512, 512)
    cpu_model = build_twophase_model(modules, arch, d, device="cpu")
    hypos_cpu = gen.generate([cpu_model], small)
    hypos_card = gen.generate([model], small)
    errs = max_errs(twophase_outputs(model, twophase_batch(small, hypos_card, d, "cuda")),
                    twophase_outputs(cpu_model, twophase_batch(small, hypos_card, d, "cpu")))
    same = same_tops(hypos_card, hypos_cpu)
    emit({"phase": "twophase_card_vs_cpu", "arch": arch, "utterances": 2, "aux_features_max_abs_err": errs[0],
          "logits_max_abs_err": errs[1], "aux_logits_max_abs_err": errs[2], "atol": ATOL_MODEL,
          "identical_top_hypotheses_and_transcripts": f"{same}/2"})
    if max(errs) > ATOL_MODEL or same != 2:
        raise AssertionError(f"{arch}: the card and the plain CPU path disagree")
    return launches


# ---------------------------------------------------------------------------
# 19. the dual-decoder train step
# ---------------------------------------------------------------------------

def dual_args(**overrides):
    """Phase 7's arguments for the dual decoder and its criterion."""
    return train_args(arch=DUAL_ARCH, criterion="cross_entropy_dualdecoder", primary_loss_weight=0.5,
                      auxiliary_loss_weight=0.5, **overrides)


def dual_sample(d, rng, batch=TRAIN_BATCH):
    """The train sample plus 64 transcript tokens a row, ending in eos as
    the targets do."""
    sample = train_sample(d, rng, batch=batch)
    prev = rng.randint(4, VOCAB - 1, size=(batch, DUAL_TR_LEN)).astype(np.int64)
    prev[:, 0] = d.eos()
    sample["transcript_target"] = np.concatenate([prev[:, 1:], np.full((batch, 1), d.eos())], axis=1)
    sample["transcript_target_lengths"] = np.full((batch,), DUAL_TR_LEN, np.int64)
    sample["net_input"]["transcript_prev_output_tokens"] = prev
    return sample


def train_dual(card, d, fa, dconv, single, modules):
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationDualDecodingTask"]
    args = dual_args()
    task = Task(args, d, d)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged_transcripts(dual_sample(d, np.random.RandomState(0)), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    enc = model.encoder_cfg
    flops = (train_flops(enc, model.decoder_cfg, TRAIN_BATCH, TRAIN_FRAMES, TGT_LEN)
             + 3 * decoder_flops(model.aux_decoder_cfg, TRAIN_BATCH, enc.frontend.out_length(TRAIN_FRAMES),
                                 DUAL_TR_LEN))

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms = timed_steps(trainer, sample, DUAL_TIMED_STEPS)
    outs += timed
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * DUAL_TIMED_STEPS
    want = step_launches(launches, steps, DUAL_FLASH_CALLS_PER_STEP)
    if launches != want:
        raise AssertionError(f"dual-decoder launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    aux_nll = [float(o["auxiliary_nll_loss"]) / float(o["auxiliary_ntokens"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite(aux_nll).all() and np.isfinite(gnorms).all()):
        raise AssertionError("non-finite loss, auxiliary_nll_loss or gnorm in the dual-decoder phase")
    for label, series in (("loss", per_token), ("auxiliary_nll_loss", aux_nll)):
        first, last = float(np.mean(series[1:6])), float(np.mean(series[-5:]))
        if not last < first:
            raise AssertionError(f"the dual-decoder {label} did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    emit({"phase": "train_dualdecoder", "arch": DUAL_ARCH, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "tgt_len": TGT_LEN, "transcript_len": DUAL_TR_LEN, "dtype": "bfloat16",
          "forward": BF16_FORWARD, "backward": BF16_BACKWARD, "step_ms_median": median,
          "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "peak_memory_gb": peak_gb, "loss_per_token_first": per_token[0],
          "loss_per_token_steps_1_5": float(np.mean(per_token[1:6])),
          "loss_per_token_last5": float(np.mean(per_token[-5:])),
          "auxiliary_nll_per_token_first": aux_nll[0], "auxiliary_nll_per_token_last5": float(np.mean(aux_nll[-5:])),
          "metrics_last": modules["CrossEntropyDualDecoder"].reduce_metrics([outs[-1]]),
          "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]), "card": card})
    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_dualdecoder_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
    return launches


def one_dual_step(d, modules, device, sample, deterministic=False):
    """A fresh full-width fp32 dual-decoder model (seed 1) after one train
    step with lr 2e-3 from the first update; returns (model, step outputs)."""
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationDualDecodingTask"]
    args = dual_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                     warmup_updates=1, warmup_init_lr=0.002)
    task = Task(args, d, d)
    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    return model, trainer.train_step([sample])


def check_dual_steps(d, fa, attention, modules):
    """fp32 steps (TF32 off): flash (32 tf32x3 forwards and 32 + 32 tf32x3
    dq + dkv) against dense (none) at batch 32, and the card against the
    CPU on 2 utterances."""
    calls = DUAL_FLASH_CALLS_PER_STEP
    tf32x3 = {FP32_FORWARD: calls, **{k: calls for k in BACKWARD_KERNELS[FP32_BACKWARD]}}
    sample = staged_transcripts(dual_sample(d, np.random.RandomState(12), batch=32), torch.float32)
    attention.set_flash_attention(None)
    flash = counted_step(fa, tf32x3, d, modules, "cuda", sample, step_fn=one_dual_step)
    attention.set_flash_attention(False)
    dense = counted_step(fa, {}, d, modules, "cuda", sample, step_fn=one_dual_step)
    attention.set_flash_attention(None)
    compare_steps("dual_flash_vs_dense", flash, dense, "other_forward")
    del flash, dense
    small = dual_sample(d, np.random.RandomState(13), batch=2)
    cpu = one_dual_step(d, modules, "cpu", staged_transcripts(small, torch.float32, "cpu"), deterministic=True)
    card = one_dual_step(d, modules, "cuda", staged_transcripts(small, torch.float32), deterministic=True)
    compare_steps("dual_card_vs_cpu", card, cpu, "other_forward")


# ---------------------------------------------------------------------------
# 21.-23. serving from files, the search strategies, the realistic step
# ---------------------------------------------------------------------------

def write_corpus(modules, d, data_dir, rng):
    """A speech-translation corpus in the fork's files, written with the
    port's builders: ``test.npz`` (FILES_UTTERANCES utterances of 409-512
    frames x 80 mels, phase 6's request sizes), targets ``test.de`` and
    transcripts ``test.en`` of FILES_TGT_LEN tokens over ``d``, and the
    dictionaries. Returns the frame counts."""
    idx = modules["indexed_dataset"]
    sample = make_request(rng, FILES_UTTERANCES, 409, 512, 512)["net_input"]
    frames = idx.AudioIndexedDatasetBuilder(os.path.join(data_dir, "test.npz.bin"))
    for feats, n in zip(sample["src_tokens"], sample["src_lengths"]):
        frames.add_item(feats[:n])
    frames.finalize(os.path.join(data_dir, "test.npz.idx"))
    for lang in ("de", "en"):
        d.save(os.path.join(data_dir, f"dict.{lang}.txt"))
        text = idx.IndexedDatasetBuilder(os.path.join(data_dir, f"test.{lang}.bin"))
        for _ in range(FILES_UTTERANCES):
            text.add_item(np.append(rng.randint(4, len(d), size=rng.randint(*FILES_TGT_LEN) - 1), d.eos()))
        text.finalize(os.path.join(data_dir, f"test.{lang}.idx"))
    return sample["src_lengths"]


def read_records(path):
    """{id: (score, text)} of the H- lines and the BLEU line of a
    ``generate-<subset>.txt``."""
    hyps, bleu_line = {}, None
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("H-"):
                head, score, text = line.rstrip("\n").split("\t")
                hyps[int(head[2:])] = (float(score), text)
            elif "| Generate test with beam=" in line:
                bleu_line = line.strip().split(": ", 1)[1]
    return hyps, bleu_line


def serve_from_files(card, d, fa, dconv, single, modules):
    """Main path 11: the base conv_transformer's seeded weights saved with
    ``save_model_checkpoint``, a corpus written with the port's builders,
    and ``cli/generate``'s ``cli_main`` decoding it on the card (beam 5,
    ``max_len_b`` 100) as a user runs it; held to the in-memory
    ``SequenceGenerator`` on the same batches (identical tokens, scores
    within FILES_SCORE_ATOL), with 8 tf32x3 forwards a batch and no other
    kernel."""
    import tempfile

    build_model, SequenceGenerator = modules["build_model"], modules["SequenceGenerator"]
    model = build_model("conv_transformer", d, seed=0, input_feat_per_channel=N_MELS, max_source_positions=2048,
                        max_target_positions=512)
    args = types.SimpleNamespace(arch="conv_transformer", task="speech_translation_with_transcription",
                                 criterion="label_smoothed_cross_entropy", input_feat_per_channel=N_MELS,
                                 max_source_positions=2048, max_target_positions=512, seed=0)
    modules["registry"].apply_architecture(args)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, results = os.path.join(tmp, "data"), os.path.join(tmp, "results")
        os.makedirs(data_dir)
        lengths = write_corpus(modules, d, data_dir, np.random.RandomState(0))
        ckpt = os.path.join(tmp, "checkpoint.pt")
        modules["save_model_checkpoint"](ckpt, args, model)
        argv = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", ckpt,
                "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", "test",
                "--max-sentences", str(FILES_UTTERANCES), "--max-tokens", str(FILES_UTTERANCES * 512),
                "--results-path", results]
        reset_counts(fa, dconv, single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer = modules["generate_cli"].cli_main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = launch_counts(fa, dconv, single)
        hyps, bleu_line = read_records(os.path.join(results, "generate-test.txt"))

        # the same batches through the in-memory generator
        options, registry = modules["options"], modules["registry"]
        cli_args = options.parse_args_and_arch(options.get_generation_parser(), argv)
        task = registry.TASKS[cli_args.task].setup_task(cli_args)
        task.load_dataset("test")
        batches = list(task.get_batch_iterator(
            task.dataset("test"), max_tokens=cli_args.max_tokens, max_sentences=cli_args.max_sentences,
            max_positions=task.max_positions(),
            required_batch_size_multiple=cli_args.required_batch_size_multiple).next_epoch_itr(shuffle=False))
    want = {k: (FLASH_LAUNCHES_PER_REQUEST * len(batches) if k == FP32_FORWARD else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"cli/generate launches {launches}, expected {want} over {len(batches)} batch(es)")
    gen = SequenceGenerator(d, beam_size=BEAM, max_len_b=MAX_LEN_B)
    decode_s, same, worst, n = 0.0, 0, 0.0, 0
    for sample in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        check_hypotheses(hypos, d.eos(), len(sample["id"]))
        for sid, sent in zip(sample["id"], hypos):
            score, text = hyps[int(sid)]
            same += text == d.string(sent[0]["tokens"])
            worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
            n += 1
    audio_s = float(np.sum(lengths)) * FRAME_SECONDS
    emit({"phase": "serve_from_files", "utterances": n, "batches": len(batches), "audio_s": audio_s,
          "cli_wall_s": cli_s, "cli_rtf": cli_s / audio_s, "decode_s_in_memory": decode_s,
          "rtf_in_memory": decode_s / audio_s, "launches": launches, "bleu": bleu_line,
          "bleu_score": scorer.score(), "identical_top_hypotheses": f"{same}/{n}",
          "max_abs_score_diff_base2": worst, "atol": FILES_SCORE_ATOL, "card": card})
    if not (n == len(hyps) == FILES_UTTERANCES and same == n and worst <= FILES_SCORE_ATOL and bleu_line):
        raise AssertionError(f"cli/generate disagrees with the in-memory generator: {same}/{n} identical, "
                             f"scores {worst} apart, {len(hyps)} H- lines")
    modules["served_model"] = model
    return launches


def serve_search(card, d, fa, dconv, single, modules):
    """Main path 12: the search strategies on the card, on the model of
    phase 21: a top-k sampling request (beam 5, every hypothesis a draw), a
    diverse-beam request, and a top-k 1 sampling request, which must give
    greedy search's hypothesis in every beam."""
    SequenceGenerator, search = modules["SequenceGenerator"], modules["search"]
    model = modules.pop("served_model")
    rng = np.random.RandomState(5)
    sample = make_request(rng, SEARCH_UTTERANCES, 409, 512, 512)
    small = make_request(rng, 4, 409, 512, 512)
    requests = [
        ("sampling_top10", SequenceGenerator(d, beam_size=BEAM, max_len_b=MAX_LEN_B, seed=7,
                                             search_strategy=search.Sampling(d, SAMPLING_TOPK)), sample, BEAM),
        ("diverse_beam", SequenceGenerator(d, beam_size=DIVERSE_BEAM, max_len_b=MAX_LEN_B,
                                           search_strategy=search.DiverseBeamSearch(d, DIVERSE_GROUPS, 0.5)),
         sample, DIVERSE_BEAM),
        ("sampling_top1", SequenceGenerator(d, beam_size=2, max_len_b=MAX_LEN_B,
                                            search_strategy=search.Sampling(d, 1)), small, 2),
    ]
    reset_counts(fa, dconv, single)
    out = {}
    for name, gen, req, beam in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], req)
        torch.cuda.synchronize()
        check_hypotheses(hypos, d.eos(), len(req["net_input"]["src_lengths"]))
        if any(len(sent) != beam for sent in hypos):
            raise AssertionError(f"{name}: {[len(sent) for sent in hypos]} hypotheses, expected {beam} each")
        out[name] = hypos
        emit({"phase": "serve_search", "request": name, "utterances": len(hypos), "beam": beam,
              "decode_s": time.perf_counter() - t0,
              "distinct_hypotheses_per_utterance": float(np.mean([len({tuple(h["tokens"]) for h in sent})
                                                                  for sent in hypos])), "card": card})
    launches = launch_counts(fa, dconv, single)
    want = {k: (FLASH_LAUNCHES_PER_REQUEST * len(requests) if k == FP32_FORWARD else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"search requests' launches {launches}, expected {want}")
    greedy = SequenceGenerator(d, beam_size=1, max_len_b=MAX_LEN_B).generate([model], small)
    same = sum(all(list(h["tokens"]) == list(g[0]["tokens"]) for h in sent)
               for sent, g in zip(out["sampling_top1"], greedy))
    emit({"phase": "sampling_top1_vs_greedy", "identical": f"{same}/{len(greedy)}", "card": card})
    if same != len(greedy):
        raise AssertionError("top-k 1 sampling differs from greedy search on the card")
    return launches


def masked_share(specaugment, x, generator, cfg):
    """The share of x's nonzero elements that one SpecAugment draw zeroes."""
    nonzero = x != 0
    return float(((specaugment(generator, x, cfg) == 0) & nonzero).sum()) / float(nonzero.sum())


def train_realistic(card, d, fa, dconv, single, modules):
    """Main path 13, ``bench.py``'s ``realistic`` section: the base step
    (phase 7's arguments, bf16, 128 x 409-512 frames) with ``--specaugment
    --specaugment-rate 1.0``, then with ``--time-stretch`` as well: step
    ms, the device's busy ms and idle share of one profiled step, and the
    augmentation's own device ms; the launches of phase 7 a step, and the
    losses finite; the masked share of one draw within
    MASKED_SHARE_RANGE."""
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    sample = staged(train_sample(d, np.random.RandomState(0)), torch.bfloat16)
    launches = None
    for name, extra in (("specaugment", dict(specaugment=True, specaugment_rate=1.0)),
                        ("specaugment_time_stretch", dict(specaugment=True, specaugment_rate=1.0,
                                                          time_stretch=True))):
        args = train_args(**extra)
        task = SpeechRecognitionTask(args, d)
        trainer = Trainer(args, task, task.build_model(args), task.build_criterion(args))
        outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
        torch.cuda.synchronize()
        reset_counts(fa, dconv, single)
        t0 = time.perf_counter()
        for _ in range(REALISTIC_TIMED_STEPS):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / REALISTIC_TIMED_STEPS * 1e3
        got = launch_counts(fa, dconv, single)
        want = step_launches(got, REALISTIC_TIMED_STEPS, CT_FLASH_CALLS_PER_STEP)
        if got != want:
            raise AssertionError(f"realistic {name} step launches {got}, expected {want}")
        launches = got if launches is None else {k: launches[k] + got[k] for k in got}
        losses = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss in the realistic {name} step: {losses}")
        wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
        batch = trainer._device_batch(sample)
        gens = modules["make_generators"](1, "cuda")
        aug_kernels, aug_ms = device_busy(lambda: task.augment_batch(batch, gens))
        share = masked_share(modules["specaugment"], batch["src_tokens"], gens.device, task.specaugment_cfg)
        emit({"phase": "train_realistic", "augment": name, "batch": TRAIN_BATCH, "dtype": "bfloat16",
              "step_ms": step_ms, "steps": REALISTIC_TIMED_STEPS, "step_s_profiled": wall_s,
              "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
              "augment_device_ms": aug_ms, "augment_kernels": aug_kernels, "masked_share": share,
              "masked_share_range": MASKED_SHARE_RANGE, "loss_per_token_first": losses[0],
              "loss_per_token_last": losses[-1], "launches_per_step": {k: v / REALISTIC_TIMED_STEPS
                                                                        for k, v in got.items()},
              "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
        if not MASKED_SHARE_RANGE[0] <= share <= MASKED_SHARE_RANGE[1]:
            raise AssertionError(f"SpecAugment masked {share} of the elements, outside {MASKED_SHARE_RANGE}")
        del trainer
        torch.cuda.empty_cache()
    return launches


def check_past_grid_cap(single, dconv):
    """bh (the single pass) and B (the CUDA-core dynamic conv) past the
    65,535 of a grid's y dimension, each on gridDim.x: the single pass at bh
    70,000 x T 16 x S 128 (D 64, keys padded) at each t_block, fp32 and
    bf16, and the dynamic conv at B 70,000 x T 16 x C 64 x H 4 x K 3,
    forward and backward in fp32 and bf16, each against its plain version
    at phase 12's and phase 5's tolerances."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = random_attention_inputs(gen, GRID_CAP_ROWS, 128, 128, 64, dtype)
        q = q[:, :16].contiguous()
        out_p, lse_p = single.flash_fwd_single_reference(q, k, v, bias, 0.125)
        for tb in single.T_BLOCKS[dtype]:
            out_k, lse_k = single.flash_fwd_single(q, k, v, bias, 0.125, t_block=tb)
            torch.cuda.synchronize()
            diff = (out_k.float() - out_p.float()).abs()
            atol, rtol = GRID_CAP_BF16_LIMIT if dtype == torch.bfloat16 else (ATOL_KERNEL[dtype], 0.0)
            ratio = (diff / (atol + rtol * out_p.float().abs())).max().item()
            err, lse_err = diff.max().item(), (lse_k - lse_p).abs().max().item()
            row = {"phase": "grid_cap_check", "kernel": "flash_fwd_single", "bh": GRID_CAP_ROWS, "T": 16, "S": 128,
                   "D": 64, "t_block": tb, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                   "lse_max_abs_err": lse_err, "max_err_over_elementwise_limit": ratio, "card": CARD[0]}
            emit(row)
            if not (err <= ATOL_KERNEL[dtype] and ratio <= 1.0 and lse_err <= ATOL_LSE):
                raise AssertionError(f"flash_fwd_single at bh {GRID_CAP_ROWS}: {row}")
            out[f"single_{row['dtype']}_t{tb}"] = err
        del q, k, v, bias, out_p, lse_p
        x = torch.randn((GRID_CAP_ROWS, 16, 64), generator=gen, device="cuda").to(dtype)
        w = torch.softmax(torch.randn((GRID_CAP_ROWS, 16, 4, 3), generator=gen, device="cuda"), dim=-1).to(dtype)
        g = torch.randn((GRID_CAP_ROWS, 16, 64), generator=gen, device="cuda").to(dtype)
        out_k = dconv.dynamic_conv_forward(x, w, 1, route="cuda_core")
        dx_k, dw_k = dconv.dynamic_conv_backward(x, w, g, 1, route="cuda_core")
        out_p = dconv.dynamic_conv_reference(x, w, 1)
        dx_p, dw_p = dconv.dynamic_conv_backward_reference(x, w, g, 1)
        torch.cuda.synchronize()
        errs = {name: (a.float() - b.float()).abs().max().item()
                for name, a, b in (("out", out_k, out_p), ("dx", dx_k, dx_p), ("dw", dw_k, dw_p))}
        limits = {"out": ATOL_KERNEL[dtype], "dx": ATOL_GRAD[dtype],
                  "dw": RTOL_DW[dtype] * dw_p.float().abs().max().item()}
        row = {"phase": "grid_cap_check", "kernel": "dynamic_conv_fwd/bwd (cuda_core)", "B": GRID_CAP_ROWS, "T": 16,
               "C": 64, "H": 4, "K": 3, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": errs,
               "limits": limits, "card": CARD[0]}
        emit(row)
        if any(errs[key] > limits[key] for key in errs):
            raise AssertionError(f"the CUDA-core dynamic conv at B {GRID_CAP_ROWS}: {row}")
        out[f"dconv_{row['dtype']}"] = errs
        del x, w, g, out_k, dx_k, dw_k, out_p, dx_p, dw_p
        torch.cuda.empty_cache()
    return out


def write_split(modules, d, data_dir, split, n, tgt_len, tr_len, rng):
    """One split of a speech-translation corpus in the fork's files,
    written with the port's builders: ``{split}.npz`` (n utterances of
    409-512 frames x 80 mels), targets ``{split}.de`` of ``tgt_len`` tokens
    and transcripts ``{split}.en`` of ``tr_len`` tokens over ``d``. Returns
    the frame counts."""
    idx = modules["indexed_dataset"]
    sample = make_request(rng, n, 409, 512, 512)["net_input"]
    frames = idx.AudioIndexedDatasetBuilder(os.path.join(data_dir, f"{split}.npz.bin"))
    for feats, length in zip(sample["src_tokens"], sample["src_lengths"]):
        frames.add_item(feats[:length])
    frames.finalize(os.path.join(data_dir, f"{split}.npz.idx"))
    for lang, lens in (("de", tgt_len), ("en", tr_len)):
        write_text(modules, d, data_dir, split, lang, n, lens, rng)
    return sample["src_lengths"]


def write_text(modules, d, data_dir, split, lang, n, lens, rng):
    """``dict.{lang}.txt`` (``d``) and ``{split}.{lang}``: n token lines of
    ``lens`` tokens over ``d``, each ending in eos, with ``IndexedDatasetBuilder``."""
    d.save(os.path.join(data_dir, f"dict.{lang}.txt"))
    text = modules["indexed_dataset"].IndexedDatasetBuilder(os.path.join(data_dir, f"{split}.{lang}.bin"))
    for _ in range(n):
        text.add_item(np.append(rng.randint(4, len(d), size=rng.randint(lens[0], lens[1] + 1) - 1), d.eos()))
    text.finalize(os.path.join(data_dir, f"{split}.{lang}.idx"))


def cli_train_launches(counts, calls=None, backward_calls=None, route=BF16_BACKWARD, forward=BF16_FORWARD):
    """The launches of one ``cli/train`` update of a conv_transformer-family
    model in bf16 (phase 7's 20 + 20 + 20 tensor-core kernels, or ``calls``
    forwards and ``backward_calls`` pairs, ``calls`` when None; at head dim
    128 ``route`` / ``forward`` name the D 128 kernels) and of one of its
    validation batches (``calls`` forwards), as ``counts``' keys."""
    calls = CT_FLASH_CALLS_PER_STEP if calls is None else calls
    update = step_launches(counts, 1, calls, route, forward)
    if backward_calls is not None:
        update.update({k: backward_calls for k in BACKWARD_KERNELS[route]})
    return update, {k: (calls if k == forward else 0) for k in counts}


class _TrainRecorder:
    """Counts around the port's Trainer while ``cli/train`` drives it: the
    kernel launches and the start time of each update and of each
    validation batch, the values each hands the metrics stack, and the
    seconds of each validation and each checkpoint save."""

    KEYS = ("loss", "nll_loss", "ctc_loss", "auxiliary_loss", "gnorm", "lr")

    def __init__(self, modules, fa, dconv, single):
        self.modules, self.counters = modules, (fa, dconv, single)
        self.updates, self.valid_batches, self.logged = [], [], []
        self.update_keys = []  # the keys of each update's logging outputs
        self.update_starts, self.validate_s, self.save_s = [], [], []
        self.best_weights = None  # the model's weights when checkpoint_best was last written
        self._saved = []
        self._in_valid = False

    def _wrap(self, owner, name, wrapper):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, wrapper(original))

    def __enter__(self):
        rec = self

        def counted(into, stamp=None):
            def wrap(original):
                def call(*args, **kwargs):
                    if stamp is not None:
                        stamp.append(time.perf_counter())
                    before = launch_counts(*rec.counters)
                    out = original(*args, **kwargs)
                    after = launch_counts(*rec.counters)
                    into.append({k: after[k] - before[k] for k in after})
                    return out
                return call
            return wrap

        def timed(into):
            def wrap(original):
                def call(*args, **kwargs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = original(*args, **kwargs)
                    torch.cuda.synchronize()
                    into.append(time.perf_counter() - t0)
                    return out
                return call
            return wrap

        def logged(original):
            def call(key, value, *args, **kwargs):
                if key in rec.KEYS:
                    rec.logged.append(("valid" if rec._in_valid else "train", key, float(value)))
                return original(key, value, *args, **kwargs)
            return call

        def validating(original):
            def call(*args, **kwargs):
                rec._in_valid = True
                try:
                    return original(*args, **kwargs)
                finally:
                    rec._in_valid = False
            return call

        ckpt = self.modules["checkpoint"]

        def snapshot_best(original):
            def call(args, trainer, epoch_itr, val_loss):
                out = original(args, trainer, epoch_itr, val_loss)
                if val_loss is not None and val_loss == ckpt._manager.best:
                    rec.best_weights = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
                return out
            return call

        def keyed(original):
            def call(*args, **kwargs):
                out = original(*args, **kwargs)
                rec.update_keys.append(sorted(out or ()))
                return out
            return call

        trainer_cls, cli = self.modules["Trainer"], self.modules["train_cli"]
        self._wrap(trainer_cls, "train_step", counted(self.updates, self.update_starts))
        self._wrap(trainer_cls, "train_step", keyed)
        self._wrap(trainer_cls, "valid_step", counted(self.valid_batches))
        self._wrap(trainer_cls, "valid_step", validating)
        self._wrap(cli, "validate", timed(self.validate_s))
        self._wrap(ckpt, "save_checkpoint", timed(self.save_s))
        self._wrap(ckpt, "save_checkpoint", snapshot_best)
        self._wrap(self.modules["metrics"], "log_scalar", logged)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        return False

    def losses(self, tag):
        """The loss each update ("train") or validation batch ("valid") logged."""
        return [value for t, key, value in self.logged if t == tag and key == "loss"]


def in_memory_update(trainer, sample):
    """The in-memory update's median seconds over CLI_TIMED_STEPS (after one
    warm-up) on ``sample``, staged once, and one profiled update's wall,
    device busy time, top kernels and kernel classes."""
    staged = trainer.stage_sample(sample)
    step_s = []
    for _ in range(CLI_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step([staged])
        trainer.flush_logs()
        step_s.append(time.perf_counter() - t0)
    wall_s, busy_s, top, classes = profile_window(lambda: (trainer.train_step([staged]), trainer.flush_logs()))
    return float(np.median(step_s[1:])), wall_s, busy_s, top, classes


def train_from_files(card, d, fa, dconv, single, modules, tmp):
    """Main path 14, the README's quick start on the card: a corpus written
    with the port's builders (FILES_TRAIN_SPLITS), ``cli/train``'s
    ``cli_main`` with the QUICK_START arguments at full width for 2 epochs
    (validating and saving at each epoch's end), then a second save dir
    stopped at ``--max-update`` FILES_RESUME_AT and resumed to the end of
    epoch 2. Each update launches exactly phase 7's tensor-core flash
    kernels and each validation batch its forwards; the resumed run ends
    where the straight one does and logs its losses within
    RTOL_RESUME_LOSS. Then ``cli/generate`` decodes the valid split from the
    straight run's ``checkpoint_best.pt`` (its weights bitwise the
    trainer's), held to the in-memory generator on the same batches."""
    import logging

    phase_t0 = time.perf_counter()
    train_cli, options, registry = modules["train_cli"], modules["options"], modules["registry"]
    root = logging.getLogger()
    # the CLI's log lines go to a file here, not to this script's output
    handler = logging.FileHandler(os.path.join(tmp, "train.log"))
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    frames = {split: write_split(modules, d, data_dir, split, n, FILES_TRAIN_TGT_LEN, FILES_TRAIN_TR_LEN, rng)
              for split, n in FILES_TRAIN_SPLITS.items()}
    corpus_s = time.perf_counter() - t0
    dir_a, dir_b = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")

    def run(save_dir, *extra):
        with _TrainRecorder(modules, fa, dconv, single) as rec:
            t0 = time.perf_counter()
            trainer, itr = train_cli.cli_main([data_dir, *QUICK_START, "--save-dir", save_dir, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return rec, trainer, itr, wall, modules["checkpoint"]._manager.best

    reset_counts(fa, dconv, single)
    straight = run(dir_a)
    part1 = run(dir_b, "--max-update", str(FILES_RESUME_AT))
    part2 = run(dir_b)
    launches = launch_counts(fa, dconv, single)

    want_update, want_valid = cli_train_launches(launches)
    recs = [straight[0], part1[0], part2[0]]
    bad = [u for r in recs for u in r.updates if u != want_update] + \
          [v for r in recs for v in r.valid_batches if v != want_valid]
    n_updates = sum(len(r.updates) for r in recs)
    n_valid = sum(len(r.valid_batches) for r in recs)
    want_total = {k: n_updates * want_update[k] + n_valid * want_valid[k] for k in launches}
    if bad or launches != want_total:
        raise AssertionError(f"cli/train launches: {bad[:2]} off the expected {want_update} an update / "
                             f"{want_valid} a validation batch; total {launches} for {want_total}")
    rec_a, trainer_a, itr_a, wall_a, best_a = straight
    rec_b, trainer_b, itr_b, _, best_b = part2
    losses_a, losses_b = rec_a.losses("train"), rec_b.losses("train")
    valid_a = rec_a.losses("valid")
    if not (losses_a and np.isfinite(losses_a).all() and np.isfinite(losses_b).all()):
        raise AssertionError(f"non-finite cli/train losses: {losses_a} {losses_b}")
    tail = losses_a[FILES_RESUME_AT:]
    resume_rel = max(abs(b - a) / abs(a) for a, b in zip(tail, losses_b)) if tail else float("inf")
    state_a = (itr_a.epoch, trainer_a.get_num_updates(), itr_a.iterations_in_epoch, trainer_a.get_lr())
    state_b = (itr_b.epoch, trainer_b.get_num_updates(), itr_b.iterations_in_epoch, trainer_b.get_lr())
    final = {k: v.detach().clone() for k, v in trainer_a.model.state_dict().items()}
    params_b = trainer_b.model.state_dict()
    max_param_diff = max((final[k].float() - params_b[k].float()).abs().max().item() for k in final)
    ckpt_bytes = os.path.getsize(os.path.join(dir_a, "checkpoint_last.pt"))
    files_a = sorted(os.listdir(dir_a))

    # the in-memory step on the CLI's first batch, beside the CLI's update wall
    task = trainer_a.task
    first = next(iter(modules["checkpoint"].get_train_iterator(trainer_a.args, trainer_a, task,
                                                                 epoch=0).next_epoch_itr(shuffle=True)))
    step_s, wall_s, busy_s, top, classes = in_memory_update(trainer_a, first)
    gaps = [b - a for a, b in zip(rec_a.update_starts, rec_a.update_starts[1:])]
    per_epoch = len(rec_a.updates) // 2
    cli_update_ms = float(np.median([g for i, g in enumerate(gaps) if (i + 1) % per_epoch]) * 1e3)

    # decode the valid split from the straight run's checkpoint_best.pt,
    # beside the trainer's weights when it wrote that file
    best_path = os.path.join(dir_a, "checkpoint_best.pt")
    best_state = modules["checkpoint"].load_checkpoint_to_cpu(best_path)
    best_is_final = all(torch.equal(rec_a.best_weights[k], final[k].cpu()) for k in final)
    trainer_a.model.load_state_dict(rec_a.best_weights)
    same_weights = sorted(best_state["model"]) == sorted(rec_a.best_weights) and all(
        torch.equal(best_state["model"][k], v) for k, v in rec_a.best_weights.items())
    results = os.path.join(tmp, "results")
    argv = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path",
            best_path, "--criterion", "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy",
            "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", "valid",
            "--max-tokens", "25000", "--results-path", results]
    reset_counts(fa, dconv, single)
    modules["generate_cli"].cli_main(argv)
    gen_launches = launch_counts(fa, dconv, single)
    hyps, _ = read_records(os.path.join(results, "generate-valid.txt"))
    cli_args = options.parse_args_and_arch(options.get_generation_parser(), argv)
    gtask = registry.TASKS[cli_args.task].setup_task(cli_args)
    gtask.load_dataset("valid")
    batches = list(gtask.get_batch_iterator(
        gtask.dataset("valid"), max_tokens=cli_args.max_tokens, max_sentences=cli_args.max_sentences,
        max_positions=gtask.max_positions(),
        required_batch_size_multiple=cli_args.required_batch_size_multiple).next_epoch_itr(shuffle=False))
    root.removeHandler(handler)
    handler.close()
    want_gen = {k: (FLASH_LAUNCHES_PER_REQUEST * len(batches) if k == FP32_FORWARD else 0) for k in gen_launches}
    model = trainer_a.model.eval()
    tgt = gtask.target_dictionary
    gen = modules["SequenceGenerator"](tgt, beam_size=BEAM, max_len_b=MAX_LEN_B)
    same, worst, n = 0, 0.0, 0
    with torch.no_grad():
        for sample in batches:
            hypos = gen.generate([model], sample)
            check_hypotheses(hypos, tgt.eos(), len(sample["id"]))
            for sid, sent in zip(sample["id"], hypos):
                score, text = hyps[int(sid)]
                same += text == tgt.string(sent[0]["tokens"])
                worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
                n += 1
    n_frames = {k: int(np.sum(v)) for k, v in frames.items()}
    emit({"phase": "train_from_files", "utterances": FILES_TRAIN_SPLITS, "frames": n_frames, "corpus_write_s": corpus_s,
          "updates": len(rec_a.updates), "valid_batches": len(rec_a.valid_batches), "cli_wall_s": wall_a,
          "cli_update_ms_median": cli_update_ms, "train_step_ms_median_first_batch": step_s * 1e3,
          "first_batch_utterances": int(first["nsentences"]), "first_batch_shape": list(first["net_input"]["src_tokens"].shape),
          "profiled_update_s": wall_s, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
          "top_kernels_s": top, "busy_by_class_s": classes, "validate_s": rec_a.validate_s, "save_s": rec_a.save_s,
          "checkpoint_bytes": ckpt_bytes, "checkpoint_files": files_a, "losses_first_last": [losses_a[0], losses_a[-1]],
          "valid_losses": valid_a, "best": best_a, "launches_per_update": want_update,
          "launches_per_valid_batch": want_valid, "launches": launches, "card": card})
    emit({"phase": "train_from_files_resume", "stopped_at": FILES_RESUME_AT, "straight": state_a, "resumed": state_b,
          "best": [best_a, best_b], "max_rel_loss_diff_after_resume": resume_rel, "rtol": RTOL_RESUME_LOSS,
          "max_abs_param_diff": max_param_diff, "card": card})
    emit({"phase": "train_from_files_decode", "phase_s": time.perf_counter() - phase_t0, "utterances": n,
          "batches": len(batches), "launches": gen_launches,
          "identical_top_hypotheses": f"{same}/{n}", "max_abs_score_diff_base2": worst, "atol": FILES_SCORE_ATOL,
          "weights_loaded_equal_the_trainers": same_weights, "checkpoint_best_holds_the_final_weights": best_is_final,
          "card": card})
    if state_a[:3] != state_b[:3] or state_a[3] != state_b[3] or state_a[:3] != (2, len(rec_a.updates),
                                                                                     len(rec_a.updates) // 2):
        raise AssertionError(f"resumed run ends at {state_b}, the straight run at {state_a}")
    if not (best_a is not None and abs(best_b - best_a) <= RTOL_RESUME_LOSS * abs(best_a)):
        raise AssertionError(f"best {best_b} after the resume, {best_a} straight")
    if not (len(losses_b) == len(tail) and resume_rel <= RTOL_RESUME_LOSS):
        raise AssertionError(f"resumed losses {losses_b} against {tail}: {resume_rel} apart")
    if gen_launches != want_gen:
        raise AssertionError(f"cli/generate launches {gen_launches}, expected {want_gen}")
    if not (same_weights and n == len(hyps) == FILES_TRAIN_SPLITS["valid"] and same == n
            and worst <= FILES_SCORE_ATOL):
        raise AssertionError(f"checkpoint_best decodes apart from the trainer: weights equal {same_weights}, "
                             f"{same}/{n} identical, scores {worst} apart")
    return launches


# ---------------------------------------------------------------------------
# 25.-26. the multitask classifier and knowledge distillation from files
# ---------------------------------------------------------------------------

def cli_batches(modules, parser, argv, split):
    """The task a CLI sets up from ``argv`` and the batches it walks over
    ``split``: padded to their longest utterance, 8-row multiples, as
    ``cli/generate_multitask_classifier`` and ``cli/generate_topk`` batch."""
    options, registry = modules["options"], modules["registry"]
    args = options.parse_args_and_arch(parser, argv)
    task = registry.TASKS[args.task].setup_task(args)
    task.load_dataset(split)
    itr = task.get_batch_iterator(task.dataset(split), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
                                  max_positions=task.max_positions(), required_batch_size_multiple=8)
    return task, list(itr.next_epoch_itr(shuffle=False))


def two_utterances(task, split, batch):
    """The first two utterances of ``batch`` collated on their own (the
    conv front end sees the same padding on the card and on the CPU)."""
    ds = task.dataset(split)
    return ds.collater([ds[int(i)] for i in batch["id"][:2]])


def train_cli_run(modules, fa, dconv, single, argv, calls=None, backward_calls=None, route=BF16_BACKWARD,
                  forward=BF16_FORWARD):
    """``cli/train``'s ``cli_main`` on ``argv`` under a ``_TrainRecorder``;
    the launches of each update and validation batch, held to phase 7's 20
    + 20 + 20 tensor-core kernels an update and 20 forwards a validation
    batch (or ``calls`` forwards and ``backward_calls`` pairs, by ``route``
    and ``forward``); the losses it logged finite. Returns the recorder and
    the trainer."""
    with _TrainRecorder(modules, fa, dconv, single) as rec:
        trainer, _ = modules["train_cli"].cli_main(argv)
        torch.cuda.synchronize()
    want_update, want_valid = cli_train_launches(launch_counts(fa, dconv, single), calls, backward_calls, route,
                                                 forward)
    bad = [u for u in rec.updates if u != want_update] + [v for v in rec.valid_batches if v != want_valid]
    if bad or not rec.updates or not rec.valid_batches:
        raise AssertionError(f"cli/train {argv[1:6]}: launches {bad[:2]} off {want_update} an update / {want_valid} "
                             f"a validation batch ({len(rec.updates)} updates, {len(rec.valid_batches)} batches)")
    logged = [value for _, key, value in rec.logged if key in ("loss", "auxiliary_loss")]
    if not (logged and np.isfinite(logged).all()):
        raise AssertionError(f"cli/train {argv[1:6]}: non-finite losses {rec.logged}")
    return rec, trainer


def multitask_from_files(card, d, fa, dconv, single, modules, tmp):
    """25. Main path 15: the multitask classifier from phase 24's corpus on
    the card. A 2-class ``gender`` label an utterance
    (``<split>.de.gender``, the port's builder); ``cli/train`` trains
    ``multitask_conv_transformer`` at full width with
    ``speech_translation_multitask`` and ``cross_entropy_multi_task``
    (label smoothing 0.1, auxiliary weight 0.5, class weights 1 2) in bf16
    for MT_UPDATES updates, each launching 20 + 20 + 20 tensor-core
    kernels, its loss and ``auxiliary_loss`` finite; then
    ``cli/generate_multitask_classifier`` classifies the valid split from
    ``checkpoint_last.pt`` in fp32, MT_CLASSIFY_LAUNCHES tf32x3 forwards a
    batch and nothing else, every row of probabilities summing to 1 within
    1e-4, one CLASS- line an utterance; the card's probabilities against
    the plain CPU path's on 2 utterances at phase 8's tolerance. Returns
    the launches of training and classifying."""
    import contextlib
    import io
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "multitask.log"))
    root.addHandler(handler)
    data_dir, save_dir = os.path.join(tmp, "data"), os.path.join(tmp, "multitask")
    idx = modules["indexed_dataset"]
    rng = np.random.RandomState(11)
    labels = {}
    for split, n in FILES_TRAIN_SPLITS.items():
        labels[split] = rng.randint(2, size=n)
        builder = idx.IndexedDatasetBuilder(os.path.join(data_dir, f"{split}.de.gender.bin"))
        for y in labels[split]:
            builder.add_item(np.array([y], dtype=np.int64))
        builder.finalize(os.path.join(data_dir, f"{split}.de.gender.idx"))
    reset_counts(fa, dconv, single)
    t0 = time.perf_counter()
    rec, trainer = train_cli_run(modules, fa, dconv, single, [
        data_dir, "--task", "speech_translation_multitask", "--auxiliary-suffix", "gender", "-t", "de",
        "--arch", "multitask_conv_transformer", "--input-feat-per-channel", str(N_MELS),
        "--additional-output-size", "2", "--criterion", "cross_entropy_multi_task", "--label-smoothing", "0.1",
        "--auxiliary-loss-weight", "0.5", "--auxiliary-loss-class-weights", "1", "2", *OPTIM_ARGS,
        "--max-update", str(MT_UPDATES), "--save-dir", save_dir])
    train_s = time.perf_counter() - t0
    aux_losses = [value for tag, key, value in rec.logged if tag == "train" and key == "auxiliary_loss"]
    params = sum(p.numel() for p in trainer.model.parameters())
    del trainer
    torch.cuda.empty_cache()

    train_launches = launch_counts(fa, dconv, single)
    last = os.path.join(save_dir, "checkpoint_last.pt")
    argv = [data_dir, "--task", "speech_recognition", "-t", "de", "--path", last, "--gen-subset", "valid",
            "--max-tokens", "25000"]
    task, batches = cli_batches(modules, modules["options"].get_generation_parser(default_task="speech_recognition"),
                                argv, "valid")
    reset_counts(fa, dconv, single)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = modules["classifier_cli"].cli_main(argv)
    classify_s = time.perf_counter() - t0
    classify_launches = launch_counts(fa, dconv, single)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("CLASS-")]
    sums = np.array([float(np.sum(p)) for p in results.values()])
    # the card against the CPU on two utterances
    ckpt = modules["checkpoint"]
    small = two_utterances(task, "valid", batches[0])
    net = small["net_input"]
    probs = []
    for device in ("cuda", "cpu"):
        model = ckpt.load_model_ensemble([last], task=task, device=device)[0][0]
        with torch.no_grad():
            probs.append(model.classify(torch.as_tensor(net["src_tokens"]).to(device),
                                        torch.as_tensor(net["src_lengths"]).to(device)).cpu())
        del model
    card_cpu_err = (probs[0] - probs[1]).abs().max().item()
    root.removeHandler(handler)
    handler.close()
    want = step_launches(classify_launches, 0, 0)
    want[FP32_FORWARD] = MT_CLASSIFY_LAUNCHES * len(batches)
    emit({"phase": "multitask_from_files", "arch": "multitask_conv_transformer", "params": params,
          "classes": 2, "label_share_of_class_1": float(labels["train"].mean()), "updates": len(rec.updates),
          "valid_batches": len(rec.valid_batches), "train_cli_s": train_s, "losses": rec.losses("train"),
          "auxiliary_losses": aux_losses, "valid_losses": rec.losses("valid"),
          "launches_per_update": {k: v for k, v in rec.updates[0].items() if v}, "classify_batches": len(batches),
          "classify_cli_s": classify_s, "classify_launches": {k: v for k, v in classify_launches.items() if v},
          "class_lines": len(lines), "max_abs_prob_sum_err":
          float(np.abs(sums - 1.0).max()), "card_vs_cpu_max_abs_prob_err": card_cpu_err, "atol": ATOL_MODEL,
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    if classify_launches != want:
        raise AssertionError(f"cli/generate_multitask_classifier launches {classify_launches}, expected {want}")
    if not (sorted(results) == list(range(FILES_TRAIN_SPLITS["valid"])) and len(lines) == len(results)
            and all(p.shape == (2,) for p in results.values()) and np.abs(sums - 1.0).max() <= 1e-4):
        raise AssertionError(f"the classifier CLI gave {len(results)} results, {len(lines)} lines, sums {sums}")
    if not (aux_losses and np.isfinite(aux_losses).all() and card_cpu_err <= ATOL_MODEL):
        raise AssertionError(f"auxiliary losses {aux_losses}; card against CPU {card_cpu_err}")
    return {k: train_launches[k] + classify_launches[k] for k in train_launches}


def kd_from_files(card, d, fa, dconv, single, modules, tmp):
    """26. Main path 16: knowledge distillation from phase 24's corpus on
    the card, phase 24's ``checkpoint_best.pt`` (the quick start's CTC
    model) as the teacher. ``cli/generate_topk --distill-topk`` KD_TOPK on
    the train and valid splits in fp32: KD_TOPK_LAUNCHES tf32x3 forwards a
    batch and nothing else, the files read back with one (T, KD_TOPK) item
    an utterance, T its target's length; the card's top-k against the plain
    CPU path's on 2 utterances (logits within phase 8's tolerance, the same
    index at every rank more than max(1e-4, twice the logits' largest
    difference) above the next). Then ``cli/train`` trains the student
    (``conv_transformer``, ``speech_translation_with_transcription_kd``,
    ``knowledge_distillation`` at lambda 0.5 and temperature 2) in bf16 for
    KD_UPDATES updates, each launching 20 + 20 + 20 tensor-core kernels,
    its loss finite. Returns the launches."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "kd.log"))
    root.addHandler(handler)
    data_dir, teacher = os.path.join(tmp, "data"), os.path.join(tmp, "straight", "checkpoint_best.pt")
    topk_cli, ckpt, idx = modules["topk_cli"], modules["checkpoint"], modules["indexed_dataset"]
    reset_counts(fa, dconv, single)
    want = step_launches(launch_counts(fa, dconv, single), 0, 0)
    gen = {}
    for split in FILES_TRAIN_SPLITS:
        argv = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", teacher,
                "--criterion", "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy",
                "--gen-subset", split, "--max-tokens", "25000"]
        parser = modules["options"].get_generation_parser()
        parser.add_argument("--distill-topk", default=8, type=int)
        task, batches = cli_batches(modules, parser, argv, split)
        before = launch_counts(fa, dconv, single)
        t0 = time.perf_counter()
        topk_cli.cli_main(argv + ["--distill-topk", str(KD_TOPK)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = launch_counts(fa, dconv, single)
        got = {k: after[k] - before[k] for k in after}
        want_split = dict(want, **{FP32_FORWARD: KD_TOPK_LAUNCHES * len(batches)})
        if got != want_split:
            raise AssertionError(f"cli/generate_topk on {split}: launches {got}, expected {want_split}")
        prefix = os.path.join(data_dir, f"{split}.de.top{KD_TOPK}")
        items = [idx.IndexedDataset(prefix + s) for s in ("_idx", "_out")]
        targets = task.dataset(split)
        shapes_ok = all(len(ds) == len(targets) for ds in items) and all(
            tuple(items[0].sizes[2 * i:2 * i + 2]) == (len(targets[i]["target"]), KD_TOPK) == tuple(
                items[1].sizes[2 * i:2 * i + 2]) for i in range(len(targets)))
        if not shapes_ok:
            raise AssertionError(f"{prefix}: items not one (T, {KD_TOPK}) an utterance")
        gen[split] = {"batches": len(batches), "cli_s": seconds, "utterances": len(targets)}
    student_dir = os.path.join(tmp, "student")
    t0 = time.perf_counter()
    rec, trainer = train_cli_run(modules, fa, dconv, single, [
        data_dir, "--task", "speech_translation_with_transcription_kd", "-s", "en", "-t", "de",
        "--distill-topk", str(KD_TOPK), "--arch", "conv_transformer", "--input-feat-per-channel", str(N_MELS),
        "--criterion", "knowledge_distillation", "--kd-lambda", "0.5", "--kd-temperature", "2", *OPTIM_ARGS,
        "--max-update", str(KD_UPDATES), "--save-dir", student_dir])
    train_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()
    launches = launch_counts(fa, dconv, single)
    # the card against the CPU on two utterances of the valid split
    small = two_utterances(task, "valid", batches[0])
    top = []
    for device in ("cuda", "cpu"):
        model = ckpt.load_model_ensemble([teacher], task=task, device=device)[0][0]
        batch = {k: torch.as_tensor(small["net_input"][k]).to(device)
                 for k in ("src_tokens", "src_lengths", "prev_output_tokens")}
        with torch.no_grad():
            top.append([x.cpu() for x in torch.topk(model(batch)[0].float(), KD_TOPK + 1, dim=-1)])
        del model
    keep = torch.as_tensor(small["target"] != task.target_dictionary.pad())
    (card_out, card_idx), (cpu_out, cpu_idx) = top
    logit_err = (card_out - cpu_out)[keep].abs().max().item()
    gap = max(1e-4, 2 * logit_err)
    apart = (cpu_out[..., :-1] - cpu_out[..., 1:] > gap) & keep[..., None]
    idx_same = bool(torch.equal(card_idx[..., :-1][apart], cpu_idx[..., :-1][apart]))
    root.removeHandler(handler)
    handler.close()
    emit({"phase": "kd_from_files", "teacher": "phase 24's checkpoint_best.pt", "topk": KD_TOPK,
          "generate_topk": gen, "card_vs_cpu_max_abs_logit_err": logit_err, "atol": ATOL_MODEL,
          "index_gap": gap, "ranks_compared": int(apart.sum()), "ranks": int(keep.sum()) * KD_TOPK,
          "same_indices": idx_same, "student_updates": len(rec.updates), "student_losses": rec.losses("train"),
          "student_valid_losses": rec.losses("valid"), "student_cli_s": train_s,
          "launches_per_update": {k: v for k, v in rec.updates[0].items() if v},
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    if not (logit_err <= ATOL_MODEL and idx_same and apart.float().mean().item() > 0.5 * keep.float().mean().item()):
        raise AssertionError(f"the card's top-{KD_TOPK} differs from the CPU's: logits {logit_err} apart, "
                             f"indices equal {idx_same} at {int(apart.sum())} ranks")
    return launches


# ---------------------------------------------------------------------------
# 27.-28. multilingual ST and cli/generate_dualdecoder from files
# ---------------------------------------------------------------------------

def multilingual_from_files(card, d, fa, dconv, single, modules, tmp):
    """27. Main path 17: multilingual ST (COLING 2020) from phase 24's
    corpus on the card. A second target language, ``nl`` (``{train,
    valid}.nl`` over the same audio, ``dict.nl.txt`` of ``dict.de.txt``'s
    size, the script's writer); ``cli/train`` trains
    ``multilingual_conv_transformer`` at full width (256/768/4, 6 + 6, 80
    mels) on ``en-de`` and ``en-nl`` with one shared encoder, the target's
    language vector and bos token (ML_ARGS), label smoothing 0.1, the quick
    start's optimisation in bf16: ML_UPDATES["concat"] updates under
    ``concat`` and ML_UPDATES["sum"] under ``sum``, each update launching
    40 + 40 + 40 tensor-core kernels (each pair's 20) and each validation
    batch 40 forwards, every update logging a finite loss and each pair's
    ``<pair>:loss``. Then ``cli/generate -s en -t de`` and ``-t nl`` on the
    ``concat`` run's ``checkpoint_last.pt`` in fp32: 8 tf32x3 forwards a
    batch and nothing else, H- lines equal to the in-memory generator's
    through the pair view with the ``__de__`` / ``__nl__`` bos (tokens
    identical, scores within FILES_SCORE_ATOL); the card's pair-view logits
    on 2 utterances against the plain CPU path's at phase 8's tolerance.
    Returns the launches of training and serving."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "multilingual.log"))
    root.addHandler(handler)
    data_dir = os.path.join(tmp, "data")
    rng = np.random.RandomState(13)
    for split, n in FILES_TRAIN_SPLITS.items():
        write_text(modules, d, data_dir, split, "nl", n, FILES_TRAIN_TGT_LEN, rng)
    ckpt = modules["checkpoint"]
    reset_counts(fa, dconv, single)
    runs, timing = {}, None
    for merge, updates in ML_UPDATES.items():
        t0 = time.perf_counter()
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            data_dir, *ML_ARGS, "--langtok-merge-strategy", merge, *OPTIM_ARGS, "--max-update", str(updates),
            "--save-dir", os.path.join(tmp, f"multilingual_{merge}")], calls=ML_FLASH_CALLS_PER_UPDATE)
        seconds = time.perf_counter() - t0
        missing = [k for keys in rec.update_keys for k in ("loss", *(f"{p}:loss" for p in ML_PAIRS))
                   if k not in keys]
        if len(rec.updates) != updates or missing:
            raise AssertionError(f"cli/train {merge}: {len(rec.updates)} updates, logging outputs without {missing}")
        gaps = [b - a for a, b in zip(rec.update_starts, rec.update_starts[1:])]
        runs[merge] = {"updates": len(rec.updates), "valid_batches": len(rec.valid_batches), "cli_s": seconds,
                       "losses": rec.losses("train"), "valid_losses": rec.losses("valid"),
                       "cli_update_ms_median": float(np.median(gaps)) * 1e3 if gaps else None,
                       "launches_per_update": {k: v for k, v in rec.updates[0].items() if v}}
        if timing is None:
            timing = trainer
        else:
            del trainer
    train_launches = launch_counts(fa, dconv, single)
    # the in-memory update on the concat run's first batch, beside the CLI's
    first = next(iter(ckpt.get_train_iterator(timing.args, timing, timing.task, epoch=0).next_epoch_itr(
        shuffle=True)))
    step_s, wall_s, busy_s, _, classes = in_memory_update(timing, first)
    params = sum(p.numel() for p in timing.model.parameters())
    del timing
    torch.cuda.empty_cache()

    last = os.path.join(tmp, "multilingual_concat", "checkpoint_last.pt")
    options = modules["options"]
    serve_launches = {k: 0 for k in train_launches}
    served = {}
    for pair in ML_PAIRS:
        src, tgt = pair.split("-")
        results = os.path.join(tmp, f"multilingual_results_{tgt}")
        argv = [data_dir, "--task", "multilingual_speech_translation", "--lang-pairs", ",".join(ML_PAIRS),
                "-s", src, "-t", tgt, "--encoder-langtok", "tgt", "--decoder-langtok", "--langtok-merge-strategy",
                "concat", "--path", last, "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset",
                "valid", "--max-tokens", "25000", "--results-path", results]
        task, batches = cli_batches(modules, options.get_generation_parser(), argv, "valid")
        before = launch_counts(fa, dconv, single)
        t0 = time.perf_counter()
        modules["generate_cli"].cli_main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = launch_counts(fa, dconv, single)
        got = {k: after[k] - before[k] for k in after}
        want = dict(step_launches(got, 0, 0), **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST * len(batches)})
        if got != want:
            raise AssertionError(f"cli/generate {pair}: launches {got}, expected {want}")
        for k in got:
            serve_launches[k] += got[k]
        hyps, _ = read_records(os.path.join(results, "generate-valid.txt"))
        tgt_dict = task.target_dictionary
        bos = tgt_dict.index(f"__{tgt}__")
        model = ckpt.load_model_ensemble([last], task=task)[0][0]
        view = model.pair_view(pair)
        gen = modules["SequenceGenerator"](tgt_dict, beam_size=BEAM, max_len_b=MAX_LEN_B)
        same, worst, n = 0, 0.0, 0
        with torch.no_grad():
            for sample in batches:
                hypos = gen.generate([view], sample, bos_token=bos)
                check_hypotheses(hypos, tgt_dict.eos(), len(sample["id"]))
                for sid, sent in zip(sample["id"], hypos):
                    score, text = hyps[int(sid)]
                    same += text == tgt_dict.string(sent[0]["tokens"])
                    worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
                    n += 1
        # the card against the CPU on two utterances, teacher-forced
        small = two_utterances(task, "valid", batches[0])
        logits = []
        for device in ("cuda", "cpu"):
            m = model if device == "cuda" else ckpt.load_model_ensemble([last], task=task, device=device)[0][0]
            batch = {k: torch.as_tensor(small["net_input"][k]).to(device)
                     for k in ("src_tokens", "src_lengths", "prev_output_tokens")}
            with torch.no_grad():
                logits.append(m.pair_view(pair)(batch)[0].float().cpu())
            del m
        del model, view
        card_cpu_err = (logits[0] - logits[1]).abs().max().item()
        served[pair] = {"batches": len(batches), "utterances": n, "cli_s": seconds,
                        "identical_top_hypotheses": f"{same}/{n}", "max_abs_score_diff_base2": worst,
                        "card_vs_cpu_max_abs_logit_err": card_cpu_err, "bos": f"__{tgt}__"}
        if not (n == len(hyps) == FILES_TRAIN_SPLITS["valid"] and same == n and worst <= FILES_SCORE_ATOL
                and card_cpu_err <= ATOL_MODEL):
            raise AssertionError(f"cli/generate {pair}: {same}/{n} identical, scores {worst} apart, card against "
                                 f"CPU {card_cpu_err}")
    root.removeHandler(handler)
    handler.close()
    emit({"phase": "multilingual_from_files", "arch": "multilingual_conv_transformer", "pairs": list(ML_PAIRS),
          "params": params, "runs": runs, "train_step_ms_median_first_batch": step_s * 1e3,
          "first_batch_pairs": {p: list(first[p]["net_input"]["src_tokens"].shape) for p in first},
          "profiled_update_s": wall_s, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
          "busy_by_class_s": classes, "serve": served, "atol": ATOL_MODEL, "score_atol": FILES_SCORE_ATOL,
          "train_launches": {k: v for k, v in train_launches.items() if v},
          "serve_launches": {k: v for k, v in serve_launches.items() if v},
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}


def read_dual_records(path):
    """{kind: {id: (score, text)}} of the H-, AUX- and AUXD- lines of a
    ``cli/generate_dualdecoder`` output file."""
    out = {"H": {}, "AUX": {}, "AUXD": {}}
    with open(path, encoding="utf-8") as f:
        for line in f:
            head, _, rest = line.rstrip("\n").partition("\t")
            kind, _, sid = head.partition("-")
            if kind in out and sid.isdigit():
                score, _, text = rest.partition("\t")
                out[kind][int(sid)] = (float(score), text)
    return out


def dualdecoder_from_files(card, d, fa, dconv, single, modules, tmp):
    """28. Main path 18: the dual decoder from phase 24's corpus on the
    card. ``cli/train`` trains ``conv_transformer_dualdecoder`` at full
    width with ``speech_translation_dualdecoding`` and
    ``cross_entropy_dualdecoder`` (0.5 / 0.5, label smoothing 0.1) in bf16
    for DUAL_CLI_UPDATES updates, each launching phase 19's 32 + 32 + 32
    tensor-core kernels and each validation batch 32 forwards; then
    ``cli/generate_dualdecoder`` decodes the valid split from
    ``checkpoint_last.pt`` in fp32, beam 5, ``max_len_b`` 100, in batches of
    DUAL_CLI_BATCH: 20 tf32x3 forwards a batch (phase 17's two-phase
    request) and nothing else, an AUX- and an AUXD- line under every H-
    line's score, the H- and AUX- lines equal to the in-memory
    ``TwoPhaseSequenceGenerator``'s on those weights (tokens identical,
    scores within FILES_SCORE_ATOL); one in-memory batch profiled. Returns
    the launches."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "dualdecoder.log"))
    root.addHandler(handler)
    data_dir, save_dir = os.path.join(tmp, "data"), os.path.join(tmp, "dualdecoder")
    reset_counts(fa, dconv, single)
    t0 = time.perf_counter()
    rec, trainer = train_cli_run(modules, fa, dconv, single, [
        data_dir, "--task", "speech_translation_dualdecoding", "-s", "en", "-t", "de", "--arch", DUAL_ARCH,
        "--input-feat-per-channel", str(N_MELS), "--criterion", "cross_entropy_dualdecoder",
        "--primary-loss-weight", "0.5", "--auxiliary-loss-weight", "0.5", "--label-smoothing", "0.1", *OPTIM_ARGS,
        "--max-update", str(DUAL_CLI_UPDATES), "--save-dir", save_dir], calls=DUAL_FLASH_CALLS_PER_STEP)
    train_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()
    train_launches = launch_counts(fa, dconv, single)

    last = os.path.join(save_dir, "checkpoint_last.pt")
    results = os.path.join(tmp, "dualdecoder_results")
    argv = [data_dir, "--task", "speech_translation_dualdecoding", "-s", "en", "-t", "de", "--path", last,
            "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", "valid",
            "--max-sentences", str(DUAL_CLI_BATCH), "--results-path", results]
    task, batches = cli_batches(modules, modules["options"].get_generation_parser(
        default_task="speech_translation_dualdecoding"), argv, "valid")
    reset_counts(fa, dconv, single)
    t0 = time.perf_counter()
    modules["dual_cli"].cli_main(argv)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    serve_launches = launch_counts(fa, dconv, single)
    want = dict(step_launches(serve_launches, 0, 0),
                **{FP32_FORWARD: TWOPHASE_LAUNCHES_PER_REQUEST * len(batches)})
    if serve_launches != want:
        raise AssertionError(f"cli/generate_dualdecoder launches {serve_launches}, expected {want}")
    records = read_dual_records(os.path.join(results, "generate-valid.txt"))
    model = modules["checkpoint"].load_model_ensemble([last], task=task)[0][0]
    src_dict, tgt_dict = task.source_dictionary, task.target_dictionary
    gen = modules["TwoPhaseSequenceGenerator"](src_dict, tgt_dict, beam_size=BEAM, max_len_b=MAX_LEN_B)
    same, worst, n, decode_s = 0, 0.0, 0, []
    with torch.no_grad():
        for sample in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hypos = gen.generate([model], sample)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            check_hypotheses(hypos, tgt_dict.eos(), len(sample["id"]))
            check_transcripts(hypos, src_dict.eos())
            for sid, sent in zip(sample["id"], hypos):
                score, text = records["H"][int(sid)]
                aux_score, aux_text = records["AUX"][int(sid)]
                same += (text == tgt_dict.string(sent[0]["tokens"])
                         and aux_text == src_dict.string(sent[0]["transcript_tokens"])
                         and records["AUXD"][int(sid)] == (aux_score, aux_text) and aux_score == score)
                worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
                n += 1
        wall_s, busy_s, _, classes = profile_window(lambda: gen.generate([model], batches[0]))
    del model
    root.removeHandler(handler)
    handler.close()
    emit({"phase": "dualdecoder_from_files", "arch": DUAL_ARCH, "updates": len(rec.updates),
          "valid_batches": len(rec.valid_batches), "train_cli_s": train_s, "losses": rec.losses("train"),
          "launches_per_update": {k: v for k, v in rec.updates[0].items() if v},
          "generate_batches": len(batches), "generate_cli_s": generate_s, "in_memory_decode_s": decode_s,
          "profiled_batch_utterances": len(batches[0]["id"]), "profiled_decode_s": wall_s,
          "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s, "busy_by_class_s": classes,
          "generate_launches": {k: v for k, v in serve_launches.items() if v},
          "h_aux_auxd_lines": [len(records[k]) for k in ("H", "AUX", "AUXD")],
          "identical_hypotheses_and_transcripts": f"{same}/{n}", "max_abs_score_diff_base2": worst,
          "score_atol": FILES_SCORE_ATOL, "phase_s": time.perf_counter() - phase_t0, "card": card})
    if not (n == FILES_TRAIN_SPLITS["valid"] and all(len(records[k]) == n for k in records) and same == n
            and worst <= FILES_SCORE_ATOL):
        raise AssertionError(f"cli/generate_dualdecoder: {same}/{n} identical, {[len(v) for v in records.values()]} "
                             f"H/AUX/AUXD lines, scores {worst} apart")
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}


def copy_items(dataset, builder, items, index_path):
    """Write ``items`` (each an item of ``dataset``, or an array) with
    ``builder`` and finalize it at ``index_path``."""
    for item in items:
        builder.add_item(np.asarray(dataset[item]) if isinstance(item, (int, np.integer)) else item)
    builder.finalize(index_path)


def write_context_files(modules, d, data_dir, n_subset):
    """Phase 24's corpus with its context beside each split, written with
    the port's builders: ``{split}.context.de`` (line i the target of line
    i-1, line 0 ``</s>``, as tests/test_context_model.py writes it) and
    ``{split}.context.npz`` (utterance i-1's frames, utterance 0 zeros of
    its own length, the audio generator's first buffer); and ``valid8``,
    the first ``n_subset`` valid utterances, for the chained requests."""
    idx = modules["indexed_dataset"]
    for split in FILES_TRAIN_SPLITS:
        prefix = os.path.join(data_dir, split)
        text = idx.load_indexed_dataset(prefix + ".de", d)
        frames = idx.FilterBanksDataset(prefix + ".npz")
        eos = np.array([d.eos()], dtype=np.int64)
        copy_items(text, idx.IndexedDatasetBuilder(prefix + ".context.de.bin"),
                   [eos] + list(range(len(text) - 1)), prefix + ".context.de.idx")
        copy_items(frames, idx.AudioIndexedDatasetBuilder(prefix + ".context.npz.bin"),
                   [np.zeros_like(np.asarray(frames[0]))] + list(range(len(frames) - 1)),
                   prefix + ".context.npz.idx")
        if split == "valid":
            sub = os.path.join(data_dir, "valid8")
            copy_items(frames, idx.AudioIndexedDatasetBuilder(sub + ".npz.bin"), range(n_subset), sub + ".npz.idx")
            copy_items(text, idx.IndexedDatasetBuilder(sub + ".de.bin"), range(n_subset), sub + ".de.idx")


def check_dead_rows(fa):
    """Rows with every key masked (a shape bucket's padding rows, which the
    ctxreg penalty sends a gradient) through the card's flash route, at the
    context attention's shape in both types, against the plain version on
    the CPU: out within ATOL_KERNEL and dq, dk, dv within 1e-2 of their own
    max|plain| in bf16 (ATOL_GRAD in fp32), every value finite, and each
    masked row's out V's mean."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = random_attention_inputs(gen, 256, 54, 48, 64, dtype)
        bias[::4] = -1e9  # every fourth row: no real key
        grad = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        got, want = [], []
        for side, device in ((got, "cuda"), (want, "cpu")):
            x = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
            out = fa.flash_attention(*x, bias.to(device), 0.125)
            out.backward(grad.to(device))
            side.extend(t.detach().float().cpu() for t in (out, *(y.grad for y in x)))
        out_err = (got[0] - want[0]).abs().max().item()
        grad_errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item() if dtype == torch.bfloat16
                     else (a - b).abs().max().item() for a, b in zip(got[1:], want[1:])]
        mean_err = (got[0][::4] - v[::4].float().cpu().mean(1, keepdim=True)).abs().max().item()
        finite = all(torch.isfinite(t).all().item() for t in got)
        errs[str(dtype).replace("torch.", "")] = {"out": out_err, "dq_dk_dv": grad_errs, "masked_rows_vs_mean_v": mean_err,
                                                  "finite": finite}
        limit = 1e-2 if dtype == torch.bfloat16 else ATOL_GRAD[dtype]
        if not (finite and out_err <= ATOL_KERNEL[dtype] and max(grad_errs) <= limit
                and mean_err <= ATOL_KERNEL[dtype]):
            raise AssertionError(f"flash on rows with every key masked, {dtype}: {errs}")
    return errs


class _ChainRecorder:
    """Each ``generate`` call of the context generators while
    ``cli/generate`` runs: the buffer it started from, its batch's ids and
    its last row's best hypothesis."""

    def __init__(self, cls):
        self.cls, self.calls = cls, []

    def __enter__(self):
        rec, original = self, self.cls.generate
        self.original = original

        def generate(gen, models, sample, *args, **kwargs):
            buffer = None if gen.buffer is None else np.array(gen.buffer, copy=True)
            hypos = original(gen, models, sample, *args, **kwargs)
            rec.calls.append((buffer, [int(i) for i in sample["id"]], np.asarray(hypos[-1][0]["tokens"])))
            return hypos

        self.cls.generate = generate
        return self

    def __exit__(self, *exc):
        self.cls.generate = self.original
        return False


def context_from_files(card, d, fa, dconv, single, modules, tmp):
    """29. Main path 19: context-aware ST (INTERSPEECH 2020) from phase 24's
    corpus on the card, its context files written beside it
    (``write_context_files``). ``cli/train`` trains ``conv_transformer_context``
    at full width (256/768/4, 6 + 6 layers, 80 mels, one context layer)
    with ``speech_recognition_context``, ``--pretrained-model`` phase 24's
    ``checkpoint_best.pt`` with ``--freeze-pretrained encoder``, weight
    decay 0.01, ``label_smoothed_cross_entropy_ctxreg`` (0.1, alpha 0.3) and
    the quick start's optimisation in bf16: ``--context-type tgt`` with
    parallel gating for CTX_UPDATES["tgt"] updates, ``src`` with sequential
    gating for CTX_UPDATES["src"]; each update launches exactly
    CTX_FORWARDS forwards and CTX_BACKWARDS tensor-core pairs (the counts
    read from the code before the first run), each validation batch the
    forwards. Every frozen parameter is bitwise the checkpoint's after the
    updates (with ``src`` the audio context encoder's BatchNorm statistics
    too), every trainable one moved, the main encoder's BatchNorm
    statistics moved; the losses are finite and the gate penalty (the
    parallel gates' sum on two valid utterances) above 0. Then
    ``cli/generate`` on the ``tgt`` run's ``checkpoint_last.pt`` in fp32,
    beam 5, ``max_len_b`` 100, ``--max-sentences 1`` over the first
    CTX_SERVE_UTTERANCES valid utterances: CTX_REQUEST_LAUNCHES tf32x3
    forwards a request and nothing else, each request's context the
    previous request's best hypothesis, the H- lines the in-memory chained
    generator's (tokens identical, scores within FILES_SCORE_ATOL); and on
    the ``src`` run's in batches of CTX_SRC_BATCH over the valid split. The
    card's teacher-forced logits with context against the plain CPU
    path's on 2 utterances at phase 8's tolerance, for each context type.
    First, before the counts are set to 0, ``check_dead_rows``. Returns the
    launches of training and serving."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "context.log"))
    root.addHandler(handler)
    data_dir = os.path.join(tmp, "data")
    ckpt, options, registry = modules["checkpoint"], modules["options"], modules["registry"]
    t0 = time.perf_counter()
    write_context_files(modules, d, data_dir, CTX_SERVE_UTTERANCES)
    corpus_s = time.perf_counter() - t0
    pre_path = os.path.join(tmp, "straight", "checkpoint_best.pt")
    pre = ckpt.load_checkpoint_to_cpu(pre_path)["model"]
    dead_rows = check_dead_rows(fa)

    reset_counts(fa, dconv, single)
    runs, timed, lasts = {}, None, {}
    for ctype, updates in CTX_UPDATES.items():
        save_dir = os.path.join(tmp, f"context_{ctype}")
        t0 = time.perf_counter()
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            data_dir, *CTX_ARGS, "--context-type", ctype, "--context-decoder-attention-type", CTX_ATTENTION[ctype],
            "--pretrained-model", pre_path, *OPTIM_ARGS, "--max-update", str(updates), "--save-dir", save_dir],
            calls=CTX_FORWARDS[ctype], backward_calls=CTX_BACKWARDS[ctype])
        train_s = time.perf_counter() - t0
        lasts[ctype] = os.path.join(save_dir, "checkpoint_last.pt")
        model = trainer.model
        start = trainer.task.build_model(trainer.args, device="cpu").state_dict()  # the run's seeded start
        got = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        params = dict(model.named_parameters())
        frozen = [n for n in params if model.frozen_param_filter(n)]
        unfrozen_in_optimizer = [n for n in frozen if params[n].requires_grad]
        not_pretrained = [n for n in frozen
                          if not torch.equal(got[n], pre[n.replace("context_encoder.audio_encoder.", "encoder.")])]
        trainable = [n for n, p in params.items() if p.requires_grad]
        # every trainable parameter moves but those whose gradient is 0 by
        # construction, 0 themselves, so weight decay leaves them: the key
        # projections' biases (a softmax does not see a shift) and, in
        # parallel mode, the decoder's unused context LayerNorm's biases
        still = [n for n in trainable if torch.equal(got[n], start[n]) and not n.endswith("k_proj.bias")
                 and not (CTX_ATTENTION[ctype] == "parallel" and n.endswith("context_attn_layer_norm.bias"))]
        bn_moved = not torch.equal(got["encoder.bn.0.running_mean"], start["encoder.bn.0.running_mean"])
        audio_buffers = [k for k in got if k.startswith("context_encoder.audio_encoder.") and k not in params]
        audio_moved = [k for k in audio_buffers if not torch.equal(got[k], pre[k.replace(
            "context_encoder.audio_encoder.", "encoder.")])]
        losses = rec.losses("train")
        runs[ctype] = {"updates": len(rec.updates), "valid_batches": len(rec.valid_batches), "train_cli_s": train_s,
                       "losses": losses, "valid_losses": rec.losses("valid"),
                       "launches_per_update": {k: v for k, v in rec.updates[0].items() if v},
                       "launches_per_valid_batch": {k: v for k, v in rec.valid_batches[0].items() if v},
                       "frozen_params": len(frozen), "trainable_params": len(trainable),
                       "frozen_elements": sum(params[n].numel() for n in frozen),
                       "trainable_elements": sum(params[n].numel() for n in trainable),
                       "audio_encoder_buffers_checked": len(audio_buffers)}
        gaps = [b - a for a, b in zip(rec.update_starts, rec.update_starts[1:])]
        runs[ctype]["cli_update_ms_median"] = float(np.median(gaps)) * 1e3 if gaps else None
        if (len(rec.updates) != updates or not frozen or unfrozen_in_optimizer or not_pretrained or still
                or not bn_moved or audio_moved or (ctype == "src") != bool(audio_buffers)):
            raise AssertionError(f"context {ctype}: {len(rec.updates)} updates; frozen {len(frozen)}, in the "
                                 f"optimiser {unfrozen_in_optimizer[:3]}, apart from the checkpoint "
                                 f"{not_pretrained[:3]}; trainable unmoved {still[:3]}; encoder BN moved {bn_moved}; "
                                 f"audio encoder buffers moved {audio_moved[:3]}")
        if ctype == "tgt":
            timed = trainer
        else:
            del trainer, model
    train_launches = launch_counts(fa, dconv, single)
    # the in-memory update on the tgt run's first batch, beside the CLI's
    first = next(iter(ckpt.get_train_iterator(timed.args, timed, timed.task, epoch=0).next_epoch_itr(shuffle=True)))
    step_s, wall_s, busy_s, _, classes = in_memory_update(timed, first)
    n_params = sum(p.numel() for p in timed.model.parameters())
    del timed
    torch.cuda.empty_cache()

    # serving: tgt chained over single utterances, src in batches
    serve, serve_launches = {}, {k: 0 for k in train_launches}
    for ctype, subset, extra in (("tgt", "valid8", ["--max-sentences", "1"]),
                                 ("src", "valid", ["--max-sentences", str(CTX_SRC_BATCH)])):
        results = os.path.join(tmp, f"context_results_{ctype}")
        argv = [data_dir, "--task", "speech_recognition_context", "--context-type", ctype, "-t", "de", "--path",
                lasts[ctype], "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", subset, *extra,
                "--results-path", results]
        task, batches = cli_batches(modules, options.get_generation_parser(), argv, subset)
        before = launch_counts(fa, dconv, single)
        with _ChainRecorder(modules["ContextAwareSequenceGenerator"]) as chain:
            t0 = time.perf_counter()
            modules["generate_cli"].cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        after = launch_counts(fa, dconv, single)
        got = {k: after[k] - before[k] for k in after}
        want = dict(step_launches(got, 0, 0), **{FP32_FORWARD: CTX_REQUEST_LAUNCHES[ctype] * len(batches)})
        if got != want:
            raise AssertionError(f"cli/generate context {ctype}: launches {got}, expected {want}")
        for k in got:
            serve_launches[k] += got[k]
        hyps, _ = read_records(os.path.join(results, f"generate-{subset}.txt"))
        tgt_dict = task.target_dictionary
        model = ckpt.load_model_ensemble([lasts[ctype]], task=task)[0][0]
        gen = task.build_generator([model], options.parse_args_and_arch(options.get_generation_parser(), argv))
        chained = ([np.array_equal(chain.calls[i][0][0], chain.calls[i - 1][2]) for i in range(1, len(chain.calls))]
                   if ctype == "tgt" else None)
        same, worst, n, request_s = 0, 0.0, 0, []
        with torch.no_grad():
            for sample in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hypos = gen.generate([model], sample)
                torch.cuda.synchronize()
                request_s.append(time.perf_counter() - t0)
                check_hypotheses(hypos, tgt_dict.eos(), len(sample["id"]))
                for sid, sent in zip(sample["id"], hypos):
                    score, text = hyps[int(sid)]
                    same += text == tgt_dict.string(sent[0]["tokens"])
                    worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
                    n += 1
        # the card against the CPU on two utterances, teacher-forced with their context
        targs = options.parse_args_and_arch(options.get_training_parser(), [
            data_dir, "--task", "speech_recognition_context", "--context-type", ctype, "-t", "de", "--arch", CTX_ARCH])
        ttask = registry.TASKS[targs.task].setup_task(targs)
        ttask.load_dataset("valid")
        ds = ttask.dataset("valid")
        small = ds.collater([ds[0], ds[1]])["net_input"]
        logits, penalty = [], None
        for device in ("cuda", "cpu"):
            m = model if device == "cuda" else ckpt.load_model_ensemble([lasts[ctype]], task=task, device=device)[0][0]
            batch = {k: torch.as_tensor(v).to(device) for k, v in small.items()}
            with torch.no_grad():
                out, extra_out = m(batch)
            logits.append(out.float().cpu())
            if device == "cuda" and extra_out["ctx_gates"]:
                penalty = float(sum(g.float().sum() for g in extra_out["ctx_gates"]))
            del m
        del model
        card_cpu_err = (logits[0] - logits[1]).abs().max().item()
        serve[ctype] = {"subset": subset, "batches": len(batches), "utterances": n, "generate_cli_s": seconds,
                        "seconds_per_request": seconds / len(batches), "in_memory_request_s": request_s,
                        "identical_top_hypotheses": f"{same}/{n}", "max_abs_score_diff_base2": worst,
                        "chained_calls": len(chain.calls),
                        "each_context_the_previous_best": None if chained is None else all(chained),
                        "card_vs_cpu_max_abs_logit_err": card_cpu_err, "gate_penalty_two_utterances": penalty,
                        "launches": {k: v for k, v in got.items() if v}}
        ok = n == len(hyps) and same == n and worst <= FILES_SCORE_ATOL and card_cpu_err <= ATOL_MODEL
        if ctype == "tgt":
            ok = (ok and n == CTX_SERVE_UTTERANCES and len(chain.calls) == n and all(chained)
                  and chain.calls[0][0].tolist() == [[tgt_dict.eos()]]
                  and [c[1] for c in chain.calls] == [[i] for i in range(n)]
                  and penalty is not None and np.isfinite(penalty) and penalty > 0)
        if not ok:
            raise AssertionError(f"cli/generate context {ctype}: {same}/{n} identical, scores {worst} apart, "
                                 f"chained {chained}, card against CPU {card_cpu_err}, gate penalty {penalty}")
    root.removeHandler(handler)
    handler.close()
    logged = [v for r in runs.values() for v in r["losses"] + r["valid_losses"]]
    emit({"phase": "context_from_files", "arch": CTX_ARCH, "params": n_params, "corpus_write_s": corpus_s,
          "pretrained": "phase 24's checkpoint_best.pt", "freeze_pretrained": "encoder", "runs": runs,
          "train_step_ms_median_first_batch": step_s * 1e3,
          "first_batch_shape": list(first["net_input"]["src_tokens"].shape),
          "first_batch_context_shape": list(first["net_input"]["context_tokens"].shape),
          "profiled_update_s": wall_s, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
          "busy_by_class_s": classes, "serve": serve, "atol": ATOL_MODEL, "score_atol": FILES_SCORE_ATOL,
          "flash_rows_with_every_key_masked": dead_rows,
          "train_launches": {k: v for k, v in train_launches.items() if v},
          "serve_launches": {k: v for k, v in serve_launches.items() if v},
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    if not (logged and np.isfinite(logged).all()):
        raise AssertionError(f"context losses {logged}")
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}


# ---------------------------------------------------------------------------
# 30. from raw files to the papers' scores
# ---------------------------------------------------------------------------

def counted_calls(owner, name, counters):
    """Patch ``owner.name`` to record the launches of each call (a dict of
    count deltas a call, appended to the returned list) until ``restore``."""
    calls, original = [], getattr(owner, name)

    def call(*args, **kwargs):
        before = launch_counts(*counters)
        out = original(*args, **kwargs)
        after = launch_counts(*counters)
        calls.append({k: after[k] - before[k] for k in after})
        return out

    setattr(owner, name, call)
    return calls, lambda: setattr(owner, name, original)


def read_generate(path):
    """{kind: {id: fields}} of the T-/H-/D-/P- lines of a
    ``generate-<subset>.txt`` and the BLEU result string."""
    records, result = {}, None
    with open(path, encoding="utf-8") as f:
        for line in f:
            head, _, rest = line.rstrip("\n").partition("\t")
            if head[:2] in ("T-", "H-", "D-", "P-"):
                records.setdefault(head[0], {})[int(head[2:])] = rest.split("\t")
            elif "| Generate " in line:
                result = line.strip().split(": ", 1)[1]
    return records, result


def captured(fn, *args):
    """``fn(*args)``'s standard output, kept out of this script's."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def files_equal(a_dir, b_dir, names):
    def read(path):
        with open(path, "rb") as f:
            return f.read()
    return {name: read(os.path.join(a_dir, name)) == read(os.path.join(b_dir, name)) for name in names}


def raw_from_corpus(modules, d, data_dir, raw_dir, split):
    """Phase 24's ``split`` as the raw files a user brings: its filterbanks
    as an npz stream (a count, then one array an utterance) and its target
    and transcript lines as text. Returns the utterance count."""
    idx = modules["indexed_dataset"]
    frames = idx.FilterBanksDataset(os.path.join(data_dir, f"{split}.npz"))
    with open(os.path.join(raw_dir, f"{split}_fbank.npz"), "wb") as f:
        np.save(f, np.array([len(frames)]))
        for i in range(len(frames)):
            np.save(f, frames[i])
    for lang in ("de", "en"):
        text = idx.IndexedDataset(os.path.join(data_dir, f"{split}.{lang}"), fix_lua_indexing=True)
        with open(os.path.join(raw_dir, f"{split}.{lang}"), "w", encoding="utf-8") as f:
            for i in range(len(text)):
                f.write(" ".join(d[int(t)] for t in text[i][:-1]) + "\n")  # the eos is the writer's
    return len(frames)


def data_in(modules, d, data_dir, tmp, split):
    """``cli/preprocess_audio`` and ``cli/preprocess`` (``--tgtdict``: phase
    24's dictionary, ``--dataset-impl cached``: phase 24's builder) on the
    raw files of ``split``: the files byte for byte phase 24's, and the
    task's items on the written data-bin equal to phase 24's."""
    raw_dir, bin_dir = os.path.join(tmp, "raw"), os.path.join(tmp, "data-bin")
    os.makedirs(raw_dir)
    n = raw_from_corpus(modules, d, data_dir, raw_dir, split)
    t0 = time.perf_counter()
    modules["preprocess_audio_cli"].cli_main(["--audio-features", os.path.join(raw_dir, f"{split}_fbank.npz"),
                                              "--format", "npz", "--output", os.path.join(bin_dir, f"{split}.npz")])
    for lang in ("de", "en"):
        modules["preprocess_cli"].cli_main(["--target-lang", lang, "--tgtdict",
                                            os.path.join(data_dir, f"dict.{lang}.txt"), f"--{split}pref",
                                            os.path.join(raw_dir, split), "--destdir", bin_dir,
                                            "--dataset-impl", "cached", "--workers", "2"])
    cli_s = time.perf_counter() - t0
    names = [f"{split}.{kind}.{ext}" for kind in ("npz", "de", "en") for ext in ("bin", "idx")] + \
            ["dict.de.txt", "dict.en.txt"]
    same_files = files_equal(data_dir, bin_dir, names)
    tasks = []
    for path in (data_dir, bin_dir):
        argv = [path, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--criterion",
                "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy"]
        args = modules["options"].parse_args_and_arch(modules["options"].get_generation_parser(), argv)
        task = modules["registry"].TASKS[args.task].setup_task(args)
        task.load_dataset(split)
        tasks.append(task.dataset(split))
    same_items = all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in ((tasks[0][i], tasks[1][i]) for i in range(n))) and len(tasks[1]) == n
    out = {"utterances": n, "cli_s": cli_s, "files_byte_equal": same_files, "items_equal": same_items}
    if not (all(same_files.values()) and same_items):
        raise AssertionError(f"the writers' files differ from phase 24's corpus: {out}")
    return out, raw_dir


def resegmentation(modules, data_dir, raw_dir, tmp, split, rng):
    """``scripts/resegment_data_mustc`` on a MuST-C segmentation of the
    first RESEG_SEGMENTS utterances of ``split`` (10 ms frames, 1 s apart on
    one wav) cut in two at a random point each, read by ``yaml`` (where it
    is installed) and by the fallback parser: each pair of new segments'
    transcripts and targets joins to its original line, word for word, and
    both parsers give the same lines."""
    import importlib.util

    frames = modules["indexed_dataset"].FilterBanksDataset(os.path.join(data_dir, f"{split}.npz"))
    orig, new, offset = [], [], 0.0
    for i in range(RESEG_SEGMENTS):
        dur = round(frames.size(i) * FRAME_SECONDS, 2)
        cut = round(dur * rng.uniform(0.3, 0.7), 2)
        orig.append(f"- {{duration: {dur}, offset: {offset}, wav: ted_1.wav}}")
        new.append(f"- {{duration: {cut}, offset: {offset}, wav: ted_1.wav}}")
        new.append(f"- {{duration: {dur - cut}, offset: {offset + cut}, wav: ted_1.wav}}")
        offset = round(offset + dur + 1.0, 2)
    paths = {name: os.path.join(tmp, name) for name in ("orig.yaml", "new.yaml", "orig.en", "orig.de", "new.en",
                                                          "new.de")}
    for name, lines in (("orig.yaml", orig), ("new.yaml", new)):
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    originals = {}
    for lang in ("en", "de"):
        with open(os.path.join(raw_dir, f"{split}.{lang}"), encoding="utf-8") as f:
            originals[lang] = [next(f).rstrip("\n") for _ in range(RESEG_SEGMENTS)]
        with open(paths[f"orig.{lang}"], "w", encoding="utf-8") as f:
            f.write("\n".join(originals[lang]) + "\n")
    argv = ["--orig-yaml", paths["orig.yaml"], "--orig-text", paths["orig.en"], paths["orig.de"], "--new-yaml",
            paths["new.yaml"], "--output", paths["new.en"], paths["new.de"]]
    rejoined, outputs, seconds = {}, [], {}
    # with yaml where it is installed, then with the fallback parser
    for parser in ("yaml", "fallback") if importlib.util.find_spec("yaml") else ("fallback",):
        saved = sys.modules.get("yaml")
        if parser == "fallback":
            sys.modules["yaml"] = None  # ``import yaml`` raises ImportError
        try:
            t0 = time.perf_counter()
            modules["resegment"].cli_main(argv)
            seconds[parser] = time.perf_counter() - t0
        finally:
            if parser == "fallback":
                if saved is None:
                    del sys.modules["yaml"]
                else:
                    sys.modules["yaml"] = saved
        lines = {}
        for lang in ("en", "de"):
            with open(paths[f"new.{lang}"], encoding="utf-8") as f:
                lines[lang] = f.read().splitlines()
        rejoined[parser] = {lang: sum((pieces[2 * i] + " " + pieces[2 * i + 1]).split() == originals[lang][i].split()
                                      for i in range(RESEG_SEGMENTS)) if len(pieces) == 2 * RESEG_SEGMENTS else 0
                            for lang, pieces in lines.items()}
        outputs.append(lines)
    out = {"segments": RESEG_SEGMENTS, "new_segments": len(new), "seconds": seconds, "rejoined": rejoined,
           "parsers_agree": all(o == outputs[0] for o in outputs)}
    if not (out["parsers_agree"] and all(r == {"en": RESEG_SEGMENTS, "de": RESEG_SEGMENTS}
                                         for r in rejoined.values())):
        raise AssertionError(f"the resegmented lines do not rejoin to the originals: {out}")
    return out


def averaging(modules, save_dir, tmp):
    """``cli/average_checkpoints --num-epoch-checkpoints 2`` on phase 24's
    save dir: every float tensor bitwise the float64 mean of
    checkpoint1.pt and checkpoint2.pt rounded to float32."""
    out_path = os.path.join(tmp, "average.pt")
    t0 = time.perf_counter()
    modules["average_cli"].cli_main(["--inputs", save_dir, "--num-epoch-checkpoints", "2", "--output", out_path])
    seconds = time.perf_counter() - t0
    inputs = [torch.load(os.path.join(save_dir, f"checkpoint{e}.pt"), map_location="cpu", weights_only=False)["model"]
              for e in (1, 2)]
    got = torch.load(out_path, map_location="cpu", weights_only=False)["model"]
    floats = [k for k, v in inputs[0].items() if v.is_floating_point()]
    exact = sorted(got) == sorted(inputs[0]) and all(
        torch.equal(got[k], ((inputs[0][k].double() + inputs[1][k].double()) / 2).float()) for k in floats)
    moved = sum(not torch.equal(inputs[0][k], inputs[1][k]) for k in floats)
    out = {"cli_s": seconds, "tensors": len(got), "float_tensors": len(floats), "differing_inputs": moved,
           "bitwise_float64_mean": exact, "bytes": os.path.getsize(out_path)}
    if not (exact and moved > 0):
        raise AssertionError(f"the average is not the float64 mean of the inputs: {out}")
    return out_path, out


def mustshe_inputs(refs, tmp):
    """The MuST-SHE-format definitions over the references ``refs`` (id ->
    line): one term a line, its correct form the line's first word and a
    fixed wrong form; POS and agreement definitions (two terms: the first
    and the last word of the line when they differ); an NE/terminology IOB
    reference (words 1-2 a PER entity, word 4 a TERM); and two IOB streams
    over the references for ``combine_ne_terms``, the terminology stream
    cutting word 3 of every other line in two."""
    ids = sorted(refs)
    words = {i: refs[i].split() for i in ids}
    cats = ("1F", "1M", "2F", "2M")
    rows = ["ID\tCATEGORY\tGENDER\tGENDERTERMS"] + [
        f"s{i}\t{cats[i % 4]}\t{'She' if i % 2 else 'He'}\t{words[i][0]} wrongform{i}" for i in ids]
    pos = ["ID\tPOS"] + [f"s{i}\t{('noun', 'adj', 'art/prep', 'verb')[i % 4]}" for i in ids]
    agr = ["ID\tAGR_KIND\tAGR_TERMS\tAGR_IDS"] + [
        f"s{i}\tchain\t{words[i][0]} wrongform{i};{words[i][-1]} otherform{i}\t0;1"
        for i in ids if words[i][0] != words[i][-1]]
    iob, ner, term = [], [], []
    for n, i in enumerate(ids):
        w = words[i]
        tags = ["O"] * len(w)
        tags[1], tags[2], tags[4] = "B-PER", "I-PER", "B-TERM"
        iob.append("".join(f"{k + 1}\t{t}\t{g}\n" for k, (t, g) in enumerate(zip(w, tags))))
        ner.append("".join(f"{k + 1}\t{t}\t{'O' if g == 'B-TERM' else g}\n" for k, (t, g) in enumerate(zip(w, tags))))
        t_words, t_tags = list(w), ["B-TERM" if g == "B-TERM" else "O" for g in tags]
        if n % 2:
            t_words[3:4], t_tags[3:4] = [w[3][:2], w[3][2:]], ["O", "O"]
        term.append("".join(f"{k + 1}\t{t}\t{g}\n" for k, (t, g) in enumerate(zip(t_words, t_tags))))
    files = {"mustshe.tsv": rows, "pos.tsv": pos, "agr.tsv": agr}
    for name, lines in files.items():
        with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    for name, sentences in (("ne_ref.iob", iob), ("ner.iob", ner), ("term.iob", term)):
        with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
            f.write("\n".join(sentences) + "\n")
    return len(ids), len(agr) - 1


def read_tsv(path):
    import csv

    with open(path, encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def fbk_scores(modules, tmp, lines, name, n_terms, n_agrs):
    """Every FBK evaluation script on ``lines`` (id -> line) as one system
    ``name``: MuST-SHE accuracy (its printed table), the word-level and
    agreement full tables and their aggregates under the bundled configs,
    and NE/terminology accuracy. Returns the scores, each table held to
    its shape: one row a term (a group, a metric), each system's columns."""
    scripts = modules["fbk_scripts"]
    config_dir = os.path.join(os.path.dirname(scripts["mustshe_acc"].__file__), "config_files")
    sys_dir = os.path.join(tmp, "fbk_" + name)
    os.makedirs(sys_dir)
    hyp = os.path.join(sys_dir, "out.system")
    with open(hyp, "w", encoding="utf-8") as f:
        f.write("".join(lines[i] + "\n" for i in sorted(lines)))
    t = lambda n: os.path.join(tmp, n)  # noqa: E731
    o = lambda n: os.path.join(sys_dir, n)  # noqa: E731
    t0 = time.perf_counter()
    acc = captured(scripts["mustshe_acc"].cli_main, ["--input", hyp, "--tsv-definition", t("mustshe.tsv"),
                                                      "--sentence-acc", o("sentence_acc.tsv")])
    captured(scripts["mustshe_acc_fulltable"].cli_main, ["--input-prefix", os.path.join(sys_dir, "out."),
                                                          "--tsv-definition", t("mustshe.tsv"),
                                                          "--pos-definition", t("pos.tsv"), "--output", o("full.tsv")])
    captured(scripts["accuracy_from_fulltable"].cli_main, ["--fulltable", o("full.tsv"), "--config",
                                                            os.path.join(config_dir, "config.word-level.json"),
                                                            "--output", o("word_metrics.tsv")])
    captured(scripts["mustshe_agr_fulltable"].cli_main, ["--input-prefix", os.path.join(sys_dir, "out."),
                                                          "--tsv-definition", t("mustshe.tsv"),
                                                          "--agr-definition", t("agr.tsv"), "--output", o("agr.tsv")])
    captured(scripts["agreement_from_fulltable"].cli_main, ["--fulltable", o("agr.tsv"), "--config",
                                                             os.path.join(config_dir, "config.agr-level.json"),
                                                             "--output", o("agr_metrics.tsv")])
    ne = captured(scripts["ne_terms_accuracy"].cli_main, ["--input", hyp, "--ne-reference", t("ne_ref.iob")])
    seconds = time.perf_counter() - t0

    table = [line.split("\t") for line in acc.splitlines() if "\t" in line][1:]
    full, agr = read_tsv(o("full.tsv")), read_tsv(o("agr.tsv"))
    word_metrics, agr_metrics = read_tsv(o("word_metrics.tsv")), read_tsv(o("agr_metrics.tsv"))
    ne_rows = [line.split("\t") for line in ne.splitlines() if line.count("\t") == 3 and not line.startswith("Type")]
    col = "out.system_"
    shaped = (sorted(r[0] for r in table) == ["1F", "1M", "2F", "2M", "Global"]
              and len(full) == n_terms and f"{col}found_correct" in full[0]
              and len(agr) == n_agrs and f"{col}agreement_correct" in agr[0]
              and len(word_metrics) >= 4 and f"{col}gender_accuracy" in word_metrics[0]
              and len(agr_metrics) == 3 and f"{col}agreement_correct_percent" in agr_metrics[0]
              and sorted(r[0] for r in ne_rows) == ["PER", "PER", "TERM", "TERM"])
    scores = {"mustshe_acc": {r[0]: [float(r[1]), float(r[2])] for r in table},
              "word_metrics": {r["metric"]: [float(r[f"{col}term_coverage"]), float(r[f"{col}gender_accuracy"])]
                               for r in word_metrics},
              "agreement": {r["metric"]: [float(r[f"{col}agreement_correct_percent"]),
                                          float(r[f"{col}in_coverage_percent"])] for r in agr_metrics},
              "ne_terms": [[r[0], float(r[1]), float(r[2]), int(r[3])] for r in ne_rows],
              "seconds": seconds, "well_formed": shaped}
    if not shaped:
        raise AssertionError(f"an FBK score table on {name} is malformed: {scores}")
    return scores


def all_ones(scores):
    values = [v for row in scores["mustshe_acc"].values() for v in row]
    values += [v for key in ("word_metrics", "agreement") for row in scores[key].values() for v in row]
    values += [v for row in scores["ne_terms"] for v in row[1:3]]
    return bool(values) and all(v == 1.0 for v in values)


def combine_streams(modules, tmp, ids):
    """``combine_ne_terms`` over the NER and terminology streams: one row a
    NER token, the TERM and PER tags where the streams put them."""
    out = captured(modules["fbk_scripts"]["combine_ne_terms"].cli_main,
                   [os.path.join(tmp, "ner.iob"), os.path.join(tmp, "term.iob")])
    sentences = [s for s in out.split("\n\n") if s.strip()]
    with open(os.path.join(tmp, "ner.iob"), encoding="utf-8") as f:
        ner = [s for s in f.read().split("\n\n") if s.strip()]
    ok = len(sentences) == len(ids) and all(
        len(s.splitlines()) == len(n.splitlines()) and [r.split("\t")[2] for r in s.splitlines()][1:3] == ["B-PER",
                                                                                                          "I-PER"]
        and s.splitlines()[4].split("\t")[2] == "B-TERM" for s, n in zip(sentences, ner))
    if not ok:
        raise AssertionError("combine_ne_terms merged the streams wrongly")
    return {"sentences": len(sentences), "rows": sum(len(s.splitlines()) for s in sentences), "well_formed": ok}


def raw_to_scores(card, d, fa, dconv, single, modules, tmp, lc_dicts):
    """30. Main path 20, the fork's workflow from raw files to the FBK
    papers' scores on the card, on phase 24's corpus and save dir: the data
    writers (``cli/preprocess_audio`` and ``cli/preprocess`` on the valid
    split written out as raw files: the files byte for byte phase 24's, the
    items the task loads equal), the MuST-C resegmentation,
    ``cli/average_checkpoints`` of the last two epochs (bitwise the float64
    mean), ``cli/generate`` of the average (8 tf32x3 forwards a batch and
    nothing else), ``cli/generate --score-reference`` (20 a batch and
    nothing else; the P- scores within SCORE_REF_ATOL of the in-memory
    ``SequenceScorer`` on the card, within ATOL_MODEL of the CPU's on 2
    utterances; each H- score its P- scores' mean), ``cli/score`` on the D-
    lines (``cli/generate``'s BLEU line exactly), every FBK evaluation
    script on the D- lines (well-formed tables) and on the references (every
    score 1.0), ``combine_ne_terms``; then ``cli/interactive`` serving
    phase 9's ``dynamicconv_wmt_en_de_big`` from a ``save_model_checkpoint``
    file (INTERACTIVE_LINES lines of 10-60 tokens, ``--buffer-size`` and
    ``--max-sentences`` INTERACTIVE_BUFFER, beam 5): 7
    ``dynamic_conv_fwd_tc`` a batch and nothing else, one S- and one H- line
    an input line, the H- lines the in-memory generator's on the same
    batches (scores within SCORE_REF_ATOL). Returns the launches."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "raw_to_scores.log"))
    root.addHandler(handler)
    work = os.path.join(tmp, "raw_to_scores")
    os.makedirs(work)
    data_dir, save_dir, split = os.path.join(tmp, "data"), os.path.join(tmp, "straight"), "valid"
    rng = np.random.RandomState(30)
    checkpoint, options, registry = modules["checkpoint"], modules["options"], modules["registry"]

    written, raw_dir = data_in(modules, d, data_dir, work, split)
    reseg = resegmentation(modules, data_dir, raw_dir, work, split, rng)
    avg_path, avg = averaging(modules, save_dir, work)

    # phase 9's model saved as a user's checkpoint, with its dictionaries
    src_dict, tgt_dict = lc_dicts
    lc_dir = os.path.join(work, "lc-bin")
    os.makedirs(lc_dir)
    src_dict.save(os.path.join(lc_dir, "dict.en.txt"))
    tgt_dict.save(os.path.join(lc_dir, "dict.de.txt"))
    lc_model = modules["build_model"](LC_ARCH, tgt_dict, src_dict, seed=0)
    lc_args = types.SimpleNamespace(arch=LC_ARCH, task="translation", criterion="label_smoothed_cross_entropy",
                                    seed=0)
    registry.apply_architecture(lc_args)
    lc_ckpt = os.path.join(work, "dynamicconv.pt")
    modules["save_model_checkpoint"](lc_ckpt, lc_args, lc_model)
    src, _ = text_pairs(rng, INTERACTIVE_LINES, 10, 60, LC_VOCAB)
    lines = [" ".join(src_dict[int(t)] for t in s[:-1]) for s in src]
    input_path = os.path.join(work, "input.txt")
    with open(input_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

    speech = ["--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--criterion",
              "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy", "--gen-subset", split,
              "--max-tokens", "25000"]
    decode_argv = [data_dir, *speech, "--path", avg_path, "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B),
                   "--results-path", os.path.join(work, "decode")]
    score_argv = [data_dir, *speech, "--path", avg_path, "--score-reference",
                  "--results-path", os.path.join(work, "score_reference")]
    interactive_argv = [lc_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", lc_ckpt, "--beam",
                        str(BEAM), "--max-len-b", str(MAX_LEN_B), "--buffer-size", str(INTERACTIVE_BUFFER),
                        "--max-sentences", str(INTERACTIVE_BUFFER), "--input", input_path]

    # the main path: the three CLIs that reach the card, each batch counted
    counters = (fa, dconv, single)
    walls = {}
    reset_counts(fa, dconv, single)
    per_batch, restore = counted_calls(modules["Task"], "inference_step", counters)
    try:
        for name, fn, argv in (("decode", modules["generate_cli"].cli_main, decode_argv),
                               ("score_reference", modules["generate_cli"].cli_main, score_argv),
                               ("interactive", modules["interactive_cli"].cli_main, interactive_argv)):
            start = len(per_batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = captured(fn, argv)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0, per_batch[start:], out)
    finally:
        restore()
    launches = launch_counts(fa, dconv, single)
    none = {k: 0 for k in launches}
    want = {"decode": dict(none, **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST}),
            "score_reference": dict(none, **{FP32_FORWARD: SCORE_REF_LAUNCHES}),
            "interactive": dict(none, **{DCONV_FORWARD: DCONV_LAUNCHES_PER_REQUEST})}
    for name, (_, batches, _) in walls.items():
        bad = [b for b in batches if b != want[name]]
        if bad or not batches:
            raise AssertionError(f"{name}: launches {bad[:2]} a batch, expected {want[name]} "
                                 f"({len(batches)} batches)")
    total = {k: sum(len(walls[n][1]) * want[n][k] for n in want) for k in launches}
    if launches != total:
        raise AssertionError(f"phase 30 launched {launches}, its batches {total}")

    # the decode of the average, and cli/score on its D- lines
    decoded, result = read_generate(os.path.join(work, "decode", f"generate-{split}.txt"))
    refs = {i: t[0] for i, t in decoded["T"].items()}
    hyps = {i: h[1] for i, h in decoded["D"].items()}
    scored = {}
    for name, lines_of in (("decode", hyps), ("references", refs)):
        path = os.path.join(work, f"{name}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(lines_of[i] + "\n" for i in sorted(lines_of)))
        scored[name] = path
    score_lines = {name: captured(modules["score_cli"].cli_main, ["--sys", path, "--ref", scored["references"]]).strip()
                   for name, path in scored.items()}

    # --score-reference against the in-memory scorer on the card, and the CPU
    sr, _ = read_generate(os.path.join(work, "score_reference", f"generate-{split}.txt"))
    cli_args = options.parse_args_and_arch(options.get_generation_parser(), score_argv)
    task = registry.TASKS[cli_args.task].setup_task(cli_args)
    task.load_dataset(split)
    batches = list(task.get_batch_iterator(
        task.dataset(split), max_tokens=cli_args.max_tokens, max_sentences=cli_args.max_sentences,
        max_positions=task.max_positions(),
        required_batch_size_multiple=cli_args.required_batch_size_multiple).next_epoch_itr(shuffle=False))
    model = checkpoint.load_model_ensemble([avg_path], task=task)[0][0]
    scorer = modules["SequenceScorer"](task.target_dictionary)
    ln2 = math.log(2)
    worst_p, worst_h, worst_mean, n_scored = 0.0, 0.0, 0.0, 0
    for sample in batches:
        for sid, hypo in zip(sample["id"], scorer.generate([model], sample)):
            h = hypo[0]
            printed = np.array(sr["P"][int(sid)][0].split(), float)
            worst_p = max(worst_p, float(np.abs(printed - h["positional_scores"] / ln2).max()))
            worst_h = max(worst_h, abs(float(sr["H"][int(sid)][0]) - h["score"] / ln2))
            worst_mean = max(worst_mean, abs(float(sr["H"][int(sid)][0]) - printed.mean()))
            n_scored += sr["H"][int(sid)][1] == refs[int(sid)]
    wall_s, busy_s, top, classes = profile_window(lambda: scorer.generate([model], batches[0]))
    score_profile = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1 - busy_s / wall_s,
                     "busy_by_class_s": classes, "utterances": len(batches[0]["id"])}
    small = two_utterances(task, split, batches[0])
    cpu_model = checkpoint.load_model_ensemble([avg_path], task=task, device="cpu")[0][0]
    card_pos, cpu_pos = (np.concatenate([h[0]["positional_scores"] for h in scorer.generate([m], small)])
                         for m in (model, cpu_model))
    cpu_err = float(np.abs(card_pos - cpu_pos).max())
    del model, cpu_model
    torch.cuda.empty_cache()

    # every FBK script on the D- lines and on the references
    n_terms, n_agrs = mustshe_inputs(refs, work)
    fbk = {"decode": fbk_scores(modules, work, hyps, "decode", n_terms, n_agrs),
           "references": fbk_scores(modules, work, refs, "references", n_terms, n_agrs)}
    combined = combine_streams(modules, work, sorted(refs))

    # cli/interactive against the in-memory generator on the same batches
    served = {}
    for line in walls["interactive"][2].splitlines():
        head, _, rest = line.partition("\t")
        if head[:2] in ("S-", "H-"):
            served.setdefault(head[0], {})[int(head[2:])] = rest.split("\t")
    lc_task = types.SimpleNamespace(source_dictionary=src_dict, args=types.SimpleNamespace(left_pad_source=True))
    gen = modules["SequenceGenerator"](tgt_dict, beam_size=BEAM, max_len_b=MAX_LEN_B)
    same, worst_lc, start = 0, 0.0, 0
    lc_batches = []
    for buffer in modules["interactive_cli"].buffered_read(input_path, INTERACTIVE_BUFFER):
        batch = next(modules["interactive_cli"].make_batches(buffer, lc_task))
        sample = {"net_input": {"src_tokens": batch.src_tokens, "src_lengths": batch.src_lengths}}
        lc_batches.append(sample)
        for i, sent in enumerate(gen.generate([lc_model], sample)):
            score, text = served["H"][start + i]
            same += text == tgt_dict.string(sent[0]["tokens"])
            worst_lc = max(worst_lc, abs(float(score) - sent[0]["score"]))
        start += len(buffer)
    wall_s, busy_s, _, lc_classes = profile_window(lambda: gen.generate([lc_model], lc_batches[0]))
    decode_profile = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1 - busy_s / wall_s,
                      "busy_by_class_s": lc_classes, "sentences": INTERACTIVE_BUFFER}
    del lc_model
    torch.cuda.empty_cache()
    root.removeHandler(handler)
    handler.close()

    bleu_equal = score_lines["decode"] == result
    emit({"phase": "raw_to_scores_data", "writers": written, "resegmentation": reseg, "average": avg,
          "combine_ne_terms": combined, "card": card})
    emit({"phase": "raw_to_scores_serve", "cli_wall_s": {k: v[0] for k, v in walls.items()},
          "batches": {k: len(v[1]) for k, v in walls.items()}, "launches_per_batch": {
              k: {n: c for n, c in want[k].items() if c} for k in want},
          "bleu_generate": result, "bleu_score_cli": score_lines, "bleu_equal": bleu_equal,
          "score_reference": {"utterances": n_scored, "max_abs_p_err_base2": worst_p, "max_abs_h_err_base2": worst_h,
                              "max_abs_h_minus_mean_p": worst_mean, "atol": SCORE_REF_ATOL,
                              "card_vs_cpu_max_abs_err": cpu_err, "cpu_atol": ATOL_MODEL},
          "scorer_profile": score_profile, "interactive": {
              "lines": INTERACTIVE_LINES, "s_lines": len(served.get("S", {})), "h_lines": len(served.get("H", {})),
              "identical_to_in_memory": f"{same}/{INTERACTIVE_LINES}", "max_abs_score_diff": worst_lc},
          "interactive_decode_profile": decode_profile, "card": card})
    emit({"phase": "raw_to_scores_fbk", "terms": n_terms, "agreement_groups": n_agrs, **fbk,
          "references_all_one": all_ones(fbk["references"]), "phase_s": time.perf_counter() - phase_t0,
          "card": card})
    n_valid = written["utterances"]
    if not (n_scored == n_valid == len(sr["H"]) and worst_p <= SCORE_REF_ATOL and worst_h <= SCORE_REF_ATOL
            and worst_mean <= SCORE_REF_ATOL and cpu_err <= ATOL_MODEL):
        raise AssertionError(f"--score-reference: {n_scored}/{n_valid} references, P- {worst_p}, H- {worst_h}, "
                             f"H- vs mean P- {worst_mean} apart; card vs CPU {cpu_err}")
    if not (bleu_equal and result and score_lines["references"].startswith("BLEU4 = 100.00")):
        raise AssertionError(f"cli/score {score_lines} against cli/generate's {result}")
    if not all_ones(fbk["references"]):
        raise AssertionError(f"the FBK scores of the references are not all 1.0: {fbk['references']}")
    if not (len(served.get("S", {})) == len(served.get("H", {})) == INTERACTIVE_LINES and same == INTERACTIVE_LINES
            and worst_lc <= SCORE_REF_ATOL):
        raise AssertionError(f"cli/interactive: {same}/{INTERACTIVE_LINES} H- lines the in-memory generator's, "
                             f"scores {worst_lc} apart")
    return launches


# ---------------------------------------------------------------------------
# 31. the wiring from files
# ---------------------------------------------------------------------------

def write_wav(path, samples):
    """16-bit mono PCM of ``samples`` in [-1, 1] at JSON_RATE."""
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(JSON_RATE)
        w.writeframes((np.clip(samples, -1.0, 1.0) * 32767).astype("<i2").tobytes())


def write_json_corpus(modules, d, json_dir, rng):
    """JSON_SPLITS utterances of seeded noise as WAVs, their labels (20-48
    tokens of ``d``) and each split's JSON by ``scripts/asr_prep_json``;
    ``dict.txt`` beside them. Returns the seconds it took."""
    t0 = time.perf_counter()
    os.makedirs(json_dir)
    d.save(os.path.join(json_dir, "dict.txt"))
    for split, n in JSON_SPLITS.items():
        wav_dir = os.path.join(json_dir, "wav", split)
        os.makedirs(wav_dir)
        labels = []
        for i in range(n):
            utt = f"spk{i % 4}-{split}-{i:04d}"
            seconds = rng.uniform(*JSON_SECONDS)
            write_wav(os.path.join(wav_dir, utt + ".wav"), 0.1 * rng.randn(int(seconds * JSON_RATE)))
            words = [d[int(t)] for t in rng.randint(4, len(d), size=rng.randint(*FILES_TRAIN_TGT_LEN))]
            labels.append(f"{utt} {' '.join(words)}")
        label_path = os.path.join(json_dir, f"{split}.labels")
        with open(label_path, "w", encoding="utf-8") as f:
            f.write("\n".join(labels) + "\n")
        modules["asr_prep_json"].cli_main(["--audio-dirs", wav_dir, "--labels", label_path, "--dictionary",
                                           os.path.join(json_dir, "dict.txt"),
                                           "--output", os.path.join(json_dir, f"{split}.json")])
    return time.perf_counter() - t0


def read_generate_all(path):
    """{kind: {id: fields}} of a ``generate-<subset>.txt``'s record lines
    (A- included)."""
    records = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            head, _, rest = line.rstrip("\n").partition("\t")
            if head[:2] in ("S-", "T-", "H-", "D-", "P-", "A-"):
                records.setdefault(head[0], {})[int(head[2:])] = rest.split("\t")
    return records


def generate_counted(modules, counters, argv):
    """``cli/generate``'s ``cli_main(argv)``: (its launches in all, the
    launches of each ``inference_step``, the wall seconds)."""
    fa, dconv, single = counters
    reset_counts(fa, dconv, single)
    per_batch, restore = counted_calls(modules["Task"], "inference_step", counters)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modules["generate_cli"].cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    return launch_counts(fa, dconv, single), per_batch, wall


def write_gpt2_files(work):
    """A byte-level BPE vocabulary of GPT-2's layout in ``work``: every
    byte's char (the printable bytes as themselves, the others from U+0100
    on), a few merges. Returns (encoder.json, vocab.bpe)."""
    import json as json_module

    byte_vocab = os.path.join(work, "encoder.json")
    merges = os.path.join(work, "vocab.bpe")
    printable = [*range(ord("!"), ord("~") + 1), *range(ord("\u00a1"), ord("\u00ac") + 1),
                 *range(ord("\u00ae"), ord("\u00ff") + 1)]
    chars = sorted(chr(c) for c in printable + [256 + i for i in range(256 - len(printable))])
    pairs = ["\u0120 t", "h e", "\u0120t he", "e l", "el l", "l o", "\u0120 w", "o r"]
    vocab_ids = {c: i for i, c in enumerate(chars)}
    for m in pairs:
        vocab_ids.setdefault(m.replace(" ", ""), len(vocab_ids))
    vocab_ids["<|endoftext|>"] = len(vocab_ids)
    with open(byte_vocab, "w", encoding="utf-8") as f:
        json_module.dump(vocab_ids, f)
    with open(merges, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(pairs) + "\n")
    return byte_vocab, merges


def codec_runs(modules, work):
    """Each codec whose library the machine has, on one sentence: its
    encoding and decoding (``nltk`` without its data raises
    ``LookupError``, as JAX's does); the SentencePiece codecs from a model
    ``scripts/spm_tools`` trains here, whose ``spm_encode`` /
    ``spm_decode`` give every line back; the codecs whose library is
    absent raise ``ImportError`` naming it."""
    import argparse
    import importlib.util

    enc = modules["encoders"]
    found = {p: importlib.util.find_spec(p) is not None for p in CODEC_PACKAGES}
    text = GPT2_TEXT
    vocab = os.path.join(work, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", ",", "!", "it", "'", "s", "a",
                           "test", "well", "-", "known", "."]) + "\n")
    byte_vocab, merges = write_gpt2_files(work)
    # a SentencePiece model trained here by scripts/spm_tools, where the
    # machine has sentencepiece: the two codecs and spm_encode / spm_decode
    rng = np.random.RandomState(0)
    spm_lines = [" ".join("".join(rng.choice(list("abcdefghij"), rng.randint(1, 6))) for _ in range(rng.randint(2, 9)))
                 for _ in range(200)]
    spm_text, spm_prefix = os.path.join(work, "spm_train.txt"), os.path.join(work, "spm")
    with open(spm_text, "w", encoding="utf-8") as f:
        f.write("\n".join(spm_lines) + "\n")
    spm_model = spm_prefix + ".model"
    spm_round_trip = None
    if found["sentencepiece"]:
        modules["spm_tools"].spm_train([f"--input={spm_text}", f"--model_prefix={spm_prefix}", "--vocab_size=40",
                                        "--model_type=bpe", "--hard_vocab_limit=false"])
        pieces = os.path.join(work, "spm_pieces.txt")
        modules["spm_tools"].spm_encode(["--model", spm_model, "--inputs", spm_text, "--outputs", pieces])
        decoded = captured(modules["spm_tools"].spm_decode, ["--model", spm_model, "--input", pieces]).splitlines()
        spm_round_trip = sum(a == b for a, b in zip(decoded, spm_lines))
    cases = {"space": ("tokenizer", {}, None), "moses": ("tokenizer", {}, "sacremoses"),
             "nltk": ("tokenizer", {}, "nltk"), "bytes": ("bpe", {}, None), "characters": ("bpe", {}, None),
             "sentencepiece": ("bpe", {"sentencepiece_vocab": spm_model}, "sentencepiece"),
             "byte_bpe": ("bpe", {"sentencepiece_model_path": spm_model}, "sentencepiece"),
             "subword_nmt": ("bpe", {"bpe_codes": merges}, "subword_nmt"),
             "fastbpe": ("bpe", {"bpe_codes": merges}, "fastBPE"),
             "gpt2": ("bpe", {"gpt2_encoder_json": byte_vocab, "gpt2_vocab_bpe": merges}, "transformers"),
             "bert": ("bpe", {"bpe_vocab_file": vocab}, "transformers"),
             "hf_byte_bpe": ("bpe", {"bpe_vocab": byte_vocab, "bpe_merges": merges}, "tokenizers")}
    out = {}
    for name, (kind, kw, package) in cases.items():
        args = argparse.Namespace(**{kind: name}, **kw)
        try:
            codec = (enc.build_tokenizer if kind == "tokenizer" else enc.build_bpe)(args)
            encoded = codec.encode(text)
            out[name] = {"encoded": encoded, "decoded": codec.decode(encoded)}
        except ImportError as e:
            if package is None or found[package] or package not in str(e):
                raise
            out[name] = {"raises": "ImportError", "names": package}
        except LookupError as e:  # nltk without its punkt data, as JAX's raises
            if package != "nltk":
                raise
            out[name] = {"raises": type(e).__name__, "message": str(e)[:120]}
    if found["transformers"]:
        # --bpe gpt2 held to the CPU test's ids from the same files (an empty
        # encoding was seen on the card's machine before)
        import transformers

        out["gpt2"].update(transformers=transformers.__version__, ids_the_cpu_test_gets=GPT2_IDS)
        if not out["gpt2"].get("encoded") or out["gpt2"]["encoded"] != GPT2_IDS:
            raise AssertionError(f"--bpe gpt2 with transformers {transformers.__version__}: {out['gpt2']}, "
                                 f"the CPU test gets {GPT2_IDS!r}")
    if spm_round_trip is not None:
        out["spm_tools"] = {"lines": len(spm_lines), "round_trip_equal": spm_round_trip}
        if spm_round_trip != len(spm_lines):
            raise AssertionError(f"spm_encode + spm_decode: {spm_round_trip}/{len(spm_lines)} lines back")
    return found, out


def wiring_from_files(card, d, fa, dconv, single, modules, tmp, lc_dicts):
    """31. Main path 21, the rest of the wiring from files on the card, in
    phase 24's directory after phase 30 (its corpus, its save dir and phase
    30's copy of phase 9's model):

      * the JSON route: JSON_SPLITS utterances of seeded 16 kHz WAVs
        (409-509 frames) and their JSON (``scripts/asr_prep_json``);
        ``cli/train --task speech_recognition --dataset-from-json`` of the
        quick start's conv_transformer with label-smoothed CE in bf16, its
        checkpoints sharded and written asynchronously: JSON_STOP updates,
        resumed to JSON_END, against a straight JSON_END-update run (the
        weights and the optimiser state bitwise equal; phase 7's 20 + 20 +
        20 tensor-core launches an update, 20 a validation batch); then
        ``cli/generate --dataset-from-json`` of the sharded
        ``checkpoint_last.pt`` (8 fp32 forwards a batch);
      * ``cli/generate`` of phase 24's ``checkpoint_best.pt``:
        ``--print-alignment --replace-unk`` (8 a batch for the search and
        ALIGN_LAUNCHES for the alignments' forward: the last layer's
        cross-attention alone off the flash route), its A- lines one pair a
        hypothesis token, the attention rows of 2 utterances within
        ALIGN_ATTN_ATOL of the CPU's and the pairs equal where the top two
        weights differ by more than ALIGN_MARGIN; ``--num-shards 2`` with
        shard ids 0 and 1, whose H- lines together are phase 24's
        unsharded run's; ``--model-overrides`` keeping encoder layers
        PRUNE_KEEP (PRUNED_LAUNCHES a batch);
      * ``cli/export_fairseq_checkpoint`` then ``cli/import_fairseq_checkpoint``
        of ``checkpoint_best.pt`` and of the sharded checkpoint: the state
        dicts bitwise;
      * the codecs: ``cli/interactive --tokenizer space --bpe characters``
        on phase 9's model (DCONV_LAUNCHES_PER_REQUEST a batch), its D-
        lines the CPU's decoding of its H- lines; each codec whose library
        the machine has run on a sentence, the others raising by name;
        ``--sacrebleu`` and ``--eval-bleu`` raising by name without
        ``sacrebleu``;
      * ``--user-dir``: a module in the work directory registers an arch
        alias, and ``cli/train`` trains it for one update.

    Returns the launches of all of it."""
    import argparse
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "wiring_from_files.log"))
    root.addHandler(handler)
    work = os.path.join(tmp, "wiring")
    os.makedirs(work)
    rng = np.random.RandomState(31)
    counters = (fa, dconv, single)
    checkpoint, options, registry = modules["checkpoint"], modules["options"], modules["registry"]
    data_dir, save_dir = os.path.join(tmp, "data"), os.path.join(tmp, "straight")
    total = {k: 0 for k in launch_counts(fa, dconv, single)}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # the JSON route, trained with sharded asynchronous checkpoints
    json_dir = os.path.join(work, "json")
    corpus_s = write_json_corpus(modules, d, json_dir, rng)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward algorithms: bitwise repeatable ones
    try:
        for name, save, updates in (("stop", "json_resumed", JSON_STOP), ("resume", "json_resumed", JSON_END),
                                    ("straight", "json_straight", JSON_END)):
            reset_counts(fa, dconv, single)
            t0 = time.perf_counter()
            rec, trainer = train_cli_run(modules, fa, dconv, single, [
                json_dir, *JSON_ARGS, "--max-update", str(updates), "--save-dir", os.path.join(work, save)])
            runs[name] = (rec, trainer, time.perf_counter() - t0)
            add(launch_counts(fa, dconv, single))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    resumed, straight = runs["resume"][1], runs["straight"][1]
    weights_equal = all(torch.equal(v, straight.model.state_dict()[k]) for k, v in resumed.model.state_dict().items())
    opt_a, opt_b = resumed.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"]
    optimizer_equal = sorted(opt_a) == sorted(opt_b) and all(
        torch.equal(v, opt_b[i][k]) for i, e in opt_a.items() for k, v in e.items())
    json_ckpt = os.path.join(work, "json_straight", "checkpoint_last.pt")
    sharded_files = sorted(os.listdir(os.path.join(work, "json_straight")))
    del resumed, straight
    runs = {name: (rec, None, wall) for name, (rec, _, wall) in runs.items()}  # the trainers freed
    torch.cuda.empty_cache()
    json_results = os.path.join(work, "json_generate")
    json_gen_argv = [json_dir, "--task", "speech_recognition", "--dataset-from-json", "--path", json_ckpt,
                     "--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", "valid", "--max-tokens",
                     "25000", "--results-path", json_results]
    json_launches, json_batches, json_wall = generate_counted(modules, counters, json_gen_argv)
    add(json_launches)
    json_records = read_generate_all(os.path.join(json_results, "generate-valid.txt"))

    # generation on phase 24's checkpoint_best.pt
    best = os.path.join(save_dir, "checkpoint_best.pt")
    speech = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--criterion",
              "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy", "--path", best, "--beam",
              str(BEAM), "--max-len-b", str(MAX_LEN_B), "--gen-subset", "valid", "--max-tokens", str(GEN_MAX_TOKENS)]
    gens = {}
    for name, extra in (("align", ["--print-alignment", "--replace-unk"]),
                        ("shard0", ["--num-shards", "2", "--shard-id", "0"]),
                        ("shard1", ["--num-shards", "2", "--shard-id", "1"]),
                        ("pruned", ["--model-overrides", repr({"encoder_layers_to_keep": PRUNE_KEEP})])):
        results = os.path.join(work, f"generate_{name}")
        launches, batches, wall = generate_counted(modules, counters, [*speech, *extra, "--results-path", results])
        add(launches)
        gens[name] = (launches, batches, wall, read_generate_all(os.path.join(results, "generate-valid.txt")))
    unsharded, _ = read_generate(os.path.join(tmp, "results", "generate-valid.txt"))

    # the alignments' attention, card against CPU, on 2 utterances
    align_utils = modules["alignment_utils"]
    cli_args = options.parse_args_and_arch(options.get_generation_parser(), speech)
    task = registry.TASKS[cli_args.task].setup_task(cli_args)
    task.load_dataset("valid")
    batch = next(iter(task.get_batch_iterator(
        task.dataset("valid"), max_tokens=cli_args.max_tokens, max_sentences=cli_args.max_sentences,
        max_positions=task.max_positions(),
        required_batch_size_multiple=cli_args.required_batch_size_multiple).next_epoch_itr(shuffle=False)))
    small = two_utterances(task, "valid", batch)
    card_model = checkpoint.load_model_ensemble([best], task=task)[0][0]
    cpu_model = checkpoint.load_model_ensemble([best], task=task, device="cpu")[0][0]
    gen = modules["SequenceGenerator"](task.target_dictionary, beam_size=BEAM, max_len_b=MAX_LEN_B)
    with torch.no_grad():
        hypos = gen.generate([card_model], small)
    pad, eos = task.target_dictionary.pad(), task.target_dictionary.eos()
    card_attn, card_valid, tgt_lens = align_utils.alignment_attention(card_model, small, hypos, pad, eos)
    cpu_attn, cpu_valid, _ = align_utils.alignment_attention(cpu_model, small, hypos, pad, eos)
    attn_err, pairs_held, pairs_equal = 0.0, 0, 0
    for i in range(len(hypos)):
        s_len, t_len = int(card_valid[i]), int(tgt_lens[i])
        a, b = card_attn[i, :t_len, :s_len], cpu_attn[i, :t_len, :s_len]
        attn_err = max(attn_err, float(np.abs(a - b).max()))
        top2 = np.sort(b, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > ALIGN_MARGIN
        pairs_held += int(clear.sum())
        pairs_equal += int((np.argmax(a, 1) == np.argmax(b, 1))[clear].sum())
    del card_model, cpu_model
    torch.cuda.empty_cache()

    # the fork-checkpoint CLIs, round trip
    round_trips = {}
    for name, path in (("checkpoint_best", best), ("json_sharded", json_ckpt)):
        fork, back = os.path.join(work, f"{name}_fork.pt"), os.path.join(work, f"{name}_imported.pt")
        captured(modules["export_cli"].cli_main, [path, fork])
        captured(modules["import_cli"].cli_main, [fork, back])
        a, b = checkpoint.load_checkpoint_to_cpu(path)["model"], checkpoint.load_checkpoint_to_cpu(back)["model"]
        round_trips[name] = {"tensors": len(a), "bitwise": sorted(a) == sorted(b) and all(
            torch.equal(v, b[k]) for k, v in a.items())}

    # the codecs: cli/interactive on phase 9's model, and each library found
    lc_dir = os.path.join(tmp, "raw_to_scores", "lc-bin")
    lc_ckpt = os.path.join(tmp, "raw_to_scores", "dynamicconv.pt")
    src_dict, tgt_dict = lc_dicts
    src, _ = text_pairs(rng, CODEC_LINES, 5, 20, LC_VOCAB)
    input_path = os.path.join(work, "codec_input.txt")
    with open(input_path, "w", encoding="utf-8") as f:
        f.write("".join(" ".join(src_dict[int(t)] for t in s[:-1]) + "\n" for s in src))
    codec_argv = [lc_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", lc_ckpt, "--beam", str(BEAM),
                  "--max-len-b", "20", "--buffer-size", str(INTERACTIVE_BUFFER), "--max-sentences",
                  str(INTERACTIVE_BUFFER), "--input", input_path, "--tokenizer", "space", "--bpe", "characters"]
    reset_counts(fa, dconv, single)
    per_batch, restore = counted_calls(modules["Task"], "inference_step", counters)
    try:
        out = captured(modules["interactive_cli"].cli_main, codec_argv)
    finally:
        restore()
    codec_launches = launch_counts(fa, dconv, single)
    add(codec_launches)
    served = {}
    for line in out.splitlines():
        head, _, rest = line.partition("\t")
        if head[:2] in ("S-", "H-", "D-"):
            served.setdefault(head[0], {})[int(head[2:])] = rest.split("\t")
    _, decode_fn = modules["encoders"].codec_chain(argparse.Namespace(tokenizer="space", bpe="characters"))
    d_equal = sum(served["D"][i][1] == decode_fn(served["H"][i][1]) for i in served.get("H", {}))
    found, codecs = codec_runs(modules, work)
    sacrebleu_checks = {}
    if not found["sacrebleu"]:
        for flag, fn in (("--sacrebleu", lambda: modules["generate_cli"].cli_main(
                [*speech, "--sacrebleu", "--results-path", os.path.join(work, "sacrebleu")])),
                         ("--eval-bleu", lambda: modules["TranslationTask"](argparse.Namespace(
                             eval_bleu=True, eval_bleu_detok="space"), src_dict, tgt_dict))):
            try:
                fn()
                sacrebleu_checks[flag] = "ran"
            except ImportError as e:
                sacrebleu_checks[flag] = "raises ImportError naming sacrebleu" if "sacrebleu" in str(e) else str(e)

    # --user-dir: an arch alias from a module in the work directory
    user_dir = os.path.join(work, "fbk_port_user_module")
    os.makedirs(user_dir)
    with open(os.path.join(user_dir, "__init__.py"), "w") as f:
        f.write("from fbk_fairseq_st_tpu_torch import registry\n\n"
                f"registry.register_architecture({USER_ARCH!r}, 'conv_transformer')\n")
    user_argv = [data_dir, *QUICK_START, "--max-update", "1", "--user-dir", user_dir, "--save-dir",
                 os.path.join(work, "user_dir_run")]
    user_argv[user_argv.index("conv_transformer")] = USER_ARCH
    reset_counts(fa, dconv, single)
    user_rec, user_trainer = train_cli_run(modules, fa, dconv, single, user_argv)
    add(launch_counts(fa, dconv, single))
    user_arch = (user_trainer.args.arch, user_trainer.get_num_updates())
    del user_trainer
    torch.cuda.empty_cache()
    root.removeHandler(handler)
    handler.close()

    none = {k: 0 for k in total}
    want = {"json_generate": dict(none, **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST}),
            "align": dict(none, **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST + ALIGN_LAUNCHES}),
            "shard0": dict(none, **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST}),
            "shard1": dict(none, **{FP32_FORWARD: FLASH_LAUNCHES_PER_REQUEST}),
            "pruned": dict(none, **{FP32_FORWARD: PRUNED_LAUNCHES}),
            "interactive_codecs": dict(none, **{DCONV_FORWARD: DCONV_LAUNCHES_PER_REQUEST})}
    got = {"json_generate": (json_launches, len(json_batches)),
           **{name: (g[0], len(g[1])) for name, g in gens.items()},
           "interactive_codecs": (codec_launches, len(per_batch))}
    launch_bad = {name: counts for name, (counts, n) in got.items()
                  if n == 0 or counts != {k: n * v for k, v in want[name].items()}}
    shard_h = {**gens["shard0"][3].get("H", {}), **gens["shard1"][3].get("H", {})}
    shards_equal = sorted(shard_h) == sorted(unsharded["H"]) and all(
        shard_h[i][1] == unsharded["H"][i][1] for i in shard_h)
    align_records = gens["align"][3]
    a_lines_ok = sorted(align_records.get("A", {})) == sorted(align_records["H"]) and all(
        len(align_records["A"][i][0].split()) == len(align_records["P"][i][0].split()) for i in align_records["H"])
    pruned_h = gens["pruned"][3].get("H", {})
    emit({"phase": "wiring_from_files_json", "utterances": JSON_SPLITS, "seconds": JSON_SECONDS,
          "corpus_write_s": corpus_s, "cli_wall_s": {k: v[2] for k, v in runs.items()},
          "updates": {k: len(v[0].updates) for k, v in runs.items()},
          "valid_batches": {k: len(v[0].valid_batches) for k, v in runs.items()},
          "resume_weights_bitwise": weights_equal, "resume_optimizer_bitwise": optimizer_equal,
          "checkpoint_files": sharded_files, "generate_batches": len(json_batches), "generate_wall_s": json_wall,
          "generate_h_lines": len(json_records.get("H", {})), "card": card})
    emit({"phase": "wiring_from_files_generate", "batches": {k: len(g[1]) for k, g in gens.items()},
          "wall_s": {k: g[2] for k, g in gens.items()}, "launches": {k: g[0] for k, g in gens.items()},
          "a_lines": len(align_records.get("A", {})), "a_lines_one_pair_a_token": a_lines_ok,
          "align_attn_card_vs_cpu_max_abs_err": attn_err, "atol": ALIGN_ATTN_ATOL,
          "align_pairs_held": pairs_held, "align_pairs_equal": pairs_equal, "margin": ALIGN_MARGIN,
          "shards_h_lines": [len(gens[k][3].get("H", {})) for k in ("shard0", "shard1")],
          "shards_equal_unsharded": shards_equal, "pruned_h_lines": len(pruned_h), "pruned_keep": PRUNE_KEEP,
          "card": card})
    emit({"phase": "wiring_from_files_tools", "round_trips": round_trips, "packages_found": found,
          "codecs": codecs, "sacrebleu_without_the_package": sacrebleu_checks,
          "interactive_codecs": {"lines": CODEC_LINES, "batches": len(per_batch),
                                 "h_lines": len(served.get("H", {})), "d_lines_the_cpu_decoding": d_equal},
          "user_dir": {"arch": user_arch[0], "updates": user_arch[1]},
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    if launch_bad:
        raise AssertionError(f"phase 31 launches off the prediction: {launch_bad}, expected {want} a batch")
    if not (weights_equal and optimizer_equal and all(len(runs[k][0].updates) == n for k, n in
                                                      (("stop", JSON_STOP), ("resume", JSON_END - JSON_STOP),
                                                       ("straight", JSON_END)))):
        raise AssertionError("the JSON route's sharded asynchronous resume is not bitwise the straight run: "
                             f"weights {weights_equal}, optimiser {optimizer_equal}")
    if not (len(json_records.get("H", {})) == JSON_SPLITS["valid"] and "checkpoint_last.pt" in sharded_files):
        raise AssertionError(f"cli/generate --dataset-from-json: {len(json_records.get('H', {}))} H- lines")
    if not (a_lines_ok and len(align_records["H"]) == FILES_TRAIN_SPLITS["valid"] and attn_err <= ALIGN_ATTN_ATOL
            and pairs_equal == pairs_held > 0):
        raise AssertionError(f"alignments: A- lines {a_lines_ok}, attention {attn_err} apart, "
                             f"{pairs_equal}/{pairs_held} pairs equal")
    if not (shards_equal and len(pruned_h) == FILES_TRAIN_SPLITS["valid"]):
        raise AssertionError(f"--num-shards: {shards_equal}; pruned: {len(pruned_h)} H- lines")
    if not all(r["bitwise"] for r in round_trips.values()):
        raise AssertionError(f"export + import round trips: {round_trips}")
    if not (len(served.get("H", {})) == CODEC_LINES and d_equal == CODEC_LINES):
        raise AssertionError(f"cli/interactive with codecs: {d_equal}/{CODEC_LINES} D- lines the CPU's decoding")
    if any(v != "raises ImportError naming sacrebleu" for v in sacrebleu_checks.values()):
        raise AssertionError(f"without sacrebleu: {sacrebleu_checks}")
    if user_arch != (USER_ARCH, 1):
        raise AssertionError(f"--user-dir: trained {user_arch}")
    return total


# ---------------------------------------------------------------------------
# 32. the fork's ASR side from files
# ---------------------------------------------------------------------------

ASR_ARGS = ["--task", "speech_recognition", "--dataset-from-json", "--input-feat-per-channel", str(N_MELS),
            *OPTIM_ARGS, "--no-epoch-checkpoints", "--no-save-optimizer-state"]
# leg: (arch, criterion, its extra flags, updates, the flash calls an update
# and a validation batch (each forward with its dq + dkv pair in bf16), the
# fp32 forwards of a cli/infer batch, the JSON corpus it reads)
ASR_LEGS = {
    # 12 encoder self-attentions + 6 causal decoder self-attentions + 6 cross-attentions, D 64 (512 / 8)
    "vggtransformer_base": ("vggtransformer_base", "cross_entropy_acc", [], 3, 12 + 6 + 6, 12, "tokens"),
    # 16 encoder self-attentions, D 64 (1024 / 16)
    "vggtransformer_enc_1": ("vggtransformer_enc_1", "ctc_loss", [], 2, 16, 16, "letters"),
    # no attention
    "w2l_conv_glu_enc": ("w2l_conv_glu_enc", "asg_loss", ["--max-replabel", "2", "--silence-token", "|"], 2, 0, 0,
                         "letters"),
}
# leg: [(route, its cli/infer flags, held exactly to the CPU's)]
ASR_ROUTES = {
    "vggtransformer_base": [("seq2seq_beam5", ["--beam", str(BEAM), "--max-len-b", str(MAX_LEN_B)], True)],
    "vggtransformer_enc_1": [("greedy", ["--ctc-decoding", "greedy"], True),
                             ("lexicon_arpa", ["--w2l-decoder", "kenlm", "--lexicon", "{lexicon}", "--kenlm-model",
                                               "{arpa}", "--ctc-beam-size", "8"], False)],
    "w2l_conv_glu_enc": [("asg_viterbi", ["--w2l-decoder", "viterbi"], False),
                         ("asg_beam_lexicon", ["--ctc-decoding", "beam", "--lexicon", "{lexicon}", "--kenlm-model",
                                               "{arpa}", "--ctc-beam-size", "8"], False)],
}
ASR_BEAM_HELD = 15  # of the 16 valid utterances: the host-side beams' card lines equal to the CPU's at least
LETTER_WORDS = 16  # each utterance's first tokens, spelled as the letters words of the letters corpus


def letters(token: str) -> str:
    """A token ``tok<i>`` as a word of two letters, the digits of i % 100
    (0 -> a, ..., 9 -> j)."""
    i = int(token[3:]) % 100
    return "abcdefghij"[i // 10] + "abcdefghij"[i % 10]


def write_letters_corpus(modules, json_dir, work):
    """Phase 31's WAVs with their labels spelled in letters: each of an
    utterance's first LETTER_WORDS tokens a word of ``letters``, its
    letters the units, "|" after each word; the dictionary of those units,
    each split's JSON by ``scripts/asr_prep_json``, a wav2letter lexicon of
    the corpus's words (one with the repeats packed into replabels, for
    ASG) and a 3-gram ARPA model of the train split's word sequences.
    Returns the directory and the seconds it took."""
    t0 = time.perf_counter()
    out = os.path.join(work, "letters")
    os.makedirs(out)
    d = modules["Dictionary"]()
    for u in "abcdefghij|":
        d.add_symbol(u)
    d.save(os.path.join(out, "dict.txt"))
    sentences = {}
    for split in JSON_SPLITS:
        with open(os.path.join(json_dir, f"{split}.labels"), encoding="utf-8") as f:
            rows = [line.split() for line in f if line.strip()]
        sentences[split] = [[letters(t) for t in toks[:LETTER_WORDS]] for _, *toks in rows]
        label_path = os.path.join(out, f"{split}.labels")
        with open(label_path, "w", encoding="utf-8") as f:
            for (utt, *_), words in zip(rows, sentences[split]):
                f.write(utt + " " + " ".join(" ".join(w) + " |" for w in words) + "\n")
        modules["asr_prep_json"].cli_main(["--audio-dirs", os.path.join(json_dir, "wav", split), "--labels",
                                           label_path, "--dictionary", os.path.join(out, "dict.txt"),
                                           "--output", os.path.join(out, f"{split}.json")])
    words = sorted({w for rows in sentences.values() for s in rows for w in s})
    with open(os.path.join(out, "lexicon.txt"), "w", encoding="utf-8") as f:
        f.writelines(f"{w}\t{' '.join(w)}\n" for w in words)
    with open(os.path.join(out, "lexicon_asg.txt"), "w", encoding="utf-8") as f:
        f.writelines(f"{w}\t{w[0]} {'1' if w[1] == w[0] else w[1]}\n" for w in words)
    write_arpa(os.path.join(out, "lm.arpa"), sentences["train"])
    return out, time.perf_counter() - t0


def write_arpa(path, sentences, backoff=-0.5):
    """A 3-gram ARPA model of ``sentences`` (lists of words, <s> and </s>
    around each): relative frequencies in log10, one back-off weight for
    every context that an n-gram extends."""
    import collections

    counts = [collections.Counter() for _ in range(3)]
    for s in sentences:
        seq = ["<s>", *s, "</s>"]
        for n in range(3):
            for i in range(len(seq) - n):
                counts[n][tuple(seq[i: i + n + 1])] += 1
    total = sum(c for g, c in counts[0].items() if g != ("<s>",))
    extended = {g[:-1] for n in (1, 2) for g in counts[n]}
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n" + "".join(f"ngram {n + 1}={len(counts[n])}\n" for n in range(3)))
        for n in range(3):
            f.write(f"\n\\{n + 1}-grams:\n")
            for gram, c in sorted(counts[n].items()):
                denom = total if n == 0 else counts[n - 1][gram[:-1]]
                logp = -99.0 if gram == ("<s>",) else math.log10(c / denom)
                bo = f"\t{backoff}" if n < 2 and gram in extended else ""
                f.write(f"{logp:.6f}\t{' '.join(gram)}{bo}\n")
        f.write("\n\\end\\\n")


def read_sclite(path):
    """{utterance id: sentence} of an sclite trn file."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            sentence, _, utt = line.rstrip("\n").rpartition(" (")
            out[int(utt.split("-")[0])] = sentence
    return out


def infer_counted(modules, counters, argv):
    """``cli/infer``'s ``cli_main(argv)``: ((WER, UER), its launches in all,
    the launches of each ``inference_step``, the wall seconds)."""
    fa, dconv, single = counters
    reset_counts(fa, dconv, single)
    per_batch, restore = counted_calls(modules["Task"], "inference_step", counters)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = modules["infer_cli"].cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    return scores, launch_counts(fa, dconv, single), per_batch, wall


def emission_gaps(modules, ckpt, argv, split="valid"):
    """Per utterance id of ``split``: the largest gap between the card's and
    the CPU's emissions (log-softmaxed for CTC, raw for ASG) over its
    frames, the models loaded from ``ckpt`` on each device, all of the
    split in one batch."""
    options, registry, checkpoint = modules["options"], modules["registry"], modules["checkpoint"]
    args = options.parse_args_and_arch(modules["infer_cli"].add_asr_eval_argument(
        options.get_generation_parser(default_task="speech_recognition")), argv)
    task = registry.TASKS[args.task].setup_task(args)
    task.load_dataset(split)
    ds = task.dataset(split)
    batch = ds.collater([ds[i] for i in range(len(ds))])
    out = {}
    for device in ("cuda", "cpu"):
        model = checkpoint.load_model_ensemble([ckpt], task=task, device=device)[0][0]
        with torch.no_grad():
            enc = model.encode(torch.as_tensor(batch["net_input"]["src_tokens"], device=device),
                               torch.as_tensor(batch["net_input"]["src_lengths"], device=device))
            logits = enc.ctc_out.float()
            if getattr(model, "asg_transitions", None) is None:
                logits = torch.log_softmax(logits, -1)
        out[device] = (logits.cpu().numpy(), enc.ctc_lengths.cpu().numpy())
        del model
    (card, lengths), (cpu, _) = out["cuda"], out["cpu"]
    return {int(i): float(np.abs(card[r, : lengths[r]] - cpu[r, : lengths[r]]).max())
            for r, i in enumerate(np.asarray(batch["id"]))}


def asr_from_files(card, d, fa, dconv, single, modules, tmp):
    """32. Main path 22, the fork's ASR side on the card, in phase 24's
    directory after phase 31, on phase 31's seeded JSON corpus (64 + 16
    WAVs of 409-509 frames):

      * (a) ``cli/train --task speech_recognition --dataset-from-json
        --arch vggtransformer_base --criterion cross_entropy_acc --bf16``
        for 3 updates on phase 31's dictionary (the fork's ASR recipe: 12
        x 512 encoder and 6 x 512 decoder layers, D 64), then ``cli/infer``
        in fp32 with beam 5 on the 16 valid utterances;
      * (b) ``vggtransformer_enc_1`` (16 x 1024/16/4096) with ``ctc_loss``
        for 2 updates, then ``cli/infer --ctc-decoding greedy`` and
        ``--w2l-decoder kenlm`` with a lexicon and a 3-gram ``.arpa`` over
        the corpus's words;
      * (c) ``w2l_conv_glu_enc`` (17 convs up to 1,816 channels) with
        ``asg_loss --max-replabel 2`` for 2 updates, then ``--w2l-decoder
        viterbi`` and the ASG beam with the lexicon.

    (b) and (c) read the corpus spelled in letters (``write_letters_corpus``):
    the host-side beams loop over the units of every frame. Each
    ``cli/infer`` runs again with ``--cpu`` on the same checkpoint: the
    seq2seq and greedy files equal the CPU's line for line; the LM and
    ASG beams' hypotheses equal at least ASR_BEAM_HELD of the 16, a
    differing line printed with the emission gap of its utterance. The
    launches of each update, validation batch and decode batch are held to
    ``ASR_LEGS``. Returns the launches of all of it."""
    import logging

    phase_t0 = time.perf_counter()
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "asr_from_files.log"))
    root.addHandler(handler)
    work = os.path.join(tmp, "asr")
    os.makedirs(work)
    counters = (fa, dconv, single)
    json_dir = os.path.join(tmp, "wiring", "json")
    letters_dir, letters_s = write_letters_corpus(modules, json_dir, work)
    corpora = {"tokens": json_dir, "letters": letters_dir}
    total = {k: 0 for k in launch_counts(fa, dconv, single)}
    none = dict(total)
    legs, bad = {}, []
    for leg, (arch, criterion, extra, updates, calls, infer_calls, corpus) in ASR_LEGS.items():
        data = corpora[corpus]
        save = os.path.join(work, leg)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, dconv, single)
        t0 = time.perf_counter()
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            data, *ASR_ARGS, "--arch", arch, "--criterion", criterion, *extra, "--max-update", str(updates),
            "--save-dir", save], calls=calls)
        train_wall = time.perf_counter() - t0
        for k, v in launch_counts(fa, dconv, single).items():
            total[k] += v
        n_params = sum(p.numel() for p in trainer.model.parameters())
        del trainer
        torch.cuda.empty_cache()
        train_peak = torch.cuda.max_memory_allocated() / 1e9
        ckpt = os.path.join(save, "checkpoint_last.pt")
        routes = {}
        for route, flags, exact in ASR_ROUTES[leg]:
            lexicon = os.path.join(letters_dir, "lexicon_asg.txt" if criterion == "asg_loss" else "lexicon.txt")
            argv = [data, "--task", "speech_recognition", "--dataset-from-json", "--criterion", criterion,
                    *extra, "--path", ckpt, "--gen-subset", "valid", "--max-sentences", str(JSON_SPLITS["valid"]),
                    *[a.format(lexicon=lexicon, arpa=os.path.join(letters_dir, "lm.arpa")) for a in flags]]
            card_res, cpu_res = os.path.join(work, f"{route}_card"), os.path.join(work, f"{route}_cpu")
            torch.cuda.reset_peak_memory_stats()
            scores, launches, per_batch, wall = infer_counted(modules, counters, [*argv, "--results-path", card_res])
            infer_peak = torch.cuda.max_memory_allocated() / 1e9
            for k, v in launches.items():
                total[k] += v
            t0 = time.perf_counter()
            cpu_scores = modules["infer_cli"].cli_main([*argv, "--results-path", cpu_res, "--cpu"])
            cpu_wall = time.perf_counter() - t0
            name = os.path.basename(ckpt)
            files = {p: (read_sclite(os.path.join(card_res, f"{p}-{name}-valid.txt")),
                         read_sclite(os.path.join(cpu_res, f"{p}-{name}-valid.txt")))
                     for p in ("hypo.units", "hypo.word", "ref.units")}
            card_h, cpu_h = files["hypo.units"]
            equal = sum(card_h[i] == cpu_h.get(i) for i in card_h)
            differing = {}
            if equal < len(card_h):
                gaps = emission_gaps(modules, ckpt, argv)
                for i in sorted(card_h):
                    if card_h[i] != cpu_h.get(i):
                        a, b = card_h[i].split(), cpu_h.get(i, "").split()
                        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                        differing[i] = {"card": card_h[i], "cpu": cpu_h.get(i), "first_difference_at": first,
                                        "emission_gap": gaps[i]}
            want = dict(none, **({FP32_FORWARD: infer_calls} if infer_calls else {}))
            launch_ok = bool(per_batch) and all(b == want for b in per_batch)
            routes[route] = {"batches": len(per_batch), "launches": {k: v for k, v in launches.items() if v},
                             "launches_as_predicted": launch_ok,
                             "wall_s": wall, "cpu_wall_s": cpu_wall, "wer_uer": scores, "cpu_wer_uer": cpu_scores,
                             "h_lines": len(card_h), "equal_to_cpu": equal, "held_exactly": exact,
                             "differing": differing, "refs_equal": files["ref.units"][0] == files["ref.units"][1],
                             "peak_gb": infer_peak}
            if not launch_ok:
                bad.append(f"{leg} {route}: launches {per_batch} a batch, expected {want}")
            if len(card_h) != JSON_SPLITS["valid"] or not routes[route]["refs_equal"]:
                bad.append(f"{leg} {route}: {len(card_h)} hypotheses, refs equal {routes[route]['refs_equal']}")
            elif exact and (equal != len(card_h) or files["hypo.word"][0] != files["hypo.word"][1]
                            or scores != cpu_scores):
                bad.append(f"{leg} {route}: {equal}/{len(card_h)} lines the CPU's, WER/UER {scores} {cpu_scores}")
            elif not exact and equal < ASR_BEAM_HELD:
                bad.append(f"{leg} {route}: {equal}/{len(card_h)} lines the CPU's: {differing}")
        legs[leg] = {"arch": arch, "criterion": criterion, "parameters": n_params, "corpus": corpus,
                     "updates": len(rec.updates),
                     "update_launches": {k: v for k, v in rec.updates[0].items() if v} if rec.updates else None,
                     "valid_batches": len(rec.valid_batches), "train_wall_s": train_wall, "train_peak_gb": train_peak,
                     "losses": [v for _, k, v in rec.logged if k == "loss"], "infer": routes}
        if len(rec.updates) != updates:
            bad.append(f"{leg}: {len(rec.updates)} updates, expected {updates}")
        emit({"phase": f"asr_from_files_{leg}", **legs[leg], "card": card})
    root.removeHandler(handler)
    handler.close()
    emit({"phase": "asr_from_files", "letters_corpus_s": letters_s, "phase_s": time.perf_counter() - phase_t0,
          "launches": total, "card": card})
    if bad:
        raise AssertionError("phase 32: " + "; ".join(bad))
    return total


# ---------------------------------------------------------------------------
# 33. multi-GPU: the ring's kernel route, cli/train through the launcher
# ---------------------------------------------------------------------------

RING_SHAPE = (32, 2048, 64)  # bh, T = S, D: the long-context step's call
RING_SIZES = (2, 4)
MULTI_UPDATES = 3
MULTI_ARGS = ["--dropout", "0", "--attention-dropout", "0", "--relu-dropout", "0", "--max-update",
              str(MULTI_UPDATES), "--max-epoch", "1"]
RTOL_MULTI_LOSS = RTOL_RESUME_LOSS  # bf16 steps, as phase 24's resume
RTOL_MULTI_RANKS = 1e-2  # bf16: two ranks sum their gradients in another order than one
MULTI_DEADLINE_S = 300  # a launcher run on its own (spawned ranks)
# the multi-rank legs' criterion: ctc_multi_loss with its model in eval mode
# (the conv front end's dropout has a floor of 0.1 that no flag lowers, and
# two ranks draw other bits than one process), registered by --user-dir
EVAL_CRITERION = """from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS

_TRAIN_MODE = CRITERIONS["ctc_multi_loss"]


class EvalModeCTCMultiLoss(_TRAIN_MODE):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


CRITERIONS["ctc_multi_loss"] = EvalModeCTCMultiLoss
"""


def ring_blocks(n, causal):
    """The blocks a ring of n shards computes: N^2, or N(N+1)/2 under a
    causal mask."""
    return n * (n + 1) // 2 if causal else n * n


def cuda_ms(fn, reps=3):
    """The mean of ``reps`` calls after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_ring_route(fa, dconv, single):
    """33a. The ring's per-block route in one process: N = 2 and 4 shards of
    the long-context call (bh 32, T = S = 2048, D 64; ragged key padding),
    each block one launch of the flash forward and of the dq + dkv pair of
    the type's route, the shards visiting in ring order
    (``ring_attention_shards``: the rotation an index, no collective). Out,
    lse and dq, dk, dv against the plain dense attention at phase 4's
    tolerances; the launches of each run exactly ``ring_blocks``; the ring's
    fwd + bwd time beside one flash call's at the same shape."""
    from fbk_fairseq_st_tpu_torch.ops import ring_attention as ring

    bh, t, dh = RING_SHAPE
    scale = dh ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(33)
    rows, bad = [], []
    for dtype in (torch.float32, torch.bfloat16):
        fwd_key = f"flash_fwd_{fa.fwd_route(dtype, dh)}"
        pair = fa.split_route(dtype, dh)
        q, k, v, bias = random_attention_inputs(gen, bh, t, t, dh, dtype)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        for causal in (False, True):
            want_out, want_lse = fa.flash_attention_reference(q, k, v, bias, scale, causal)
            want_grads = fa.flash_attention_backward_reference(q, k, v, bias, want_out, want_lse, g, scale, causal)

            def one_call():
                out, lse = fa._forward_cuda(q, k, v, bias, scale, causal, 0.0, 0)
                fa.flash_attention_backward(q, k, v, bias, out, lse, g, scale, causal)

            flash_ms = cuda_ms(one_call)
            for n in RING_SIZES:
                split = [list(x.chunk(n, dim=1)) for x in (q, k, v, bias, g)]
                reset_counts(fa, dconv, single)
                outs, lses = ring.ring_attention_shards(*split[:4], scale, causal)
                dqs, dks, dvs = ring.ring_attention_shards_backward(*split[:4], outs, lses, split[4], scale, causal)
                torch.cuda.synchronize()
                counts = launch_counts(fa, dconv, single)
                blocks = ring_blocks(n, causal)
                want_counts = {key: 0 for key in counts}
                want_counts.update({fwd_key: blocks, f"flash_bwd_dq_{pair}": blocks, f"flash_bwd_dkv_{pair}": blocks})
                out_err = (torch.cat(outs, 1).float() - want_out.float()).abs().max().item()
                lse_err = (torch.cat(lses, 1) - want_lse.float()).abs().max().item()
                gerr, gratio, _, gok = grad_errors([torch.cat(x, 1) for x in (dqs, dks, dvs)], want_grads, dtype)

                def ring_call():
                    o, l = ring.ring_attention_shards(*split[:4], scale, causal)
                    ring.ring_attention_shards_backward(*split[:4], o, l, split[4], scale, causal)

                row = {"n": n, "dtype": str(dtype).removeprefix("torch."), "causal": causal, "bh": bh, "T": t,
                       "D": dh, "blocks": blocks, "launches": {key: val for key, val in counts.items() if val},
                       "max_abs_err_out": out_err, "max_abs_err_lse": lse_err, "max_abs_err_grad": gerr,
                       "grad_err_over_max_plain": gratio, "ring_fwd_bwd_ms": cuda_ms(ring_call),
                       "one_flash_call_fwd_bwd_ms": flash_ms}
                rows.append(row)
                if counts != want_counts:
                    bad.append(f"ring n {n} {dtype} causal {causal}: launches {row['launches']}, expected "
                               f"{blocks} {fwd_key} and {pair} pairs")
                if not (out_err <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE and gok):
                    bad.append(f"ring n {n} {dtype} causal {causal}: out {out_err}, lse {lse_err}, grads {gerr} "
                               f"({gratio} of max|plain|)")
            del want_out, want_lse, want_grads
    return rows, bad


def launcher_run(argv, deadline=MULTI_DEADLINE_S):
    """``cli/train`` as a process of its own (the launcher spawns its
    ranks): the loss of each update from its JSON progress lines, and
    the run's seconds."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fbk_fairseq_st_tpu_torch.cli.train", *argv], cwd=here, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=deadline)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli/train {argv[-6:]} exited {proc.returncode}:\n{proc.stdout[-3000:]}")
    losses = []
    for line in proc.stdout.splitlines():
        if "train.progress" in line and line.rstrip().endswith("}"):
            record = json.loads(line.split(" | ")[-1])
            if "loss" in record and "num_updates" in record:
                losses.append(float(record["loss"]))
    return losses, wall


def rel_diff(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b)) if a and len(a) == len(b) else float("inf")


def multi_gpu(card, d, fa, dconv, single, modules, tmp):
    """33. Main path 23, multi-GPU training, in phase 24's directory on its
    corpus: (a) the ring's kernel route (``check_ring_route``); (b) the
    README's quick start at full width through the distributed launcher
    over NCCL, dropout 0, MULTI_UPDATES updates at world size
    ``torch.cuda.device_count()``: on one card the rank runs in this
    process (``cli/train.distributed_main``, so its launches are counted:
    phase 7's 20 + 20 + 20 a rank an update), its losses held to the plain
    ``cli/train``'s at RTOL_MULTI_LOSS; (c) the same run through the
    spawning launcher (a process of its own) with ``--fsdp``, then with
    ``--use-bmuf --global-sync-iter 2``: finite losses, FSDP's the plain
    run's. With two cards or more: (b) at world size 2 against the plain
    run at RTOL_MULTI_RANKS, tensor parallelism 2 with sequence
    parallelism, and ring attention at model-parallel size 2, each with
    the criterion's model in eval mode (``EVAL_CRITERION``) against the
    plain ``cli/train`` with it. Returns the launches of (b)."""
    import logging

    phase_t0 = time.perf_counter()
    train_cli, options = modules["train_cli"], modules["options"]
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(tmp, "multi_gpu.log"))
    root.addHandler(handler)
    work = os.path.join(tmp, "multi")
    os.makedirs(work)
    ring_rows, bad = check_ring_route(fa, dconv, single)
    emit({"phase": "multi_gpu_ring_route", "rows": ring_rows, "card": card})
    base = [os.path.join(tmp, "data"), *QUICK_START, *MULTI_ARGS]
    n = torch.cuda.device_count()

    plain_rec, plain = train_cli_run(modules, fa, dconv, single, [*base, "--save-dir", os.path.join(work, "plain"),
                                                                    "--no-save"])
    plain_losses = plain_rec.losses("train")
    plain_state = {k: v.detach().clone() for k, v in plain.model.state_dict().items()}
    del plain
    torch.cuda.empty_cache()

    save_b = os.path.join(work, "launcher")
    args = options.parse_args_and_arch(options.get_training_parser(), [
        *base, "--save-dir", save_b, "--distributed-world-size", "1", "--distributed-init-method",
        f"tcp://localhost:{train_cli._free_port()}"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, dconv, single)
    with _TrainRecorder(modules, fa, dconv, single) as rec:
        t0 = time.perf_counter()
        trainer, _ = train_cli.distributed_main(0, args, train_cli.Launch(args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(fa, dconv, single)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_update, want_valid = cli_train_launches(launches)
    if any(u != want_update for u in rec.updates) or any(v != want_valid for v in rec.valid_batches):
        bad.append(f"launcher rank: launches {rec.updates[:1]} an update, expected {want_update}")
    losses = rec.losses("train")
    state = trainer.model.state_dict()
    max_param_diff = max((state[k].float() - plain_state[k].float()).abs().max().item() for k in plain_state)
    bitwise = all(torch.equal(state[k], plain_state[k]) for k in plain_state)
    files = sorted(os.listdir(save_b))
    del trainer, state
    torch.cuda.empty_cache()
    if not (len(losses) == MULTI_UPDATES and rel_diff(losses, plain_losses) <= RTOL_MULTI_LOSS):
        bad.append(f"launcher losses {losses} against the plain run's {plain_losses}")
    if "checkpoint_last.pt" not in files:
        bad.append(f"the launcher's rank wrote {files}")

    legs = {}
    spawn = [*base, "--no-save", "--distributed-world-size", str(n)]
    for leg, extra in (("fsdp", ["--fsdp"]), ("bmuf", ["--use-bmuf", "--global-sync-iter", "2"])):
        leg_losses, leg_wall = launcher_run([*spawn, "--save-dir", os.path.join(work, leg), *extra])
        legs[leg] = {"world_size": n, "losses": leg_losses, "wall_s": leg_wall,
                     "max_rel_diff_to_plain": rel_diff(leg_losses, plain_losses)}
        # one progress line an update: only the first rank prints them
        if not (len(leg_losses) == MULTI_UPDATES and np.isfinite(leg_losses).all()):
            bad.append(f"{leg}: losses {leg_losses}")
    if n == 1 and legs["fsdp"]["max_rel_diff_to_plain"] > RTOL_MULTI_LOSS:
        bad.append(f"fsdp losses {legs['fsdp']['losses']} against the plain run's {plain_losses}")
    if n >= 2:
        # the criterion in eval mode on both sides of each comparison
        user_dir = os.path.join(work, "fbk_eval_ctc_multi_loss")
        os.makedirs(user_dir)
        with open(os.path.join(user_dir, "__init__.py"), "w") as f:
            f.write(EVAL_CRITERION)
        criterions = sys.modules["fbk_fairseq_st_tpu_torch.criterions"]
        train_mode = criterions.CRITERIONS["ctc_multi_loss"]
        try:
            eval_rec, eval_trainer = train_cli_run(modules, fa, dconv, single, [
                *base, "--no-save", "--save-dir", os.path.join(work, "plain_eval"), "--user-dir", user_dir])
        finally:
            criterions.CRITERIONS["ctc_multi_loss"] = train_mode
        del eval_trainer
        eval_losses = eval_rec.losses("train")
        for leg, extra in (("ws2", []), ("tp2_sp", ["--model-parallel-size", "2", "--sequence-parallel"]),
                           ("tp2_ring", ["--model-parallel-size", "2", "--ring-attention"])):
            leg_losses, leg_wall = launcher_run([*base, "--no-save", "--distributed-world-size", "2",
                                                 "--save-dir", os.path.join(work, leg), "--user-dir", user_dir, *extra])
            legs[leg] = {"world_size": 2, "losses": leg_losses, "plain_eval_losses": eval_losses, "wall_s": leg_wall,
                         "max_rel_diff_to_plain": rel_diff(leg_losses, eval_losses)}
            if legs[leg]["max_rel_diff_to_plain"] > RTOL_MULTI_RANKS:
                bad.append(f"{leg}: losses {leg_losses} against the plain eval-mode run's {eval_losses}")
    root.removeHandler(handler)
    handler.close()
    emit({"phase": "multi_gpu", "world_sizes_run": sorted({1, n} | {legs[leg]["world_size"] for leg in legs}),
          "multi_rank_legs": "run" if n >= 2 else f"not run: {n} CUDA device (they need a second one)",
          "nccl_version": ".".join(map(str, torch.cuda.nccl.version())), "backend": "nccl", "updates": MULTI_UPDATES,
          "plain_losses": plain_losses, "launcher_losses": losses,
          "max_rel_loss_diff": rel_diff(losses, plain_losses), "rtol": RTOL_MULTI_LOSS,
          "max_abs_param_diff": max_param_diff, "bitwise_equal_to_plain": bitwise, "checkpoint_files": files,
          "launcher_wall_s": wall, "peak_gb_a_rank": peak_gb, "launches_per_update_a_rank": want_update,
          "launches": launches, "legs": legs, "phase_s": time.perf_counter() - phase_t0, "card": card})
    if bad:
        raise AssertionError("phase 33: " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 34. the text transformer family from files
# ---------------------------------------------------------------------------

TEXT_VOCAB = 32768  # the WMT big model's joined dictionary (a 32 k joined BPE)
TEXT_LEN = (10, 60)  # tokens a sentence
TEXT_SPLITS = {"train": 400, "valid": 64, "test": 64}  # sentence pairs
ZIPF_A = 1.1  # the corpora's token ids: a Zipf law over the dictionary
TT_ARCH = "transformer_vaswani_wmt_en_de_big"
TT_ALIGN_ARCH = "transformer_wmt_en_de_big_align"
TT_UPDATES, TT_ALIGN_UPDATES = 3, 2
TT_CALLS = 18  # a step: 6 encoder self-attention, 6 causal decoder self-attention, 6 cross-attention
TT_ALIGN_LAYER = 4  # the align presets' --alignment-layer
# + the alignment pass over decoder layers 0-4: 5 self-attentions, 4
# cross-attentions (the 5th returns its weights: the dense route)
TT_ALIGN_CALLS = TT_CALLS + 2 * (TT_ALIGN_LAYER + 1) - 1
TT_SERVE_BATCH = 32  # sentences a cli/generate batch
TT_GEN_LAUNCHES = 6  # a batch: the encoder's (the cached decoder steps take the dense route)
TT_SCORE_LAUNCHES = TT_CALLS  # --score-reference: one teacher-forced fp32 forward a batch
TT_MAX_LEN_B = 30
TT_ARGS = ["--task", "translation", "-s", "en", "-t", "de", "--share-all-embeddings",
           "--label-smoothing", "0.1", "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "0.0005",
           "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4000", "--clip-norm", "0", "--max-tokens", "3584",
           "--bf16", "--log-format", "json", "--log-interval", "1", "--no-epoch-checkpoints",
           "--no-save-optimizer-state"]
LM_VOCAB = 267744  # wiki103's dictionary
LM_ARCH, GBW_ARCH = "transformer_lm_wiki103", "transformer_lm_gbw"
LM_TPS, LM_CONTEXT = 3072, 2560
GBW_TPS = LM_TPS - LM_CONTEXT  # the test split: one window of 512 tokens
LM_TOKENS = {"train": 32 * LM_TPS, "valid": 2048, "test": GBW_TPS}  # 32 blocks; 4 windows; one window
LM_UPDATES = 3
LM_CALLS = 16  # the 16 layers' causal self-attention at D 128
GBW_CALLS = 12  # the 12 layers' at D 32
LM_ARGS = ["--task", "language_modeling", "--criterion", "adaptive_loss", "--tokens-per-sample", str(LM_TPS),
           "--max-tokens", str(LM_TPS), "--sample-break-mode", "none", "--optimizer", "adam", "--adam-betas",
           "(0.9, 0.98)", "--lr", "0.0005", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4000",
           "--clip-norm", "0", "--bf16", "--log-format", "json", "--log-interval", "1", "--no-epoch-checkpoints",
           "--no-save-optimizer-state"]
# model flags appended to each leg's runs (empty on the card: full width)
TT_SMALL_ARGS, LM_SMALL_ARGS, GBW_SMALL_ARGS = [], [], []
LM_SCORER_ATOL = 1e-4  # eval_lm's loss (base 2) against the in-memory SequenceScorer on the card
LM_CPU_ATOL = 1e-3  # the card's eval_lm against --cpu
WIKI103_CALL = (8, 3072, 3072, 128)  # bh, T = S, D: the wiki103 step's causal self-attention
# its fp32 dq, dk, dv: each a sum of up to 3072 products in 3xTF32 (about
# 2^-21 of |a||b| each), against max|plain| ~ 4: of max|plain|, as bf16's
RTOL_GRAD_FP32_LONG = 1e-4


def zipf_ids(rng, n, vocab):
    """n token ids in [4, vocab) by a Zipf law (rank 1 the most frequent)."""
    return 4 + (rng.zipf(ZIPF_A, size=n) - 1) % (vocab - 4)


def write_dictionary_file(path, vocab):
    """A dictionary file of vocab - 4 words (the 4 specials come first on
    load), counts falling with the rank."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(4, vocab):
            f.write(f"w{i} {vocab - i}\n")


def write_lines(path, rng, n, lens, vocab):
    """n lines of ``lens`` Zipf words; returns their lengths."""
    sizes = rng.randint(lens[0], lens[1] + 1, size=n)
    with open(path, "w", encoding="utf-8") as f:
        for size in sizes:
            f.write(" ".join(f"w{i}" for i in zipf_ids(rng, int(size), vocab)) + "\n")
    return sizes


def write_text_corpora(modules, work, rng):
    """The two corpora, written as raw text and binarized by the port's
    ``cli/preprocess``: (a) TEXT_SPLITS sentence pairs over a joined
    TEXT_VOCAB dictionary with Pharaoh alignments (each target word linked
    to one source word) -> ``<work>/mt``; (b) a monolingual stream of
    LM_TOKENS tokens over an LM_VOCAB dictionary -> ``<work>/lm``."""
    raw = os.path.join(work, "raw")
    os.makedirs(raw)
    mt_dict, lm_dict = os.path.join(raw, "dict.mt.txt"), os.path.join(raw, "dict.lm.txt")
    write_dictionary_file(mt_dict, TEXT_VOCAB)
    write_dictionary_file(lm_dict, LM_VOCAB)
    for split, n in TEXT_SPLITS.items():
        src = write_lines(os.path.join(raw, f"{split}.en"), rng, n, (TEXT_LEN[0] - 1, TEXT_LEN[1] - 1), TEXT_VOCAB)
        tgt = write_lines(os.path.join(raw, f"{split}.de"), rng, n, (TEXT_LEN[0] - 1, TEXT_LEN[1] - 1), TEXT_VOCAB)
        with open(os.path.join(raw, f"{split}.align"), "w") as f:
            for ls, lt in zip(src, tgt):
                f.write(" ".join(f"{rng.randint(ls)}-{j}" for j in range(lt)) + "\n")
    for split, tokens in LM_TOKENS.items():
        with open(os.path.join(raw, f"lm.{split}"), "w", encoding="utf-8") as f:
            left = tokens
            while left > 0:  # lines of TEXT_LEN tokens, each ending in eos once binarized
                size = min(left, rng.randint(*TEXT_LEN))
                f.write(" ".join(f"w{i}" for i in zipf_ids(rng, size - 1, LM_VOCAB)) + "\n")
                left -= size
    pre = modules["preprocess_cli"].cli_main
    mt, lm = os.path.join(work, "mt"), os.path.join(work, "lm")
    pre(["-s", "en", "-t", "de", "--trainpref", os.path.join(raw, "train"), "--validpref", os.path.join(raw, "valid"),
         "--testpref", os.path.join(raw, "test"), "--destdir", mt, "--srcdict", mt_dict, "--tgtdict", mt_dict,
         "--align-suffix", "align"])
    pre(["--only-source", "--trainpref", os.path.join(raw, "lm.train"), "--validpref", os.path.join(raw, "lm.valid"),
         "--testpref", os.path.join(raw, "lm.test"), "--destdir", lm, "--srcdict", lm_dict])
    return mt, lm


def first_train_batch(modules, trainer):
    task = trainer.task
    return next(iter(modules["checkpoint"].get_train_iterator(trainer.args, trainer, task, epoch=0)
                     .next_epoch_itr(shuffle=True)))


def profiled(fn):
    """One profiled run of ``fn``: wall seconds, device busy ms, idle share."""
    wall_s, busy_s, top, classes = profile_window(fn)
    return {"wall_s": wall_s, "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
            "busy_by_class_s": classes, "top_kernels_s": top[:5]}


def eval_lm_run(modules, counters, argv):
    """``cli/eval_lm``'s ``cli_main``: (loss in base 2, tokens, its standard
    output, the launches of each scored batch)."""
    import contextlib
    import io

    fa, dconv, single = counters
    reset_counts(fa, dconv, single)
    per_batch, restore = counted_calls(modules["SequenceScorer"], "generate", counters)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            loss, tokens = modules["eval_lm_cli"].cli_main(argv)
    finally:
        restore()
    return loss, tokens, out.getvalue(), per_batch


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def only(counts, name, n):
    """``counts`` with ``n`` launches of ``name`` and none of any other kernel."""
    return {k: (n if k == name else 0) for k in counts}


def time_wiki103_call(fa):
    """The wiki103 step's causal self-attention (WIKI103_CALL) as phase 4
    times a call: each type's forward and split pair against their plain
    versions (bf16 at the step's rate 0.1, fp32 at rate 0 as eval_lm calls
    it), the wrapper's time, the median device launch, the bound and SDPA's
    fused-backend device time, forward and backward."""
    bh, t, s, d = WIKI103_CALL
    rows = []
    for dtype, rate in ((torch.bfloat16, 0.1), (torch.float32, 0.0)):
        gen = torch.Generator(device="cuda").manual_seed(34)
        q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype, padded=False)
        g = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
        scale, seed = d ** -0.5, 34
        route, pair_route = fa.fwd_route(dtype, d), fa.split_route(dtype, d)

        def fwd():
            return fa.flash_attention(q, k, v, bias, scale, causal=True, return_lse=True, dropout_rate=rate,
                                      dropout_seed=seed)

        out, lse = fwd()
        out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, True, rate, seed)
        fwd_err = (out.float() - out_p.float()).abs().max().item()
        lse_err = (lse - lse_p).abs().max().item()

        def pair():
            return fa.backward_pair(pair_route, q, k, v, bias, out, lse, g, scale, True, rate, seed)

        err, ratio, tops, grads_ok = grad_errors(pair(), fa.flash_attention_backward_reference(
            q, k, v, bias, out, lse, g, scale, True, rate, seed), dtype)
        if dtype == torch.float32:
            grads_ok = ratio <= RTOL_GRAD_FP32_LONG
        del out_p, lse_p
        torch.cuda.empty_cache()
        lib_fwd = library_device_ms(q, k, v, bias, scale, True)
        lib_bwd = library_device_ms(q, k, v, bias, scale, True, grad=g)
        base = {"phase": "wiki103_call", "bh": bh, "T": t, "S": s, "D": d, "causal": True, "rate": rate,
                "dtype": str(dtype).replace("torch.", ""), "card": CARD[0]}
        fwd_bound = attention_bound_ms(bh, t, s, d, True, dtype)
        suffix = "_tc128" if dtype == torch.bfloat16 else "_tf32x3_128"
        row = {**base, "kernel": "flash_attention_fwd" + suffix, "kernel_ms": time_ms(fwd),
               "kernel_device_ms": device_ms(fwd, FWD_KERNEL_NAMES[route]), "bound_ms": fwd_bound[0],
               "bound_by": fwd_bound[1], "library_device_ms": lib_fwd[0], "library_device_backend": lib_fwd[1],
               "max_abs_err": fwd_err, "lse_max_abs_err": lse_err, "atol": ATOL_KERNEL[dtype]}
        emit(row)
        rows.append(row)
        pair_ms = time_ms(pair)
        for kind, match in zip(("dq", "dkv"), BWD_KERNEL_NAMES[pair_route]):
            bound = backward_bound_ms(kind, bh, t, s, d, True, dtype)
            row = {**base, "kernel": f"flash_attention_bwd_{kind}{suffix}", "pair_ms": pair_ms,
                   "kernel_device_ms": device_ms(pair, match), "bound_ms": bound[0], "bound_by": bound[1],
                   "library_device_ms": lib_bwd[0], "library_device_backend": lib_bwd[1],
                   "library_device": "sdpa backward alone, rate 0", "max_abs_err": err,
                   "max_err_over_max_plain": ratio}
            emit(row)
            rows.append(row)
        if not (fwd_err <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE and grads_ok):
            raise AssertionError(f"the wiki103 call in {dtype}: forward {fwd_err} / lse {lse_err}, "
                                 f"gradients {err} ({ratio} of max|plain|)")
        del q, k, v, bias, g, out, lse
        torch.cuda.empty_cache()
    return rows


def text_transformer_from_files(card, d, fa, dconv, single, modules, tmp):
    """Main path 34, the text transformer family trained and served from
    files on the card, on corpora binarized by the port's ``cli/preprocess``
    (``write_text_corpora``).

    (a) ``transformer_vaswani_wmt_en_de_big`` at full width (1024/4096, 16
    heads, 6 + 6 post-norm layers, ``--share-all-embeddings`` over a joined
    32,768-symbol dictionary) trained through ``cli/train`` in bf16 for
    TT_UPDATES updates, each exactly TT_CALLS ``flash_fwd_tc`` +
    ``flash_bwd_dq_tc`` + ``flash_bwd_dkv_tc`` launches (D 64); decoded by
    ``cli/generate`` in fp32 (beam 5, TT_SERVE_BATCH sentences a batch, each
    batch TT_GEN_LAUNCHES ``flash_fwd_tf32x3``), its H- lines equal to the
    in-memory generator's; ``--score-reference`` (TT_SCORE_LAUNCHES a
    batch); then ``transformer_wmt_en_de_big_align`` with
    ``--load-alignments`` for TT_ALIGN_UPDATES updates (TT_ALIGN_CALLS of
    each kernel an update: the alignment pass's cross-attention that returns
    its weights takes the dense route).

    (b) ``transformer_lm_wiki103`` at full width (16 layers, 1024/4096, 8
    heads: D 128; adaptive input and softmax tied, cutoffs 20000,60000 over
    a 267,744-symbol dictionary) trained through ``cli/train`` with
    ``adaptive_loss`` on 3072-token blocks in bf16 for LM_UPDATES updates,
    each exactly LM_CALLS ``flash_fwd_tc128`` + ``flash_bwd_dq_tc128`` +
    ``flash_bwd_dkv_tc128``; the tied input and output tables stay one
    storage; ``cli/eval_lm --context-window 2560`` in fp32 (LM_CALLS
    ``flash_fwd_tf32x3_128`` a window), its loss within LM_SCORER_ATOL of
    the in-memory ``SequenceScorer`` and, on one 512-token window, within
    LM_CPU_ATOL of ``--cpu``.

    (c) ``transformer_lm_gbw --character-embeddings`` at full width
    (512/4096, 16 heads: D 32; 12 layers) with seeded weights, one
    ``cli/eval_lm`` batch on (b)'s test window: GBW_CALLS
    ``flash_fwd_tf32x3``, card against ``--cpu`` within LM_CPU_ATOL. Its
    dictionary is (b)'s 267,744 symbols, not gbw's 793,471.

    Each leg reports its update or batch seconds, device busy ms and idle
    share from one profiled update or batch, and its peak GB; the wiki103
    call is timed as phase 4 times a call (``time_wiki103_call``)."""
    import logging

    phase_t0 = time.perf_counter()
    counters = (fa, dconv, single)
    train_cli, options, registry, ckpt = (modules["train_cli"], modules["options"], modules["registry"],
                                          modules["checkpoint"])
    work = os.path.join(tmp, "text")
    os.makedirs(work)
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(work, "text.log"))
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        mt_dir, lm_dir = write_text_corpora(modules, work, np.random.RandomState(34))
        corpus_s = time.perf_counter() - t0
        mt_dict = modules["Dictionary"].load(os.path.join(mt_dir, "dict.en.txt"))
        lm_dict = modules["Dictionary"].load(os.path.join(lm_dir, "dict.txt"))
        if (len(mt_dict), len(lm_dict)) != (TEXT_VOCAB, LM_VOCAB):
            raise AssertionError(f"dictionaries of {len(mt_dict)} and {len(lm_dict)} symbols")
        report = {"phase": "text_transformer_from_files", "corpus_s": corpus_s, "card": card}
        total = {}  # the main path's launches: the CLI runs, not the in-memory checks beside them
        leg_t0 = [time.perf_counter()]

        def leg(name, fields):
            """One leg's line, printed when it is done (its launch dicts
            without the kernels it never launched)."""
            fields = {k: ({kk: vv for kk, vv in v.items() if vv} if k.startswith("launches") else v)
                      for k, v in fields.items()}
            report[name] = {**fields, "seconds": time.perf_counter() - leg_t0[0]}
            emit({"phase": f"text_transformer_from_files.{name}", **report[name], "card": card})
            leg_t0[0] = time.perf_counter()

        # (a) the WMT big model: train, decode, score, align
        save = os.path.join(work, "wmt")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, dconv, single)
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            mt_dir, *TT_ARGS, "--arch", TT_ARCH, "--criterion", "label_smoothed_cross_entropy", "--max-update",
            str(TT_UPDATES), "--save-dir", save, *TT_SMALL_ARGS], calls=TT_CALLS)
        add_counts(total, launch_counts(fa, dconv, single))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if len(rec.updates) != TT_UPDATES:
            raise AssertionError(f"{TT_ARCH}: {len(rec.updates)} updates")
        step_s, wall_s, busy_s, _, classes = in_memory_update(trainer, first_train_batch(modules, trainer))
        leg("wmt_train", {"updates": len(rec.updates), "valid_batches": len(rec.valid_batches),
                               "launches_an_update": rec.updates[0], "losses": rec.losses("train"),
                               "update_s_median": step_s, "profiled_update_s": wall_s,
                               "device_busy_ms": busy_s * 1e3, "device_idle_share": 1.0 - busy_s / wall_s,
                               "busy_by_class_s": classes, "peak_gb": peak})
        del trainer
        torch.cuda.empty_cache()
        last = os.path.join(save, "checkpoint_last.pt")
        results = os.path.join(work, "results")
        gen_argv = [mt_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", last, "--beam", str(BEAM),
                    "--max-sentences", str(TT_SERVE_BATCH), "--max-len-b", str(TT_MAX_LEN_B), "--gen-subset",
                    "test", "--results-path", results]
        torch.cuda.reset_peak_memory_stats()
        gen_launches, per_batch, gen_wall = generate_counted(modules, counters, gen_argv)
        add_counts(total, gen_launches)
        gen_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hyps, _ = read_records(os.path.join(results, "generate-test.txt"))
        args = options.parse_args_and_arch(options.get_generation_parser(), gen_argv)
        task = registry.TASKS["translation"].setup_task(args)
        task.load_dataset("test")
        batches = list(task.get_batch_iterator(
            task.dataset("test"), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
            max_positions=task.max_positions(),
            required_batch_size_multiple=args.required_batch_size_multiple).next_epoch_itr(shuffle=False))
        models, _ = ckpt.load_model_ensemble([last], task=task)
        tgt = task.target_dictionary
        generator = modules["SequenceGenerator"](tgt, beam_size=BEAM, max_len_b=TT_MAX_LEN_B)
        same, worst, n = 0, 0.0, 0
        with torch.no_grad():
            for sample in batches:
                for sid, sent in zip(sample["id"], generator.generate(models, sample)):
                    score, text = hyps[int(sid)]
                    same += text == tgt.string(sent[0]["tokens"])
                    worst = max(worst, abs(score - sent[0]["score"] / math.log(2)))
                    n += 1
            gen_profile = profiled(lambda: generator.generate(models, batches[0]))
        del models
        torch.cuda.empty_cache()
        want_gen = only(gen_launches, FP32_FORWARD, TT_GEN_LAUNCHES)
        leg("wmt_generate", {"batches": len(per_batch), "launches_a_batch": per_batch[0], "wall_s": gen_wall,
                                  "identical_hypotheses": f"{same}/{n}", "max_abs_score_diff_base2": worst,
                                  "profiled_batch": gen_profile, "peak_gb": gen_peak})
        if any(b != want_gen for b in per_batch) or not per_batch:
            raise AssertionError(f"cli/generate launches {per_batch} a batch, expected {want_gen}")
        if not (n == len(hyps) == TEXT_SPLITS["test"] and same == n and worst <= FILES_SCORE_ATOL):
            raise AssertionError(f"cli/generate's H- lines against the in-memory generator: {same}/{n} identical, "
                                 f"scores {worst} apart")
        score_launches, score_batches, _ = generate_counted(modules, counters, gen_argv + ["--score-reference"])
        add_counts(total, score_launches)
        want_score = only(score_launches, FP32_FORWARD, TT_SCORE_LAUNCHES)
        leg("wmt_score_reference", {"batches": len(score_batches), "launches_a_batch": score_batches[0]})
        if any(b != want_score for b in score_batches) or not score_batches:
            raise AssertionError(f"--score-reference launches {score_batches}, expected {want_score} a batch")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, dconv, single)
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            mt_dir, *TT_ARGS, "--arch", TT_ALIGN_ARCH, "--load-alignments", "--criterion",
            "label_smoothed_cross_entropy_with_alignment", "--max-update", str(TT_ALIGN_UPDATES), "--no-save",
            *TT_SMALL_ARGS], calls=TT_ALIGN_CALLS)
        add_counts(total, launch_counts(fa, dconv, single))
        align_losses = [v for t, key, v in rec.logged if t == "train" and key == "loss"]
        leg("wmt_align_train", {"updates": len(rec.updates), "launches_an_update": rec.updates[0],
                                     "losses": align_losses, "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        if len(rec.updates) != TT_ALIGN_UPDATES:
            raise AssertionError(f"{TT_ALIGN_ARCH}: {len(rec.updates)} updates")
        del trainer
        torch.cuda.empty_cache()

        # (b) the wiki103 language model: train, then eval_lm with context
        save = os.path.join(work, "wiki103")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, dconv, single)
        rec, trainer = train_cli_run(modules, fa, dconv, single, [
            lm_dir, *LM_ARGS, "--arch", LM_ARCH, "--max-update", str(LM_UPDATES), "--save-dir", save,
            *LM_SMALL_ARGS], calls=LM_CALLS, route=D128_BACKWARD, forward=D128_FORWARD)
        add_counts(total, launch_counts(fa, dconv, single))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dec = trainer.model.decoder
        tied = [(dec.adaptive_softmax.head.word_proj.weight, dec.embed_tokens.embeddings[0][0].weight)] + [
            (dec.adaptive_softmax.tail[i][2].weight, dec.embed_tokens.embeddings[i + 1][0].weight)
            for i in range(len(dec.adaptive_softmax.tail))] + [
            (dec.adaptive_softmax.tail[i][0].weight, dec.embed_tokens.embeddings[i + 1][1].weight)
            for i in range(len(dec.adaptive_softmax.tail))]
        one_storage = all(a is b and a.data_ptr() == b.data_ptr() for a, b in tied)
        losses = rec.losses("train")
        step_s, wall_s, busy_s, _, classes = in_memory_update(trainer, first_train_batch(modules, trainer))
        leg("wiki103_train", {"updates": len(rec.updates), "valid_batches": len(rec.valid_batches),
                                   "launches_an_update": rec.updates[0], "losses": losses,
                                   "tied_tables_one_storage": one_storage, "update_s_median": step_s,
                                   "profiled_update_s": wall_s, "device_busy_ms": busy_s * 1e3,
                                   "device_idle_share": 1.0 - busy_s / wall_s, "busy_by_class_s": classes,
                                   "peak_gb": peak})
        if not (len(rec.updates) == LM_UPDATES and one_storage and np.isfinite(losses).all()):
            raise AssertionError(f"{LM_ARCH}: {len(rec.updates)} updates, losses {losses}, tied tables one "
                                 f"storage: {one_storage}")
        del trainer, dec, tied
        torch.cuda.empty_cache()
        last = os.path.join(save, "checkpoint_last.pt")
        eval_argv = [lm_dir, "--path", last, "--tokens-per-sample", str(LM_TPS), "--context-window",
                     str(LM_CONTEXT), "--max-sentences", "1"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, tokens, _, per_batch = eval_lm_run(modules, counters, eval_argv + ["--gen-subset", "valid"])
        add_counts(total, launch_counts(fa, dconv, single))
        eval_wall = time.perf_counter() - t0
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want_eval = only(per_batch[0], FP32_D128_FORWARD, LM_CALLS)
        # the in-memory scorer over the same windows
        args = options.parse_args_and_arch(options.get_eval_lm_parser(), eval_argv + ["--gen-subset", "valid"])
        args.tokens_per_sample -= LM_CONTEXT
        task = registry.TASKS["language_modeling"].setup_task(args)
        task.load_dataset("valid")
        ds = modules["LMContextWindowDataset"](task.dataset("valid"), args.tokens_per_sample, LM_CONTEXT,
                                               task.target_dictionary.pad())
        models, _ = ckpt.load_model_ensemble([last], task=task)
        scorer = modules["SequenceScorer"](task.target_dictionary)
        nll, count, samples = 0.0, 0, []
        for sample in task.get_batch_iterator(
                ds, max_tokens=args.max_tokens, max_sentences=args.max_sentences, max_positions=task.max_positions(),
                ignore_invalid_inputs=True,
                required_batch_size_multiple=args.required_batch_size_multiple).next_epoch_itr(shuffle=False):
            for hypo in scorer.generate(models, sample):
                nll -= float(np.sum(hypo[0]["positional_scores"], dtype=np.float64))
                count += len(hypo[0]["tokens"])
            samples.append(sample)
        mem_loss = nll / count / math.log(2)
        eval_profile = profiled(lambda: scorer.generate(models, samples[-1]))
        # the test window on the card (the scorer, as the CLI above) and by cli/eval_lm --cpu
        task.load_dataset("test")
        test = modules["LMContextWindowDataset"](task.dataset("test"), args.tokens_per_sample, LM_CONTEXT,
                                                 task.target_dictionary.pad())
        test_hypos = [h[0] for sample in task.get_batch_iterator(
            test, max_sentences=1, max_positions=task.max_positions()).next_epoch_itr(shuffle=False)
            for h in scorer.generate(models, sample)]
        card_test = (-sum(float(np.sum(h["positional_scores"], dtype=np.float64)) for h in test_hypos)
                     / sum(len(h["tokens"]) for h in test_hypos) / math.log(2), sum(len(h["tokens"]) for h in test_hypos))
        del models
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu_test = eval_lm_run(modules, counters, eval_argv + ["--gen-subset", "test", "--cpu"])
        cpu_s = time.perf_counter() - t0
        leg("wiki103_eval_lm", {"windows": len(per_batch), "tokens": tokens, "loss_base2": loss,
                                     "in_memory_scorer_loss": mem_loss, "launches_a_window": per_batch[0],
                                     "wall_s": eval_wall, "profiled_window": eval_profile, "peak_gb": eval_peak,
                                     "test_window_card_cpu": [card_test[0], cpu_test[0]], "cpu_s": cpu_s})
        if any(b != want_eval for b in per_batch) or not per_batch or tokens != count:
            raise AssertionError(f"eval_lm launches {per_batch[:2]} a window, expected {want_eval}")
        if not (abs(loss - mem_loss) <= LM_SCORER_ATOL and abs(card_test[0] - cpu_test[0]) <= LM_CPU_ATOL
                and card_test[1] == cpu_test[1] == LM_TOKENS["test"]):
            raise AssertionError(f"eval_lm {loss} against the scorer's {mem_loss}; test window card {card_test[:2]}"
                                 f" against the CPU's {cpu_test[:2]}")

        # (c) the gbw preset with character embeddings: one eval_lm batch
        gbw_argv = [lm_dir, "--task", "language_modeling", "--arch", GBW_ARCH, "--character-embeddings",
                    "--tokens-per-sample", str(GBW_TPS), "--criterion", "adaptive_loss", *GBW_SMALL_ARGS]
        args = options.parse_args_and_arch(options.get_training_parser(), gbw_argv)
        task = registry.TASKS["language_modeling"].setup_task(args)
        model = task.build_model(args).eval()
        gbw_path = os.path.join(work, "gbw.pt")
        modules["save_model_checkpoint"](gbw_path, args, model)
        task.load_dataset("test")
        sample = next(iter(task.get_batch_iterator(task.dataset("test"), max_tokens=36000,
                                                   max_positions=task.max_positions()).next_epoch_itr(shuffle=False)))
        gbw_profile = profiled(lambda: modules["SequenceScorer"](task.target_dictionary).generate([model], sample))
        del model
        torch.cuda.empty_cache()
        gbw_eval = [lm_dir, "--path", gbw_path, "--tokens-per-sample", str(GBW_TPS), "--gen-subset", "test"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gbw_card = eval_lm_run(modules, counters, gbw_eval)
        add_counts(total, launch_counts(fa, dconv, single))
        gbw_wall = time.perf_counter() - t0
        gbw_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gbw_cpu = eval_lm_run(modules, counters, gbw_eval + ["--cpu"])
        want_gbw = only(gbw_card[3][0], FP32_FORWARD, GBW_CALLS)
        leg("gbw_eval_lm", {"batches": len(gbw_card[3]), "launches_a_batch": gbw_card[3][0],
                                 "loss_card_cpu": [gbw_card[0], gbw_cpu[0]], "wall_s": gbw_wall,
                                 "profiled_batch": gbw_profile, "peak_gb": gbw_peak})
        if gbw_card[3] != [want_gbw] or abs(gbw_card[0] - gbw_cpu[0]) > LM_CPU_ATOL:
            raise AssertionError(f"gbw eval_lm: launches {gbw_card[3]} (expected [{want_gbw}]), loss card "
                                 f"{gbw_card[0]} against the CPU's {gbw_cpu[0]}")
    finally:
        root.removeHandler(handler)
        handler.close()
    report["phase_s"] = time.perf_counter() - phase_t0
    report["launches"] = {k: v for k, v in total.items() if v}
    emit({"phase": "text_transformer_from_files", "phase_s": report["phase_s"], "corpus_s": report["corpus_s"],
          "launches": report["launches"], "card": card})
    time_wiki103_call(fa)
    return total


def find_row(rows, row_kernel, timed_at):
    return next(r for r in rows if r["kernel"] == row_kernel and r["shape"] == timed_at[0]
                and r["dtype"] == timed_at[1] and r.get("t_block") == (timed_at[2] if len(timed_at) > 2 else None))


def kernel_entry(name, row_kernel, source, replaces, launches, rows, worst_fp32, worst_bf16, timed_at, also_at=None):
    """The ``kernels`` line's entry of ``name``, timed at its row of
    ``row_kernel`` at ``timed_at`` = (shape, dtype[, t_block]), with the
    times of its rows at ``also_at`` (one such place, or a tuple of them)
    beside them when given. A kernel with
    no fp32 form reports its bf16 error as ``max_abs_err``; one with no
    bf16 form has no ``max_abs_err_bf16``."""
    head = find_row(rows, row_kernel, timed_at)
    where = (f"B{head['B']} T{head['T']} C{head['C']} H{head['H']} K{head['K']} padding_l {head['padding_l']}"
             if "K" in head else f"bh{head['bh']} T{head['T']} S{head['S']} D{head['D']} rate {head['rate']}")
    if "t_block" in head:
        where += f" t_block {head['t_block']}"
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": worst_fp32, "max_abs_err_bf16": worst_bf16,
        "ms": head["kernel_ms"], "device_ms": head["kernel_device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_backend": head.get("library_backend"),
        "timed_at": f"{timed_at[0]} {where} {timed_at[1]}",
    }
    if worst_fp32 is None:
        entry["max_abs_err"] = worst_bf16
    if worst_bf16 is None:
        del entry["max_abs_err_bf16"]
    for key in ("max_err_over_max_plain", "wrapper_device_ms", "split_route", "kernel_device_ms_cold",
                "library_device_ms", "library_device_backend"):
        if key in head:
            entry[key] = head[key]
    for at in (() if also_at is None else (also_at,) if isinstance(also_at[0], str) else also_at):
        r = find_row(rows, row_kernel, at)
        entry["at_" + at[0]] = {
            "bh": r["bh"], "T": r["T"], "S": r["S"], "D": r["D"], "dtype": at[1],
            **{k: r.get(k) for k in ("kernel_ms", "kernel_device_ms", "wrapper_device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms", "library_backend", "library_device_ms",
                                     "library_device_backend",
                                     "max_abs_err", "max_err_over_max_plain")}}
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from fbk_fairseq_st_tpu_torch import options, registry
    from fbk_fairseq_st_tpu_torch.cli import generate as generate_cli
    from fbk_fairseq_st_tpu_torch.cli import generate_dualdecoder as dual_cli
    from fbk_fairseq_st_tpu_torch.cli import generate_multitask_classifier as classifier_cli
    from fbk_fairseq_st_tpu_torch.cli import average_checkpoints as average_cli
    from fbk_fairseq_st_tpu_torch.cli import export_fairseq_checkpoint as export_cli
    from fbk_fairseq_st_tpu_torch.cli import import_fairseq_checkpoint as import_cli
    from fbk_fairseq_st_tpu_torch.cli import generate_topk as topk_cli
    from fbk_fairseq_st_tpu_torch.cli import eval_lm as eval_lm_cli
    from fbk_fairseq_st_tpu_torch.cli import infer as infer_cli
    from fbk_fairseq_st_tpu_torch.cli import interactive as interactive_cli
    from fbk_fairseq_st_tpu_torch.cli import preprocess as preprocess_cli
    from fbk_fairseq_st_tpu_torch.cli import preprocess_audio as preprocess_audio_cli
    from fbk_fairseq_st_tpu_torch.cli import score as score_cli
    from fbk_fairseq_st_tpu_torch.cli import train as train_cli
    from fbk_fairseq_st_tpu_torch.criterions import CrossEntropyDualDecoder, CTCMultiLoss
    from fbk_fairseq_st_tpu_torch.data import Dictionary, LanguagePairDataset, encoders, indexed_dataset
    from fbk_fairseq_st_tpu_torch.data.monolingual import LMContextWindowDataset
    from fbk_fairseq_st_tpu_torch.generation import (ContextAwareSequenceGenerator, SequenceGenerator,
                                                     SequenceScorer, TwoPhaseSequenceGenerator, alignment_utils,
                                                     search)
    from fbk_fairseq_st_tpu_torch.ops.core import make_generators
    from fbk_fairseq_st_tpu_torch.ops.specaugment import specaugment
    from fbk_fairseq_st_tpu_torch.train.checkpoint import save_model_checkpoint
    from fbk_fairseq_st_tpu_torch.models import build_model as build_any_model
    from fbk_fairseq_st_tpu_torch.models.conv_transformer import build_model
    from fbk_fairseq_st_tpu_torch.ops import attention
    from fbk_fairseq_st_tpu_torch.ops.ctc import ctc_greedy_decode
    from fbk_fairseq_st_tpu_torch.ops.edit_distance import levenshtein
    from fbk_fairseq_st_tpu_torch.ops.kernels import build as kernel_build
    from fbk_fairseq_st_tpu_torch.ops.kernels import dynamic_conv as dconv
    from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as fa
    from fbk_fairseq_st_tpu_torch.ops.kernels import flash_fwd_single as single
    from fbk_fairseq_st_tpu_torch.ops.kernels import philox
    from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as sweep
    from fbk_fairseq_st_tpu_torch.scripts import asr_prep_json, combine_ne_terms, resegment_data_mustc, spm_tools
    from fbk_fairseq_st_tpu_torch.scripts.eval import (accuracy_from_fulltable, agreement_from_fulltable,
                                                       mustshe_acc, mustshe_acc_fulltable, mustshe_agr_fulltable,
                                                       ne_terms_accuracy)
    from fbk_fairseq_st_tpu_torch.tasks import (SpeechRecognitionTask, SpeechTranslationCTCTask,
                                                SpeechTranslationDualDecodingTask, TranslationTask)
    from fbk_fairseq_st_tpu_torch.tasks.base import Task
    from fbk_fairseq_st_tpu_torch.train import Trainer
    from fbk_fairseq_st_tpu_torch.train import checkpoint, metrics

    modules = {"Trainer": Trainer, "SpeechRecognitionTask": SpeechRecognitionTask,
               "TranslationTask": TranslationTask, "LanguagePairDataset": LanguagePairDataset,
               "SequenceGenerator": SequenceGenerator, "build_model": build_any_model,
               "SpeechTranslationCTCTask": SpeechTranslationCTCTask, "CTCMultiLoss": CTCMultiLoss,
               "ctc_greedy_decode": ctc_greedy_decode, "levenshtein": levenshtein,
               "TwoPhaseSequenceGenerator": TwoPhaseSequenceGenerator,
               "SpeechTranslationDualDecodingTask": SpeechTranslationDualDecodingTask,
               "CrossEntropyDualDecoder": CrossEntropyDualDecoder, "options": options, "registry": registry,
               "generate_cli": generate_cli, "indexed_dataset": indexed_dataset, "search": search,
               "make_generators": make_generators, "specaugment": specaugment,
               "save_model_checkpoint": save_model_checkpoint, "train_cli": train_cli, "checkpoint": checkpoint,
               "metrics": metrics, "classifier_cli": classifier_cli, "topk_cli": topk_cli, "dual_cli": dual_cli,
               "ContextAwareSequenceGenerator": ContextAwareSequenceGenerator, "SequenceScorer": SequenceScorer,
               "Task": Task, "preprocess_cli": preprocess_cli, "preprocess_audio_cli": preprocess_audio_cli,
               "average_cli": average_cli, "score_cli": score_cli, "interactive_cli": interactive_cli,
               "resegment": resegment_data_mustc, "asr_prep_json": asr_prep_json, "encoders": encoders,
               "alignment_utils": alignment_utils, "export_cli": export_cli, "import_cli": import_cli,
               "spm_tools": spm_tools, "Dictionary": Dictionary, "infer_cli": infer_cli,
               "eval_lm_cli": eval_lm_cli, "LMContextWindowDataset": LMContextWindowDataset,
               "fbk_scripts": {m.__name__.rsplit(".", 1)[-1]: m for m in (
                   mustshe_acc, mustshe_acc_fulltable, accuracy_from_fulltable, mustshe_agr_fulltable,
                   agreement_from_fulltable, ne_terms_accuracy, combine_ne_terms)}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    CARD[0] = card
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    build_kernels(kernel_build)

    d = Dictionary()
    for i in range(VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)

    # each check's and path's seconds, printed before the kernels line (the
    # script must end within its time limit on a slower host too)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    # 3.-5., 12. kernels against their plain versions
    _, serve_worst = timed("check_serving_kernels", check_serving_kernels, fa)
    rows, worst, worst_ratio = timed("check_training_kernels", check_training_kernels, fa, philox)
    for key, err in serve_worst.items():
        worst[key] = max(worst[key], err)
    dconv_rows, dconv_worst = timed("check_dconv_kernels", check_dconv_kernels, dconv)
    single_rows, single_worst = timed("check_single_kernel", check_single_kernel, single)
    timed("check_past_grid_cap", check_past_grid_cap, single, dconv)

    # the main paths, each with every count set to 0 just before it
    paths = {}

    def drive(name, fn, *args):
        """Run a path that resets the counts just before its main work and
        returns them just after it (before its cross-checks)."""
        paths[name] = timed(name, fn, *args)
        torch.cuda.empty_cache()

    # 6.-11. conv_transformer and dynamicconv, serving and training
    drive("serve", serve, card, d, fa, dconv, single, attention, build_model, SequenceGenerator)
    drive("train", train, card, d, fa, dconv, single, modules)
    timed("check_train_steps", check_train_steps, d, fa, attention, modules)
    lc_dicts = (lc_dictionary(Dictionary), lc_dictionary(Dictionary))
    drive("serve_lightconv", serve_lightconv, card, lc_dicts, fa, dconv, single, modules)
    drive("train_lightconv", train_lightconv, card, lc_dicts, fa, dconv, single, modules)
    torch.cuda.empty_cache()
    timed("check_lightconv_steps", check_lightconv_steps, lc_dicts, modules)
    torch.cuda.empty_cache()
    # 13. the flash sweep
    drive("flash_sweep", flash_sweep, card, sweep, fa, dconv, single)
    if paths["flash_sweep"]["flash_fwd_single"] == 0:
        raise AssertionError("the flash sweep launched no flash_fwd_single kernel")
    # 14.-16. the CTC flagship and the long-context step
    ctc_dicts = ctc_dictionaries(Dictionary, d)
    drive("train_ctc_flagship", train_ctc, card, ctc_dicts, fa, dconv, single, modules)
    timed("check_ctc_steps", check_ctc_steps, ctc_dicts, modules, attention)
    torch.cuda.empty_cache()
    drive("train_longcontext", train_long, card, d, fa, dconv, single, modules)
    timed("check_long_steps", check_long_steps, d, modules, attention)
    torch.cuda.empty_cache()
    # 17.-19. the multi-decoder family: two-phase serving, the dual-decoder step
    rng = np.random.RandomState(3)
    twophase_requests = {
        TWOPHASE_ARCHS[0]: [("bench_decode_twophase_32x409-512", make_request(rng, 32, 409, 512, 512)),
                            ("single_1x512", make_request(rng, 1, 512, 512, 512))],
        **{arch: [("8x409-512", make_request(rng, 8, 409, 512, 512))] for arch in TWOPHASE_ARCHS[1:]},
    }
    for arch, requests in twophase_requests.items():
        drive(f"serve_{arch}", serve_twophase, card, d, fa, dconv, single, attention, modules, arch, requests)
    drive("train_dualdecoder", train_dual, card, d, fa, dconv, single, modules)
    timed("check_dual_steps", check_dual_steps, d, fa, attention, modules)
    # 20. the iwslt lightconv step: head dim 128, the D 128 tensor-core flash
    # forward and pair; 20b. the same step in fp32: the D 128 tf32x3 forward
    # and pair
    drive("train_iwslt", train_lightconv, card, lc_dicts, fa, dconv, single, modules, IWSLT_ARCH,
          IWSLT_TIMED_STEPS, D128_FORWARD, D128_BACKWARD, "train_iwslt")
    drive("train_iwslt_fp32", train_iwslt_fp32, card, lc_dicts, fa, dconv, single, modules, attention)
    # 21.-23. serving from files, the search strategies, the realistic step
    drive("serve_from_files", serve_from_files, card, d, fa, dconv, single, modules)
    drive("serve_search", serve_search, card, d, fa, dconv, single, modules)
    drive("train_realistic", train_realistic, card, d, fa, dconv, single, modules)
    # 24.-26. training from files: the quick start through cli/train, resumed,
    # decoded; then, on its corpus, the multitask classifier trained and
    # served, and knowledge distillation from its checkpoint_best.pt
    with tempfile.TemporaryDirectory() as files_tmp:
        drive("train_from_files", train_from_files, card, d, fa, dconv, single, modules, files_tmp)
        drive("multitask_from_files", multitask_from_files, card, d, fa, dconv, single, modules, files_tmp)
        drive("kd_from_files", kd_from_files, card, d, fa, dconv, single, modules, files_tmp)
        # 27.-28. on the same corpus: multilingual ST trained and served,
        # then the dual decoder trained and served by cli/generate_dualdecoder
        drive("multilingual_from_files", multilingual_from_files, card, d, fa, dconv, single, modules, files_tmp)
        drive("dualdecoder_from_files", dualdecoder_from_files, card, d, fa, dconv, single, modules, files_tmp)
        # 29. on the same corpus: context-aware ST trained from phase 24's
        # checkpoint_best.pt, frozen, and served with chained context
        drive("context_from_files", context_from_files, card, d, fa, dconv, single, modules, files_tmp)
        # 30. on the same corpus and save dir, and phase 9's model: the
        # fork's workflow from raw files to the FBK papers' scores
        drive("raw_to_scores", raw_to_scores, card, d, fa, dconv, single, modules, files_tmp, lc_dicts)
        # 31. on the same corpus, save dir and files: the JSON route with
        # sharded asynchronous checkpoints, alignments, sharded and pruned
        # decoding, the fork-checkpoint CLIs, the codecs and --user-dir
        drive("wiring_from_files", wiring_from_files, card, d, fa, dconv, single, modules, files_tmp, lc_dicts)
        # 32. on phase 31's JSON corpus: the fork's ASR side, vggtransformer
        # (cross_entropy_acc, ctc_loss) and w2l_conv_glu (asg_loss) trained
        # through cli/train and decoded by cli/infer's five routes
        drive("asr_from_files", asr_from_files, card, d, fa, dconv, single, modules, files_tmp)
        # 33. on phase 24's corpus: multi-GPU, the ring's kernel route and
        # cli/train through the distributed launcher (NCCL), with FSDP and
        # BMUF
        drive("multi_gpu", multi_gpu, card, d, fa, dconv, single, modules, files_tmp)
        # 34. the text transformer family from files: the WMT big model
        # trained, decoded, scored and aligned, the wiki103 language model
        # trained and scored by cli/eval_lm, and the gbw preset scored
        drive("text_transformer_from_files", text_transformer_from_files, card, d, fa, dconv, single, modules,
              files_tmp)

    # 35. kernels line, card line, ok line
    launches = {k: sum(p[k] for p in paths.values()) for k in paths["serve"]}
    emit({"phase": "main_path_launches", **paths, "total": launches})
    for k, n in launches.items():
        if n == 0 and k not in DCONV_DIRECT_ONLY:
            raise AssertionError(f"the main paths launched no {k} kernel")
    csrc = "fbk_fairseq_st_tpu_torch/ops/kernels/csrc/"
    pallas = "fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py:"
    timed_at = ("encoder_self_attention", "bfloat16")
    long_at = ("long_encoder_self_attention", "bfloat16")
    # fp32: the serving and fp32-step calls; the CUDA-core kernels are
    # launched directly there (no default route takes them at D 32 and 64)
    f32_at = ("encoder_self_attention", "float32")
    f32_long_at = ("long_encoder_self_attention", "float32")
    iwslt_at = ("lightconv_iwslt_cross_attention", "bfloat16")  # the D 128 kernels' model call
    d128_long_at = ("d128_long", "bfloat16")
    f32_iwslt_at = ("lightconv_iwslt_cross_attention", "float32")
    f32_d128_long_at = ("d128_long", "float32")
    f32, b16 = torch.float32, torch.bfloat16
    kernels = [
        kernel_entry("flash_fwd", "flash_attention_fwd", csrc + "flash_fwd.cu", pallas + "117",
                     launches["flash_fwd"], rows, worst[("fwd", f32)], worst[("fwd", b16)], f32_at,
                     (f32_long_at, f32_iwslt_at, iwslt_at)),
        kernel_entry("flash_fwd_tc", "flash_attention_fwd_tc", csrc + "flash_fwd_tc.cu", pallas + "117",
                     launches["flash_fwd_tc"], rows, None, worst[("fwd_tc", b16)], timed_at, long_at),
        kernel_entry("flash_fwd_tc128", "flash_attention_fwd_tc128", csrc + "flash_fwd_tc.cu", pallas + "117",
                     launches["flash_fwd_tc128"], rows, None, worst[("fwd_tc128", b16)], iwslt_at, d128_long_at),
        kernel_entry("flash_fwd_tf32x3", "flash_attention_fwd_tf32x3", csrc + "flash_fwd_tf32x3.cu", pallas + "117",
                     launches["flash_fwd_tf32x3"], rows, worst[("fwd_tf32x3", f32)], None, f32_at, f32_long_at),
        kernel_entry("flash_fwd_tf32x3_128", "flash_attention_fwd_tf32x3_128", csrc + "flash_fwd_tf32x3.cu",
                     pallas + "117", launches["flash_fwd_tf32x3_128"], rows, worst[("fwd_tf32x3_128", f32)], None,
                     f32_iwslt_at, f32_d128_long_at),
        kernel_entry("flash_bwd_fused", "flash_attention_bwd_fused", csrc + "flash_bwd.cu", pallas + "277",
                     launches["flash_bwd_fused"], rows, worst[("bwd_fused", f32)], worst[("bwd_fused", b16)],
                     f32_at, (f32_long_at, iwslt_at)),
        kernel_entry("flash_bwd_dq", "flash_attention_bwd_dq", csrc + "flash_bwd.cu", pallas + "218",
                     launches["flash_bwd_dq"], rows, worst[("bwd_cuda_core", f32)], worst[("bwd_cuda_core", b16)],
                     f32_at, (f32_iwslt_at, iwslt_at)),
        kernel_entry("flash_bwd_dkv", "flash_attention_bwd_dkv", csrc + "flash_bwd.cu", pallas + "386",
                     launches["flash_bwd_dkv"], rows, worst[("bwd_cuda_core", f32)], worst[("bwd_cuda_core", b16)],
                     f32_at, (f32_iwslt_at, iwslt_at)),
        kernel_entry("flash_bwd_dq_tc", "flash_attention_bwd_dq_tc", csrc + "flash_bwd_tc.cu", pallas + "218",
                     launches["flash_bwd_dq_tc"], rows, None, worst[("bwd_tc", b16)], timed_at, long_at),
        kernel_entry("flash_bwd_dkv_tc", "flash_attention_bwd_dkv_tc", csrc + "flash_bwd_tc.cu", pallas + "386",
                     launches["flash_bwd_dkv_tc"], rows, None, worst[("bwd_tc", b16)], timed_at, long_at),
        kernel_entry("flash_bwd_dq_tc128", "flash_attention_bwd_dq_tc128", csrc + "flash_bwd_tc128.cu", pallas + "218",
                     launches["flash_bwd_dq_tc128"], rows, None, worst[("bwd_tc128", b16)], iwslt_at, d128_long_at),
        kernel_entry("flash_bwd_dkv_tc128", "flash_attention_bwd_dkv_tc128", csrc + "flash_bwd_tc128.cu",
                     pallas + "386", launches["flash_bwd_dkv_tc128"], rows, None, worst[("bwd_tc128", b16)], iwslt_at,
                     d128_long_at),
        kernel_entry("flash_bwd_dq_tf32x3", "flash_attention_bwd_dq_tf32x3", csrc + "flash_bwd_tf32x3.cu",
                     pallas + "218", launches["flash_bwd_dq_tf32x3"], rows, worst[("bwd_tf32x3", f32)], None,
                     f32_at, f32_long_at),
        kernel_entry("flash_bwd_dkv_tf32x3", "flash_attention_bwd_dkv_tf32x3", csrc + "flash_bwd_tf32x3.cu",
                     pallas + "386", launches["flash_bwd_dkv_tf32x3"], rows, worst[("bwd_tf32x3", f32)], None,
                     f32_at, f32_long_at),
        kernel_entry("flash_bwd_dq_tf32x3_128", "flash_attention_bwd_dq_tf32x3_128", csrc + "flash_bwd_tf32x3.cu",
                     pallas + "218", launches["flash_bwd_dq_tf32x3_128"], rows, worst[("bwd_tf32x3_128", f32)], None,
                     f32_iwslt_at, f32_d128_long_at),
        kernel_entry("flash_bwd_dkv_tf32x3_128", "flash_attention_bwd_dkv_tf32x3_128", csrc + "flash_bwd_tf32x3.cu",
                     pallas + "386", launches["flash_bwd_dkv_tf32x3_128"], rows, worst[("bwd_tf32x3_128", f32)], None,
                     f32_iwslt_at, f32_d128_long_at),
    ]
    for entry in kernels:
        kind = {"flash_bwd_fused": "bwd_fused", "flash_bwd_dq": "bwd_cuda_core", "flash_bwd_dkv": "bwd_cuda_core",
                "flash_bwd_dq_tc": "bwd_tc", "flash_bwd_dkv_tc": "bwd_tc", "flash_bwd_dq_tc128": "bwd_tc128",
                "flash_bwd_dkv_tc128": "bwd_tc128"}.get(entry["name"])
        if kind:
            entry["worst_bf16_err_over_max_plain"] = worst_ratio.get(kind)
    dconv_at = ("train_k31_centred", "bfloat16")
    conv_tpu = "fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py:24"
    conv_tc, conv_cc = csrc + "dynamic_conv_tc.cu", csrc + "dynamic_conv.cu"
    old_conv = [
        kernel_entry("dynamic_conv_fwd", "dynamic_conv_fwd", conv_cc, conv_tpu, launches["dconv_fwd"], dconv_rows,
                     dconv_worst[("fwd", f32)], dconv_worst[("fwd", b16)], dconv_at),
        kernel_entry("dynamic_conv_bwd", "dynamic_conv_bwd", conv_cc, conv_tpu, launches["dconv_bwd"], dconv_rows,
                     dconv_worst[("bwd", f32)], dconv_worst[("bwd", b16)], dconv_at),
    ]
    for entry in old_conv:
        entry["reached_by"] = "direct call only (route='cuda_core'), for the comparison"
    kernels += [
        kernel_entry("dynamic_conv_fwd_tc", "dynamic_conv_fwd_tc", conv_tc, conv_tpu, launches["dconv_fwd_tc"],
                     dconv_rows, dconv_worst[("fwd_tc", f32)], dconv_worst[("fwd_tc", b16)], dconv_at),
        kernel_entry("dynamic_conv_bwd_tc", "dynamic_conv_bwd_tc", conv_tc, conv_tpu, launches["dconv_bwd_tc"],
                     dconv_rows, dconv_worst[("bwd_tc", f32)], dconv_worst[("bwd_tc", b16)], dconv_at),
        *old_conv,
        kernel_entry("flash_fwd_single", "flash_fwd_single", csrc + "flash_fwd_single.cu",
                     "fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py:28", launches["flash_fwd_single"],
                     single_rows, single_worst[f32], single_worst[b16], SINGLE_TIMED_AT),
    ]
    emit({"phase": "seconds_by_check_and_path", **seconds})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
