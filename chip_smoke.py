#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aps_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and the torch/CUDA
   versions; exits non-zero when torch sees no CUDA device.
2. Builds the port's CUDA kernels from aps_tpu_torch/csrc, one nvcc per
   source, all started together.
3. Builds the full-width flagship (12 conformer layers of width 256, 6
   decoder layers, vocab 4233) from a seeded torch.Generator and writes it
   as an aps_tpu checkpoint (train.yaml + best.ckpt) with a wav.scp of 16
   seeded 8 s waveforms and a dict into a temporary directory.
4. Holds each kernel against its plain PyTorch version at the shapes the
   decode gives it (TF32 off for matmuls and cuDNN) and prints the max abs
   error and the median times of both. decode_batch pads each 8 s
   utterance to its duration bucket, so the front end sees N = 8 x
   149003 samples and the encoder and CTC scorer T = 233 frames of which
   200 are valid; a few other shapes widen the check. The rel-pose
   attention's forward is also held at T = 65, 129 and 700 with per-head
   tables and causal masks, with batch entries without a key and at the
   one-key corner, its lse against the plain log-sum-exp; the CTC scorer
   takes the parent beams' gammas and scores unexpanded, as the search step
   passes them. Both run twice for bit-equal results, and both are timed
   once more with launches queued (the forward against the tensor cores'
   bound). The log-mel kernel is
   also held at the training batch (32 x the loader's padded length), whose
   grid and frame count differ from the decode's, and at the long-form
   path's two batches; at each it runs twice for bit-equal results, and its
   launch alone (operands on the card) and the whole wrapper are timed with
   launches queued, apart. The three backward
   kernels of the rel-pose attention are held against the explicit plain
   backward and against autograd through the plain forward at the training
   step's shape (B = 32, T and k_len as the loader pads the batch) and at
   shapes that widen it (T = 65, 129 and 700, per-head tables, causal,
   k_len 0, and the one-key corner, k_len 1 under a causal mask at T =
   640, whose errors are printed); the delta that dq forms is held against
   PyTorch's, and at the training shape and at T = 700 every backward
   kernel runs twice for bit-equal results. Each kernel's time stands
   beside its bound: the larger of its bytes over the card's memory rate
   and its operations over the card's float32 rate. The forward, dq, dk/dv
   and dpose run on the tensor cores, so their times with launches queued
   are also held against the tensor cores' bound (TF32, each product split
   in three).
5. Decodes them through `aps_tpu_torch.cmd.decode_batch` (batch 8, beam 8,
   ctc weight 0.4, max_len 40), with every kernel's launch count reset just
   before and read just after: per batch K1 once and the rel-pose forward
   once per encoder layer, K4 once per search step, nothing else; every
   search step hands K4 the parent beams' gammas and scores unexpanded (no
   repeat of them across the candidates).
6. Checks 16 transcripts with finite scores, and holds the card's encoder
   output (which must have the shapes the kernels were checked at) and
   best hypotheses for two utterances against the same model on the CPU
   (plain versions of every kernel).
7. Trains the full-width flagship (attention dropout 0 in the encoder,
   the other dropouts 0.1) on 32 seeded 8 s waveforms with 24 labels each
   through `aps_tpu_torch.cmd.train_am` (task asr@ctc_xent, ctc weight 0.2,
   label smoothing 0.1, Adam 1e-4, clip 5.0): three epochs of one step
   with the launch counts reset just before and read just after, then
   timed steps on the same batch with the counts read per step (K1 1, K3
   forward 12, each backward kernel 12). Every loss must be finite and the
   last lower than the first.
8. Holds one training-mode pass with every dropout off, loss and the
   gradients of the pose table, one in_proj and the CTC head, against the
   same pass on the CPU (plain versions of every kernel).

9. Holds the fused TCN block kernel (K5) against its plain version at the
   separation path's shape: N = 32 mixtures of 4 s at 8 kHz, padded by the
   command to 39062 samples, so T = 3905 frames of B = 256 channels with
   H = 512 inside; float32 at the model's eight dilations, causal at
   dilation 128, a T shorter than the dilation's reach, and bfloat16.
10. Separates 64 seeded two-tone mixtures with a seeded full-width
   Conv-TasNet (sse@time_tcn, R = 4 repeats of X = 8 blocks, BatchNorm with
   running statistics off their initial values), written as an aps_tpu
   checkpoint, through `aps_tpu_torch.cmd.separate` in batches of 32: 2 x
   64 finite wavs of the right length, 32 K5 launches per batch at the
   checked shape; then two mixtures card vs CPU (the plain fold) and the
   folded forward vs the module itself on the card.
11. Trains the same model through `aps_tpu_torch.cmd.train_ss` (task
   sse@sisnr with PIT, Adam 1e-3, clip 10, loader se@chunk, batch 8 x 4 s):
   three one-step epochs, then timed steps on the same batch; no hand-written
   kernel launches (the fold is inference-only), the loss must fall; one
   training-mode pass on 4 mixtures card vs CPU, the loss and four
   gradients, with a float64 pass on the card as the referee.

12. Holds the four kernels of the scaled-dot-product flash attention (K2:
   forward, dq, dk/dv, dbias) against their plain versions at the long-form
   path's decode and training shapes, with Tq != Tk, causal masks, a bias
   that differs between the heads, batch entries without a key, ragged T,
   and B = 16 at T = 1024; the backward also at lengths that straddle its
   64-row tiles (63, 64, 65, 129; k_len inside a tile; head dims 16 and
   32) and, twice each at the training shape, for run-to-run equality of
   dq, dk/dv and dbias. The dq kernel also forms delta = sum(do * out),
   held against PyTorch's. Without a bias one PyTorch call,
   scaled_dot_product_attention, computes the same forward (and autograd
   through it dq, dk and dv): its time is printed beside the kernel's as
   `library_ms`, and the port never calls it. dq and dk/dv run on the
   tensor cores (TF32, each product split in three for float32's
   accuracy), so their entries also carry the tensor cores' bound. No
   kernel's time may read below its bound. dbias, one tiled kernel for
   every head width (csrc/attention_dbias.cu), also at the long-form
   step's shape at heads of 64, 96, 128 and 256, at 1100, at SepFormer's
   heads of 8 (the batch cut into groups) and at its tiles' edges, twice
   each for bit-equal results (`check_dbias`); at 64, 128 and 256 with
   every key visible, K2's forward, dq, dk/dv and dbias beside the one
   PyTorch call that computes them with a bias gradient
   (scaled_dot_product_attention with an attn_mask that requires a
   gradient, forward and backward).
13. Trains one step of the flagship with att_dropout 0.1 in the encoder on
   the card: the dense attention path, a finite loss, no attention kernel
   launched.
14. The long-form path at full width: the abs-pose transformer model (12
   post-norm layers of width 256, 4 heads, feed-forward 2048, the
   flagship's decoder and CTC head) written as an aps_tpu checkpoint; 8
   utterances of 24 s through `aps_tpu_torch.cmd.decode_batch` in batches
   of 4 (per batch K1 once, K2's forward 12 times, K4 once per search step
   with the parent beams' operands unexpanded, the rel-pose kernels never);
   two utterances card vs CPU; then training
   through `aps_tpu_torch.cmd.train_am` in batches of 8 x 24 s (a corpus
   of 16, since the loader wants ten utterances; per step K2's forward,
   dq and dk/dv 12 times each, dbias never: the model passes no bias), the
   loss must fall; one training pass with dropouts off at the weights of
   each of five seeds, in float32 on the card and on the CPU, held to a
   float64 pass on the CPU as the referee.
15. Trains examples/asr/librispeech/conf/1a.yaml as written (conformer
   with xl pose, width 512, 12 layers, adamw, acmu_gradient 4, speed
   perturbation, SpecAugment, int16 rescale, matmul_precision bfloat16)
   through `aps_tpu_torch.cmd.train_am` on the 32 utterances of step 7 in
   batches of 4: two epochs of eight mini-steps, launches counted over the
   run (K1 once and each K3 kernel once a layer per mini-step), no
   epoch.N.ckpt; K1 held against its plain version on the first
   rescaled, perturbed batch a training pass handed it, with the recipe
   transform's options, and K3's forward and backward kernels at every
   shape the passes gave them (B = 4, H = 8, one pose table a head),
   twice each for bit-equal results; then at bfloat16 (TF32) and at float32 one accumulation
   cycle with each mini-step timed and counted and one traced for its
   device time and the shares of cuBLAS's products and cuDNN's
   convolutions, the parameters moving on the 4th mini-step of each
   cycle only; finally one training pass with dropouts off and the draws
   fed in, card vs CPU at float32 and TF32 vs float32 on the card (not
   bit-equal, the TF32 flags read inside the pass).
16. The frequency-domain slice, examples/sse/wham/run.sh stages 2 to 4
   with recipe 1b as written (sse@base_rnn: the enh transform's
   spectrogram-log-cmvn of 512/256 sqrthann frames, a 4 x 600 BLSTM, relu
   masks; sse@wa L1; Adam, clip 10, matmul_precision bfloat16 as TF32):
   train_ss on 32 seeded two-speaker mixtures of 4 s at 16 kHz (the
   recipe's batch of 32 x 64000 samples), two one-step epochs and timed
   steps on the same batch, one traced (device time, the kernels with the
   most of it, peak memory), the loss must fall; the STFT, iSTFT and the
   enh features on that batch card vs CPU and the round trip; one training
   pass with dropout off card vs CPU at float32, the TF32 flags read off
   inside it; the trained checkpoint through separate on 16 mixtures of 4
   s, batch 1 and batches of 8, and --mode freq on two, card vs CPU on two
   mixtures (batched, batch 1 and the masks); compute_ss_metric --metric
   sisnr on the card's output, 16 finite values; then sse@freq_tcn at its
   default widths under sse@freq_linear_sa (tPSA): one trainer step on the
   card, one training pass card vs CPU with a float64 referee, and two
   mixtures separated card vs CPU. No hand-written kernel is on this path:
   every launch count stays 0.
17. The multi-channel slice, examples/asr/chime4/run.sh stages 2, 4 and 5
   with conf/1b.yaml as written but for one change, the asr transform's
   feats abs-mel-log-cmvn (aps_tpu's fbank-log-cmvn frames the beamformed
   magnitude as samples and fails): asr@enh_xfmr (the enh transform's
   spectrogram-log-cmvn, a 3 x 512 BLSTM mask estimator and the MVDR, 12
   cfmr/rel layers at 256, 6 decoder layers, asr@ctc_xent, AdamW,
   warmup_noam_lr, TF32) on 32 seeded 5-channel recordings of 8 s through
   train_am: two one-step epochs (K3's forward 12 a validation pass, no
   launch in training: att_dropout 0.2 takes the dense path), then timed
   steps, one traced, the batch's loss with dropouts off must fall over
   them; a training pass with dropouts off card vs CPU at float32 (K3's
   forward and backward on the card), held against a float64 pass on the
   CPU beside two witnesses, the card's pass on the dense path and with
   the front end in float64; the front end TF32 vs float32 and the times of the covariance, the solve
   and the beamforming; the trained weights (output layers x 8) through
   decode_batch with run.sh's stage 4 options and the char RNN LM of
   conf/nnlm/1a.yaml (seeded), max_len 40: 8 recordings of 8 s in one
   batch (K3's forward 12 times, K4 once a search step), compute_wer, one
   batch profiled, two recordings card vs CPU (the same 8-best lists,
   scores within 1e-3); then examples/sse/chime4_ml/run.sh stages 2 and 3
   with conf/1a.yaml as written (sse@rnn_enh_ml, spectrogram-log-cmvn-ipd
   of 1285 features, a 3 x 512 BLSTM, sse@enh_ml) through train_ss on 16
   recordings of 64000 samples and separate on 4, card vs CPU, no kernel
   launched; last, K3's forward and K4 (beam 16) at the chime4 decode's
   shapes and K3's forward and backward kernels at the training pass's
   against their plain versions.
18. The RNN attention slice (`att_phase`), examples/asr/wsj/run.sh and
   examples/asr/timit/run.sh stages 2 and 4 with conf/1a.yaml of each as
   written (TIMIT's schedule-sampling window patched from [10, 26] to
   [0, 4], so that its second epoch trains at ssr 0.2): asr@att through
   train_am on 32 seeded utterances (WSJ 8 s with 96 chars each, TIMIT
   3 s with 36 phones) at TF32, two one-step epochs (K1 once a pass, the
   rate of each training pass read), timed steps, one traced (K1's kernel
   named in the trace, the TF32 flags read inside), a training pass with
   dropouts off and the draws fed in card vs CPU with a float64 referee on
   the CPU; decode_batch on 8 utterances of 8 s with run.sh's stage 4
   options (WSJ: beam 16, nbest 8, ctc 0.4, the seeded char RNN LM of
   conf/nnlm/1a.yaml at 0.6, max_len 220; TIMIT: beam 8, nbest 4, ctc 0.4,
   max_len 80): K1 once a batch and K4 once a search step, one batch
   traced (both kernels named), two utterances card vs CPU; K1 at the
   decode's and a training pass's batch and K4 at the decode's T and lanes
   (TIMIT also at T = 300) against their plain versions.
19. The rest of the SSE zoo: examples/sse/wsj0_2mix/conf/1b.yaml
   (sse@time_dprnn, sse@sisnr; 32 x 32000 samples at 8 kHz),
   examples/sse/dns_is2020/conf/1a.yaml (sse@demucs, sse@wa L1; 32 x
   32085 at 16 kHz) and examples/sse/export_dcunet/conf/1a.yaml (the
   complex sse@dcunet, sse@sisnr; 16 x 64000 at 16 kHz; its 7 stride-2
   layers cut to 6 with the output padding 257 bins need, since as
   written the 7th leaves no bins and neither package builds it) as
   their run.sh stages 2 and 3 run them: train_ss on run.sh's batch of
   seeded mixtures of the loader's chunk (two one-step epochs, timed
   steps), a training pass card vs CPU on two chunks (the float64
   referee for DCUNet's batch norms), separate on four mixtures at batch
   1 and card vs CPU on two; no hand-written kernel launches. Then
   sse@freq_xfmr (6 rel-pose layers of 512, 8 heads, 257 bins, wham 1a's
   transform and task) through train_ss on 16 x 4 s (K3's forward once a
   layer a pass, each backward kernel once a layer a step, counted
   exactly), a training pass card vs CPU (a float64 referee on the CPU),
   separate on four mixtures (K3's
   forward once a layer each) and card vs CPU, and K3's four kernels
   against their plain versions at the shapes those runs handed them.
20. The transducer slice (`transducer_phase`), examples/asr/aishell_v1/
   run.sh stages 2 and 4 with conf/1f.yaml as written (asr@transducer: 12
   conformer layers of 256 with rel pose, a 3 x 512 LSTM prediction net,
   joint 512, task asr@transducer, AdamW, TF32) on a synthetic character
   dictionary of 4231 units (V = 4233 with <unk> and the blank): train_am
   on 16 seeded utterances of 8 s with 40 characters each (two one-step
   epochs; K1 once a pass, K3's forward once a layer a pass, each backward
   kernel once a layer a step), timed steps, one traced; a training pass
   with dropouts off and the draws fed in card vs CPU with a float64
   referee on the CPU; rnnt_loss at the step's shape card vs CPU (its
   gradient 0 past every length); decode_batch on 8 utterances of 8 s with
   run.sh's beam 16, nbest 8 and no LM (K1 once, K3's forward once a
   layer), one batch profiled (device ms, host launches a frame), two
   utterances card vs CPU, also fused with a seeded RNN LM of V ids, and
   an LM of V - 1 ids refused; K1 and K3's four kernels at the shapes the
   step and the decode handed them.
21. The eight sse@ models that no other step runs (`sse8_phase`:
   sse@time_sepformer, sse@freq_sepformer, sse@freq_dprnn, sse@dccrn,
   sse@dense_unet, sse@phasen, sse@dfsmn, sse@chimera++) at the CPU tests'
   depth: one training pass each card vs CPU (referee rule, float64 on the
   CPU; K2's forward, dq and dk/dv once a layer in the sepformers') and one
   mixture separated card vs CPU; then K2's forward, dq and dk/dv at the
   chunk shapes the sepformers handed it and at a SepFormer recipe's (128
   sequences of 250 frames and 1000 of 32, 8 heads of 32).
22. The streaming slice (`streaming_asr_phase`): examples/asr/aishell_v1/
   conf/1f.yaml's transform and nnet_conf as streaming_asr@transducer with
   chunks of 4 encoder frames and 3 chunks of left context: train_am on
   the corpus of step 20 (K1 once a pass, nothing else: the streaming
   attention is dense), timed steps, one traced; a training pass card vs
   CPU with the draws fed in and a float64 referee; decode_batch with
   run.sh's stage 4 and the searches card vs CPU; then streaming_asr@ctc
   on the same encoder: train_am one step, decode_batch through CtcApi,
   ctc_logits card vs CPU, rt_ctc chunk by chunk with its step logits
   card vs CPU; K1 at the decode's and the step's batches. Then
   (`rt_sse_phase`) rt_sse@dfsmn at its documented defaults and
   rt_sse@freq_xfmr at step 19's widths (chunk 4, lctx 3), one source
   under sse@snr with wham 1a's transform: train_ss on 16 x 4 s, a pass
   card vs CPU, separate and card vs CPU, step chunk by chunk against the
   offline masks and the CPU, export's torch.export program through
   RtExported against RtModel (card and CPU), rt_enh frame by frame card
   vs CPU; no kernel launched. Step 17's training pass runs at two more
   seeds (other weights and utterances), and witnesses put one part of
   the front end at a time in float64; step 21 runs SepFormer once more
   at heads of 8 (K2 unpadded in the tiles of 16, its separation
   launching K2).
   (Steps 12 to 17 run where their data is at hand: 12 with the other
   kernel checks, 13 before step 7, 14 after step 8, 15 between 8 and
   14, 16, 17, 19, 21 and 22 last; step 18 runs first, after the builds,
   since its traces name the kernels, and step 20 right after it.)

Each phase's seconds are printed as it ends (`phase <name>: <s> s`) and
all together before the JSON lines. The second-to-last line is a JSON
object with one entry per kernel; the last line is {"ok": true,
"device": {...}}. Any failure exits non-zero before that line is
printed."""

import contextlib
import copy
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

SEED = 777
SR = 16000
NUM_UTTS = 16
UTT_SECS = 8
VOCAB = 4233
DECODE_ARGS = ["--batch-size", "8", "--beam-size", "8", "--ctc-weight", "0.4",
               "--max-len", "40"]
TRAIN_UTTS = 32
TRAIN_LABELS = 24
TRAIN_EPOCHS = 3  # one step each: the corpus is one batch
TIMED_STEPS = 5
ENC_LAYERS = 12
# the long-form path: the abs-pose transformer model on 24 s utterances
LONG_SECS = 24
LONG_UTTS = 8
LONG_BATCH = 4
LONG_DECODE_ARGS = ["--batch-size", str(LONG_BATCH)] + DECODE_ARGS[2:]
LONG_CHECK_UTTS = 2  # of the decode, in the card-vs-CPU check
LONG_TRAIN_UTTS = 8
# the loader wants at least ten utterances: two batches an epoch
LONG_TRAIN_BATCHES = 2
LONG_TIMED_STEPS = 3
# the long-form training pass is held to a float64 referee at the weights
# of each of these seeds
LONG_STEP_SEEDS = tuple(range(SEED, SEED + 5))
# separation: the full-width Conv-TasNet on 8 kHz mixtures
SEP_SR = 8000
SEP_SECS = 4
SEP_UTTS = 64
SEP_BATCH = 32
TCN_CONF = dict(num_spks=2, L=20, N=256, X=8, R=4, B=256, H=512, norm="BN")
TCN_BLOCKS = TCN_CONF["R"] * TCN_CONF["X"]
SEP_TRAIN_UTTS = 8  # one chunk each: the corpus is one batch
SEP_TRAIN_EPOCHS = 3
SEP_CHECK_UTTS = 4  # of the batch, in the card-vs-CPU training pass
# published peaks of one H100 SXM at its full 700 W: device memory and
# float32 outside the tensor cores. Every bound below counts float32
# operations at that rate, whatever unit the kernel uses, so that the rows
# of all kernels compare (K2's forward, dq and dk/dv and K5 compute on the
# tensor cores: they also carry the tensor cores' bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# dense bfloat16 in the tensor cores: the bound of a bfloat16 product,
# whatever unit the kernel itself uses
PEAK_BF16_PER_S = 989e12
# dense TF32 in the tensor cores. K2's kernels and K5 do each float32
# product as three TF32 products, so their second bound is their operations
# over a third of this rate
PEAK_TF32_PER_S = 495e12
TF32_PASSES = 3
TF32_NOTE = (f"operations x {TF32_PASSES} (each float32 product is three "
             "TF32 products) over the dense TF32 peak")
# launches queued between two events when a short kernel is timed a second
# time with the host's enqueue hidden (see time_ms)
QUEUED_CALLS = 10

KERNELS = {
    "fused_logmel": ("aps_tpu_torch/csrc/fbank.cu",
                     "aps_tpu/ops/pallas/fbank.py:72"),
    "flash_attention": ("aps_tpu_torch/csrc/attention.cu",
                        "aps_tpu/ops/pallas/attention.py:141"),
    "flash_attention_dq": ("aps_tpu_torch/csrc/attention_bwd.cu",
                           "aps_tpu/ops/pallas/attention.py:370"),
    "flash_attention_dkv": ("aps_tpu_torch/csrc/attention_bwd.cu",
                            "aps_tpu/ops/pallas/attention.py:394"),
    "flash_attention_dbias": ("aps_tpu_torch/csrc/attention_dbias.cu",
                              "aps_tpu/ops/pallas/attention.py:429"),
    "flash_attention_rel": ("aps_tpu_torch/csrc/rel_attention.cu",
                            "aps_tpu/ops/pallas/rel_attention.py:512"),
    "flash_attention_rel_dq": ("aps_tpu_torch/csrc/rel_attention_bwd.cu",
                               "aps_tpu/ops/pallas/rel_attention.py:202"),
    "flash_attention_rel_dkv": ("aps_tpu_torch/csrc/rel_attention_bwd.cu",
                                "aps_tpu/ops/pallas/rel_attention.py:242"),
    "flash_attention_rel_dpose": ("aps_tpu_torch/csrc/rel_attention_bwd.cu",
                                  "aps_tpu/ops/pallas/rel_attention.py:281"),
    "ctc_score_step": ("aps_tpu_torch/csrc/ctc_score.cu",
                       "aps_tpu/ops/pallas/ctc_score.py:231"),
    "tcn_block_fused": ("aps_tpu_torch/csrc/tcn.cu",
                        "aps_tpu/ops/pallas/tcn.py:126"),
}
# the path each kernel's first check row (and its `launches`) belongs to
DECODE_KERNELS = ("fused_logmel", "flash_attention_rel", "ctc_score_step")
# the check rows of K1 and K4 at the long-form path's shapes
LONG_ROWS = {"fused_logmel": (2, 3), "ctc_score_step": (4, 5)}
# kernels on both paths: the check row taken at the training step's shape
TRAIN_ROW = {"fused_logmel": 1, "flash_attention_rel": 8,
             "flash_attention": 1}
BACKWARD = ("dq", "dkv", "dpose")
# per model: its encoder's attention kernel and the backward kernels a
# training step launches (the abs-pose model passes no bias: no dbias)
ATTENTION = {"flagship": ("flash_attention_rel", BACKWARD),
             "xfmr_abs": ("flash_attention", ("dq", "dkv"))}
# tolerances of kernel vs plain version, both float32 on the card:
# log-mel: 512-term DFT sums in another order, then a log (the JAX package's
#   own fused-vs-layered bound), at the decode's and the training batch's
#   shape alike;
# attention: O(1) outputs, D = 64 dot products and online vs two-pass
#   softmax in another order;
# CTC: values grow to ~1e3 over T = 233 steps of the same sequential
#   recursion; relative term for the large ones, entries at or below
#   MIN_F32 / 2 compare as "both impossible".
# attention gradients: dq, dk, dv entries are O(1) sums of up to T float32
#   products; a dpose row sums up to T * B (* H for a shared table) terms
#   in another order than the plain version's index_add_, so its bound
#   grows with the largest entry of the reference;
# training pass, card vs CPU: float32 sums in another order through 12
#   layers, batch norms over 32 x T frames and a CTC lattice; loss relative,
#   each gradient relative to its largest entry.
TOL_LOGMEL = 1e-3
TOL_ATT = 1e-3
TOL_GRAD, TOL_DPOSE_REL = 1e-3, 1e-4
TOL_CTC_ABS, TOL_CTC_REL = 1e-3, 1e-5
# TCN block: O(1) outputs after two float32 products of depth 256 and 512
#   in another order; in bfloat16 the output is rounded to 8 bits of
#   mantissa (half an ulp of a value of 4 is 1.6e-2) and an entry of y2 may
#   round the other way before the second product;
# separation, card vs CPU and folded vs module: 32 such blocks one after
#   the other, relative to the largest output sample.
TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-4, 2e-3
# sse@sisnr training pass: at random weights the gradient of a layer in
#   front of a batch norm is a small difference of large terms, and float32
#   passes on either device land up to a few 1e-2 of the largest entry from
#   a float64 pass (seen: the CPU's 1e-4 to 2e-2, the card's 4e-4 to 3e-2,
#   either one the larger, while float64 on card and CPU agree to 1e-14).
#   So the card's float64 pass is the referee: the CPU's float32 gradient
#   must be within TOL_SEP_GRAD_REFEREE of it (a missing term or a wrong
#   sign is of order 1), and the card's float32 gradient within
#   TOL_STEP_GRAD plus TOL_SEP_GRAD_NOISE times the CPU's own distance.
TOL_SEP_GRAD_REFEREE, TOL_SEP_GRAD_NOISE = 1e-1, 10.0
TOL_TCN = 1e-4
TOL_TCN_BF16_ABS, TOL_TCN_BF16_REL = 3e-2, 2e-2
TOL_SEP_REL = 1e-3
# the recipe: examples/asr/librispeech/conf/1a.yaml as written (xl pose,
# width 512, 12 layers, adamw, acmu_gradient 4, perturb and aug, int16
# rescale, matmul_precision bfloat16) on the tone corpus of the training
# path, 8 mini-steps of RECIPE_BATCH utterances an epoch
RECIPE_YAML = "examples/asr/librispeech/conf/1a.yaml"
RECIPE_BATCH = 4
RECIPE_HEADS = 8  # its encoder's, one xl pose table each
RECIPE_EPOCHS = 2
# its training pass with every dropout off and the draws fed in: the
# TF32 pass (the recipe's bfloat16) against the float32 pass on the card,
# loss relative, each gradient relative to its largest entry. TF32 keeps
# 10 of float32's 23 mantissa bits (each operand of a product rounded by
# up to 2^-11 of itself). Read on three runs: loss 2.4e-6 to 1.9e-5,
# gradients 7.1e-4 to 6.1e-3; the limits stand about 5 and 3 times above
# the largest reading. Bfloat16 operands (8 bits, 2^-9) would read about 8
# times TF32's distance, and a pass whose flags were never set equals the
# float32 pass bit for bit: both fail (the flags are also read inside)
TOL_TF32_LOSS, TOL_TF32_GRAD = 1e-4, 2e-2
# the LM slice. REPO: the checkout this script lies in (the recipes' YAML)
REPO = Path(__file__).resolve().parent
# run.sh stage 4 of examples/asr/aishell_v1 (run.sh:83-94): decode_batch
# with the RNN LM of its stage 3, in batches of LM_BATCH of the flagship's
# utterances
LM_STAGE4_ARGS = ["--beam-size", "16", "--nbest", "8", "--ctc-weight", "0.4",
                  "--lm-weight", "0.2", "--max-len", "50", "--len-norm",
                  "false"]
LM_MAX_LEN = 50
# the decode gate of PERF.md section 2, on scores that len_norm false
# leaves as sums over the hypothesis: card vs CPU within LM_SCORE_TOL a
# token (the length-normalised score's gate), i.e. |diff| <= LM_SCORE_TOL
# x (tokens + eos)
LM_SCORE_TOL = 1e-3
LM_BATCH = 8
LM_CHECK_UTTS = 2  # of the fused decode, in the card-vs-CPU check
RNN_LM_YAML = "examples/asr/aishell_v1/conf/nnlm/1a.yaml"
XFMR_LM_YAML = "examples/asr/librispeech/conf/nnlm/1b.yaml"
# it scores the whole prefix again every step, and the CPU's search of an
# utterance takes some 11 s: one utterance
XFMR_LM_UTTS = 1
# the seeded LMs' output layers are scaled so that their log-probabilities
# are far from uniform and the fusion moves the search
LM_PEAKY = 4.0
# train_lm: RNN_LM_YAML as written on seeded token text of the vocabulary
LM_TRAIN_LINES = 64
LM_TRAIN_BATCH = 32
LM_TRAIN_EPOCHS = 2
LM_TIMED_STEPS = 5
LM_GRADS = ("lm_embed.weight", "pred.OptimizedLSTMCell_0.weight_hh_l0",
            "dist.weight")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# seconds of each phase of the run, on the host clock, in the order they
# ended (a phase inside another is named "outer / inner")
PHASE_SECS: dict = {}


def phase_ended(name: str, beg: float) -> None:
    """Phase `name`, begun at perf_counter() `beg`, has ended: its seconds
    are printed now and all together before the `kernels` line."""
    secs = time.perf_counter() - beg
    PHASE_SECS[name] = PHASE_SECS.get(name, 0.0) + secs
    print(f"phase {name}: {secs:.1f} s", flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Time the phase run inside the block (phase_ended)."""
    beg = time.perf_counter()
    yield
    phase_ended(name, beg)


def nbest_error(cpu, card, tol: float = 1e-3):
    """The card's n-best list against the CPU's (lists of {"trans",
    "score"}): the scores rank by rank within tol, and the hypotheses rank
    by rank the same but where a rank sits in a near-tie, another entry of
    either list scored within tol of it. On seeded weights the searches
    are full of such near-ties, which float32 rounding orders, and prunes,
    either way (an NVIDIA H100 80GB HBM3, 700.00 W, against the CPU):
    wsj 1a's 2nd and 3rd hypotheses scored 3e-6 apart and the card ranked
    them the other way; in TIMIT 1a's the four best lay within 5e-4 of
    each other and each device kept one the other had pruned.
    -> the largest score difference, or None when the lists disagree."""
    if len(cpu) != len(card) or not cpu:
        return None
    err = max(abs(a["score"] - b["score"]) for a, b in zip(cpu, card))
    if err > tol:
        return None
    for i, (a, b) in enumerate(zip(cpu, card)):
        if a["trans"] != b["trans"] and not any(
                abs(h["score"] - a["score"]) <= tol
                for side in (cpu, card)
                for j, h in enumerate(side) if j != i):
            return None
    return err


def time_ms(fn, iters: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median device time of fn() in ms over iters timed samples. A sample
    is the time between two events around `calls` calls. With one call a
    short kernel reads up to some 20 us high (the stream idles between the
    first event and the launch that the host is still preparing); with
    several calls queued back to back that gap hides behind the call
    before."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        beg = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        beg.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(beg.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FP32_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes and do flops operations (float32 unless another peak is
    given), at its published peaks."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def print_rows(name, rows, card):
    """One line per check row of a kernel; a time below the row's bound
    means that the bound or the clock is wrong, and fails."""
    for label, err, ms, plain_ms, bound, bound_by, *more in rows:
        print(f"{name} [{label}]: max abs err {err:.3e}, kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms by "
              f"{bound_by}" + "".join(f", {k} {v}" for k, v in
                                      (more[0].items() if more else ()))
              + f" ({card})", flush=True)
        if not ms >= bound:
            fail(f"{name} [{label}]: {ms} ms reads below its bound {bound}")


def path_shapes(model, secs=UTT_SECS):
    """(S, T, k_len) of a batch of utterances of secs in decode_batch:
    samples per utterance after padding to the duration bucket, encoder
    (and CTC) frames of that padded batch, and the valid frames of each."""
    import torch

    from aps_tpu_torch.cmd.decode_batch import quantize_dur
    S = quantize_dur(secs * SR, base=SR)
    frames = model.asr_transform._num_frames(torch.tensor([S, secs * SR]))
    T, k_len = model.encoder.num_frames(frames).tolist()
    return S, T, k_len


def decode_batch_of(wavs, count, S):
    """The first count utterances padded to S samples, as decode_batch
    stacks its first batch."""
    import torch
    wav = torch.zeros((count, S))
    for n, key in enumerate(sorted(wavs)[:count]):
        wav[n, :len(wavs[key])] = torch.from_numpy(wavs[key])
    return wav


def check_fbank(dev, model, batches):
    """K1 with the front end's own arguments on each (path, N x S batch):
    the decode's first batch, padded as decode_batch pads it, the training
    batch as the loader collates it (another grid size and frame count), and
    the long-form path's two. Each runs twice for bit-equal results; the
    kernel's launch alone (ops.fbank.launch) and the whole wrapper (its
    checks and the launch) are timed with launches queued, apart, on the
    operands the transform keeps on the card. -> (rows, further numbers for
    the `kernels` line)"""
    import numpy as np
    import torch

    from aps_tpu_torch.ops import fbank
    tf = model.asr_transform
    ops = tf.fbank_operands(dev)
    kw = dict(pre_emphasis=tf.pre_emphasis, use_power=tf.use_power,
              log_lower_bound=tf.log_lower_bound, log_eps=tf.eps)
    plain_kw = dict(kw, mel=tf.mel, normalized=tf.stft_normalized)
    rows = []
    more = {"ms_queued": {}, "wrapper_ms_queued": {}}
    radices = [ops.radices >> 3 * i & 7 for i in range(10)]
    print(f"fused_logmel: fft_size {tf.fft_size}, the kernel's stages of "
          f"radix {[r for r in radices if r]} (ops.fbank.fft_plan, passed to "
          f"it)", flush=True)
    for path, wav in batches:
        wav = torch.as_tensor(wav).to(dev)
        N, S = wav.shape
        label = f"N={N} S={S} M={tf.mel.shape[-1]} ({path})"
        args = (wav, ops, tf.frame_hop)
        plain_args = (wav, tf.window, tf.fft_size, tf.frame_hop)
        got = fbank.fused_logmel(*args, **kw)
        want = fbank.fused_logmel_plain(*plain_args, **plain_kw)
        again = fbank.fused_logmel(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"fused_logmel {label}: non-finite output")
        if not torch.equal(got, again):
            fail(f"fused_logmel {label}: two launches differ")
        err = (got - want).abs().max().item()
        if not err <= TOL_LOGMEL:
            # the plain version's float32 DFT can lose a low mel band of
            # int16-scale audio after pre-emphasis (its power lies orders
            # below the frame's), where the kernel's float64 stages keep
            # it: the function in float64 referees, and the kernel must be
            # within the tolerance of it and nearer to it than the plain
            # version
            ref64 = fbank.fused_logmel_plain(wav.double(), *plain_args[1:],
                                             **plain_kw).float()
            plain_err = (want - ref64).abs().max().item()
            err = (got - ref64).abs().max().item()
            if not (err <= TOL_LOGMEL and err < plain_err):
                fail(f"fused_logmel {label}: max abs err {err} from the "
                     f"float64 function (the plain version's {plain_err}), "
                     f"over {TOL_LOGMEL}")
            print(f"fused_logmel [{label}]: the float32 plain version is "
                  f"{plain_err:.3e} from the function in float64, the kernel "
                  f"{err:.3e}", flush=True)
            label += ", against float64"
        ms = time_ms(lambda: fbank.fused_logmel(*args, **kw))
        plain_ms = time_ms(
            lambda: fbank.fused_logmel_plain(*plain_args, **plain_kw))
        queued = time_ms(lambda: fbank.launch(*args, **kw),
                         calls=QUEUED_CALLS)
        wrapper = time_ms(lambda: fbank.fused_logmel(*args, **kw),
                          calls=QUEUED_CALLS)
        # the least the function needs: it reads the waveform, the window
        # and the mel matrix and writes the features; per frame the real
        # FFT of n = fft_size points as a complex FFT of n/2 points (5 (n/2)
        # log2(n/2) operations) and the split step to the n/2 + 1 bins
        # (about 12 a bin: 6 n), pre-emphasis and window (3 per sample), the
        # power of each bin (3) and the mel product over the matrix's
        # nonzero entries (2 each; its zeros need no operation)
        T, M = got.shape[1:]
        half, F = tf.fft_size // 2, tf.fft_size // 2 + 1
        nnz = int(np.count_nonzero(tf.mel)) if tf.mel is not None else 0
        per_frame = 5 * half * math.log2(half) + 6 * tf.fft_size + \
            3 * tf.frame_len + 3 * F + 2 * nnz
        bound = bound_ms(4 * (N * S + len(tf.window) + F * M + N * T * M),
                         N * T * per_frame)
        if not queued >= bound[0]:
            fail(f"fused_logmel {label}: {queued} ms queued reads below its "
                 f"bound {bound[0]}")
        more["ms_queued"][path] = queued
        more["wrapper_ms_queued"][path] = wrapper
        print(f"fused_logmel [{label}]: launch alone {queued:.4f} ms, through "
              f"the wrapper {wrapper:.4f} ms, with {QUEUED_CALLS} queued",
              flush=True)
        rows.append((label, err, ms, plain_ms) + bound)
    return rows, more


def valid_pairs(T, lens, causal, Tk=None):
    """Number of (query l, key s) pairs the mask leaves, summed over the
    batch, for T queries and Tk (default T) keys: s < k_len[b], and s <= l
    under causal."""
    total = 0
    for n in lens:
        n = min(int(n), T if Tk is None else Tk)
        m = min(n, T)
        total += m * (m + 1) // 2 + (T - m) * n if causal else T * n
    return total


def tensor_core_ms(flops: float) -> float:
    """The tensor cores' bound of float32 products done as three TF32
    products each (TF32_NOTE), in ms."""
    return flops * TF32_PASSES / PEAK_TF32_PER_S * 1e3


def check_rel_attention(dev, gen, T_path=None, k_path=None, H=4,
                        cases=None):
    """K3's forward first as the encoder calls it in the decode (q_c = q_p,
    one shared pose table, every utterance k_path of T_path frames valid),
    then with ragged k_len including batch entries without a key, causal
    masks, per-head tables, T = 65, 129 and 700 (several 64-row blocks and
    32-key tiles), and the one-key corner (k_len 1 under a causal mask at T
    = 640, both table kinds, errors printed); or the given cases, (T, Hp,
    causal, k_len, role) each, B = len(k_len). Every case also holds the
    lse the kernel writes for the backward against the plain log-sum-exp,
    and launches twice for bit-equal results. The decode's row is timed
    once more with launches queued, against the tensor cores' bound.
    -> (rows, further numbers for the `kernels` line)"""
    import torch

    from aps_tpu_torch.ops.rel_attention import (flash_attention_rel,
                                                 launch_forward,
                                                 occupancy,
                                                 rel_lse_reference,
                                                 rel_mha_reference)
    D = 64
    rows = []
    more = {"occupancy": occupancy(D, "fwd")}
    corner = _CORNER_LENS
    for T, Hp, causal, lens, role in cases or (
            (T_path, 1, False, [k_path] * 8, "path"),
            (T_path, 1, True, _ragged(T_path), ""),
            (65, H, True, _ragged(65), ""),
            (129, H, True, _ragged(129), ""),
            (700, 1, False, _ragged(700), ""),
            (700, H, True, _ragged(700), ""),
            (640, 1, True, corner, "corner"),
            (640, H, True, corner, "corner")):
        B = len(lens)
        q_c, q_p, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
                          for _ in range(4))
        if role == "path":
            q_p = q_c
        pose = (0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)).to(dev)
        k_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q_c, q_p, k, v, pose)
        kw = dict(k_len=k_len, causal=causal)
        got = flash_attention_rel(*args, **kw)
        want = rel_mha_reference(*args, **kw)
        out, lse = launch_forward(*args, k_len, causal, True)
        again = launch_forward(*args, k_len, causal, True)
        lse_want = rel_lse_reference(q_c, q_p, k, pose, **kw)
        torch.cuda.synchronize()
        label = (f"B={B} H={H} D=64 T={T} Hp={Hp} causal={causal} k_len="
                 + (f"{lens[0]}" if role == "path" else "1, 2 and T"
                    if role == "corner" else f"{lens} ({role})" if role
                    else "ragged with 0"))
        if not torch.isfinite(got).all():
            fail(f"flash_attention_rel {label}: non-finite output")
        if not (torch.equal(out, got) and torch.equal(again[0], out) and
                torch.equal(again[1], lse)):
            fail(f"flash_attention_rel {label}: two launches differ")
        err = (got - want).abs().max().item()
        lse_err = (lse - lse_want).abs().max().item()
        if not lse_err <= TOL_ATT:
            fail(f"flash_attention_rel {label}: lse max abs err {lse_err} > "
                 f"{TOL_ATT}")
        ms = time_ms(lambda: flash_attention_rel(*args, **kw))
        plain_ms = time_ms(lambda: rel_mha_reference(*args, **kw))
        # four inputs and the output, the pose table and k_len; the three
        # products q_c.k, q_p.pose and p.v over the pairs the mask leaves
        flops = 3 * 2 * D * H * valid_pairs(T, lens, causal)
        bound = bound_ms(
            4 * (5 * B * H * T * D + Hp * (2 * T - 1) * D + B), flops)
        rows.append((label, err, ms, plain_ms) + bound)
        if not err <= TOL_ATT:
            fail(f"flash_attention_rel {label}: max abs err {err} > "
                 f"{TOL_ATT}")
        if role == "corner":
            print(f"flash_attention_rel [{label}] (one-key corner): max abs "
                  f"err {err:.3e}, lse {lse_err:.3e}", flush=True)
            more["one_key_corner_max_abs_err"] = max(
                err, more.get("one_key_corner_max_abs_err", 0.0))
        if role == "path":
            more["ms_queued"] = time_ms(
                lambda: flash_attention_rel(*args, **kw), calls=QUEUED_CALLS)
            more["tensor_core_bound_ms"] = tensor_core_ms(flops)
            if not more["ms_queued"] >= more["tensor_core_bound_ms"]:
                fail(f"flash_attention_rel {label}: {more['ms_queued']} ms "
                     "reads below the tensor cores' bound "
                     f"{more['tensor_core_bound_ms']}")
            print(f"flash_attention_rel [{label}]: {ms:.4f} ms one launch, "
                  f"{more['ms_queued']:.4f} ms with {QUEUED_CALLS} queued; "
                  f"float32 bound {bound[0]:.5f} ms, TF32/3 bound "
                  f"{more['tensor_core_bound_ms']:.5f} ms; "
                  f"{more['occupancy']}", flush=True)
    return rows, more


def check_rel_attention_bwd(dev, gen, T_path=None, lens_path=None, H=4,
                            cases=None):
    """The three backward kernels of K3, each launched alone (dq first: it
    forms delta from do and the forward's output and writes it where dk/dv
    and dpose read it), against rel_mha_backward_reference and against
    autograd through rel_mha_reference: first at the training step's shape
    (B = 32, one shared pose table, the loader's padded T and valid
    frames), then with ragged k_len over several tiles, causal masks,
    per-head tables, batch entries without any valid key (k_len 0: zero
    gradients, no NaN), lengths on either side of dq's 64 query rows and
    dpose's 64 table rows, and the one-key corner (k_len 1 under a long
    causal mask); or the given cases, (T, Hp, causal, k_len, role) each, B
    = len(k_len). At the path's shape, at T = 700 with per-head tables and
    in a case of role "recipe" every kernel runs twice for run-to-run
    equality; at the first two all three are timed with launches queued
    against the tensor cores' bound. Also holds and times the forward that
    writes lse, which the backward reads (rows "fwd"). -> (rows by kernel,
    further numbers by kernel name for the `kernels` line)"""
    import torch

    from aps_tpu_torch.ops.rel_attention import (launch_backward_kernel,
                                                 launch_forward, occupancy,
                                                 rel_mha_backward_reference,
                                                 rel_mha_reference)
    D = 64
    rows = {kernel: [] for kernel in BACKWARD + ("fwd",)}
    names = [f"flash_attention_rel_{k}" for k in BACKWARD]
    more = {name: {} for name in names}
    for name, kernel in zip(names, BACKWARD):
        more[name]["occupancy"] = occupancy(D, kernel)
    corner = _CORNER_LENS
    # (T, Hp, causal, k_len, what the row is for)
    for T, Hp, causal, lens, role in cases or (
            (T_path, 1, False, lens_path, "path"),
            (T_path, 1, True, _ragged(T_path), ""),
            (700, 1, False, _ragged(700), ""),
            (700, H, True, _ragged(700), "t700"),
            (65, H, True, _ragged(65), ""),
            (129, 1, False, _ragged(129), ""),
            (640, H, True, corner, "corner")):
        B = len(lens)
        q_c, q_p, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                              for _ in range(5))
        pose = (0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)).to(dev)
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q_c, q_p, k, v, pose, klen)
        label = (f"B={B} H={H} D=64 T={T} Hp={Hp} causal={causal} k_len="
                 + (f"{lens[0]}" if len(set(lens)) == 1 else
                    "1, 2 and T" if role == "corner" else
                    f"{lens} ({role})" if role in ("recipe", "chime4",
                                                   "freq_xfmr", "1f")
                    else "ragged"))
        out, lse = launch_forward(*args, causal, True)
        delta = torch.full_like(lse, float("nan"))
        run = lambda kernel: launch_backward_kernel(  # noqa: E731
            kernel, *args, do, lse, out, delta, causal)
        got = {kernel: run(kernel) for kernel in BACKWARD}
        want = rel_mha_backward_reference(q_c, q_p, k, v, pose, do,
                                          k_len=klen, causal=causal)
        leaves = [t.clone().requires_grad_() for t in args[:5]]
        ref = rel_mha_reference(*leaves, k_len=klen, causal=causal)
        auto = torch.autograd.grad(ref, leaves, do)
        torch.cuda.synchronize()
        fwd_err = (out - ref).abs().max().item()
        if not fwd_err <= TOL_ATT:
            fail(f"flash_attention_rel with lse {label}: max abs err "
                 f"{fwd_err} > {TOL_ATT}")
        delta_err = (delta - (do * out).sum(-1)).abs().max().item()
        if not delta_err <= TOL_GRAD:
            fail(f"flash_attention_rel_dq {label}: its delta is "
                 f"{delta_err} from sum(do * out)")
        pairs = H * valid_pairs(T, lens, causal)
        if role in ("path", "t700", "recipe", "chime4", "freq_xfmr", "1f"):
            fwd_ms = time_ms(lambda: launch_forward(*args, causal, True))
            fwd_plain_ms = time_ms(lambda: rel_mha_reference(
                *args[:5], k_len=klen, causal=causal))
            rows["fwd"].append((label + " with lse", fwd_err, fwd_ms,
                                fwd_plain_ms) + bound_ms(
                4 * (5 * B * H * T * D + B * H * T + Hp * (2 * T - 1) * D
                     + B), 3 * 2 * D * pairs))
            if role in ("path", "1f"):
                tensor_ms = tensor_core_ms(3 * 2 * D * pairs)
                queued = time_ms(lambda: launch_forward(*args, causal, True),
                                 calls=QUEUED_CALLS)
                if not queued >= tensor_ms:
                    fail(f"flash_attention_rel with lse {label}: {queued} ms "
                         f"reads below the tensor cores' bound {tensor_ms}")
                if role == "path":
                    more["fwd_train_tensor_core_bound_ms"] = tensor_ms
                    more["fwd_train_ms_queued"] = queued
                else:
                    more[f"fwd_{role}"] = {"ms_queued": queued,
                                           "tensor_core_bound_ms": tensor_ms}
                print(f"flash_attention_rel with lse [{label}]: {fwd_ms:.4f} "
                      f"ms one launch, {queued:.4f} ms with {QUEUED_CALLS} "
                      f"queued; TF32/3 bound {tensor_ms:.5f} ms", flush=True)
            # every kernel owns its sums: a second launch gives the same
            # bits, delta included
            delta_first = delta.clone()
            for kernel in BACKWARD:
                if not all(torch.equal(x, y) for x, y in
                           zip(got[kernel], run(kernel))):
                    fail(f"flash_attention_rel_{kernel} {label}: two "
                         "launches differ")
            if not torch.equal(delta_first, delta):
                fail(f"flash_attention_rel_dq {label}: two launches differ "
                     "in delta")
        dead = lse >= 1e30
        if bool(dead.any()) != (min(lens) == 0) or \
                not torch.isfinite(lse).all():
            fail(f"flash_attention_rel {label}: lse marks the wrong rows "
                 "as without a valid key")
        grads = {"dq": got["dq"], "dkv": got["dkv"],
                 "dpose": got["dpose"][:1]}
        index = {"dq": (0, 1), "dkv": (2, 3), "dpose": (4,)}
        plain_ms = time_ms(lambda: rel_mha_backward_reference(
            q_c, q_p, k, v, pose, do, k_len=klen, causal=causal),
            iters=5, warmup=1)
        size = B * H * T * D
        table = Hp * (2 * T - 1) * D
        # every kernel reads q_c, q_p, k, v, do, pose, lse, delta and k_len
        # and recomputes the scores (q_c.k, q_p.pose) and dp = do.v; dq
        # adds ds.k and ds.pose, dk/dv adds p.do and ds.q_c, dpose adds
        # ds.q_p; outputs: two B x H x T x D tensors, or the table. (dq
        # reads the forward's output where the others read delta, and
        # writes delta: T D floats more, far from binding.)
        reads = 4 * (5 * size + table + 2 * B * H * T + B)
        ops = {"dq": 5 * 2 * D * pairs, "dkv": 5 * 2 * D * pairs,
               "dpose": 4 * 2 * D * pairs}
        bounds = {"dq": bound_ms(reads + 8 * size, ops["dq"]),
                  "dkv": bound_ms(reads + 8 * size, ops["dkv"]),
                  "dpose": bound_ms(reads + 4 * table, ops["dpose"])}
        errs = {}
        for kernel in BACKWARD:
            err = 0.0
            for g, i in zip(grads[kernel], index[kernel]):
                if not torch.isfinite(g).all():
                    fail(f"flash_attention_rel_{kernel} {label}: non-finite "
                         "gradient")
                tol = TOL_GRAD
                if kernel == "dpose":
                    tol += TOL_DPOSE_REL * want[i].abs().max().item()
                for other in (want[i], auto[i]):
                    e = (g - other).abs().max().item()
                    err = max(err, e)
                    if not e <= tol:
                        fail(f"flash_attention_rel_{kernel} {label}: max "
                             f"abs err {e} > {tol}")
            errs[kernel] = err
            ms = time_ms(lambda: run(kernel))
            rows[kernel].append((label, err, ms, plain_ms) + bounds[kernel])
        # keys past k_len get exactly zero dk and dv
        for g in got["dkv"]:
            for b, n in enumerate(lens):
                if torch.count_nonzero(g[b, :, n:]) != 0:
                    fail(f"flash_attention_rel_dkv {label}: gradient at a "
                         f"padded key of batch entry {b}")
        if role == "corner":
            print(f"flash_attention_rel backward [{label}] (one-key "
                  "corner): max abs err dq "
                  f"{errs['dq']:.3e}, dk/dv {errs['dkv']:.3e}, dpose "
                  f"{errs['dpose']:.3e}", flush=True)
            for name, kernel in zip(names, BACKWARD):
                more[name]["one_key_corner_max_abs_err"] = errs[kernel]
            # the referee: the plain backward in float64
            ref64 = rel_mha_backward_reference(
                *(t.double() for t in (q_c, q_p, k, v, pose, do)),
                k_len=klen, causal=causal)
            more[names[1]]["one_key_corner_float64"] = corner_referee(
                "flash_attention_rel_dkv", label, got["dkv"],
                want[2:4], ref64[2:4], T)
        if role not in ("path", "t700", "1f"):
            continue
        # once more with launches queued, which hides the host's share
        for name, kernel in zip(names, BACKWARD):
            tensor_ms = tensor_core_ms(ops[kernel])
            entry = {"ms_queued": time_ms(lambda: run(kernel),
                                          calls=QUEUED_CALLS),
                     "tensor_core_bound_ms": tensor_ms}
            if not entry["ms_queued"] >= tensor_ms:
                fail(f"{name} {label}: {entry['ms_queued']} ms reads below "
                     f"the tensor cores' bound {tensor_ms}")
            if role == "path":
                more[name].update(entry)
            else:
                more[name][role] = {
                    "shape": label, "ms": rows[kernel][-1][2],
                    "bound_ms": bounds[kernel][0], **entry}
        queued = {kernel: (more[name] if role == "path" else
                           more[name][role])["ms_queued"]
                  for name, kernel in zip(names, BACKWARD)}
        print(f"flash_attention_rel backward [{label}]: with "
              f"{QUEUED_CALLS} launches queued: "
              + ", ".join(f"{kernel} {ms:.4f} ms"
                          for kernel, ms in queued.items()), flush=True)
    return rows, more


def _sdpa(q, k, v, k_len):
    """The one PyTorch call that computes K2's forward without a bias: a
    boolean key mask B x 1 x 1 x Tk from k_len (rows with k_len >= 1 only:
    it gives NaN for a row without a key). The yardstick of the checks
    below; nothing in the port calls it."""
    import torch
    Tk = k.shape[2]
    mask = (torch.arange(Tk, device=q.device)[None, :] <
            k_len[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def _sdpa_train_ms(q, k, v, k_len, do, iters=20, warmup=3):
    """Device ms of the library's forward and the backward of q, k and v
    through it (_sdpa, autograd), on leaves made from q, k, v."""
    import torch
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    return time_ms(lambda: torch.autograd.grad(_sdpa(*leaves, k_len),
                                               leaves, do),
                   iters=iters, warmup=warmup)


def _device_kernel_names(fn):
    """The names of the device kernels one call of fn() runs, longest
    first (what the profiler tells of the library's choice of backend)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [e.key for e in ops]


def _ragged(T):
    return [T, max(T - 17, 2), T // 2, 1, 0, max(T - 90, 2), 3, T // 3]


# the one-key corner: batch entries with one visible key (and two) beside
# long ones, under a causal mask
_CORNER_LENS = [1, 1, 640, 2, 1, 1, 640, 2]


def corner_referee(name, label, got, plain, ref64, Tq):
    """dk and dv of a kernel and of the float32 plain backward, each held
    to the plain backward in float64: their largest distances from it,
    float32's rounding at the size of the largest entry (2^-24 of it), and
    the rounding budget of the kernel's accumulation: dk and dv sum over
    the Tq queries in m16n8k8 products of three TF32 passes each, 3 *
    ceil(Tq / 8) additions into a float32 accumulator, each off by up to
    2^-24 of the largest entry. Printed and returned; the kernel's
    tolerance against the float32 plain pass (TOL_GRAD) is checked where
    the row is made."""
    out = {}
    adds = 3 * -(-Tq // 8)
    for part, g, p, r in zip(("dk", "dv"), got, plain, ref64):
        ulp = r.abs().max().item() * 2.0**-24
        out[part] = {
            "kernel": (g.double() - r).abs().max().item(),
            "plain_float32": (p.double() - r).abs().max().item(),
            "float32_ulp_of_largest": ulp,
            "accumulation_budget": adds * ulp}
    print(f"{name} [{label}] (one-key corner) distance from the float64 "
          "plain backward: " + "; ".join(
              f"{part} kernel {v['kernel']:.3e}, float32 plain "
              f"{v['plain_float32']:.3e} (2^-24 of the largest entry "
              f"{v['float32_ulp_of_largest']:.3e}, {adds} accumulator "
              f"additions {v['accumulation_budget']:.3e})"
              for part, v in out.items()), flush=True)
    return out


# lengths on either side of the backward kernels' 64-row tiles, none 0 (the
# library's call gives NaN for a row without a key)
_EDGE_LENS = [129, 70, 65, 64, 63, 1, 33, 128]


def check_attention(dev, gen, dec_shape, trn_shape):
    """K2, the scaled-dot-product flash attention. Forward: as the long-form
    encoder calls it in the decode (B x T, k_len valid) and in training,
    then Tq != Tk, causal, a bias that differs between the heads, batch
    entries without any key, ragged T, and B = 16 at T = 1024. Backward: dq
    (with the delta it forms), dk/dv and dbias, each launched alone, against
    mha_backward_reference and against autograd through mha_reference, at
    the training shape, at B = 16, T = 1024, at shapes that widen them and
    at lengths that straddle the 64-row tiles of dq and dk/dv (63, 64, 65,
    129; k_len inside a tile; a batch entry without a key; causal with Tq
    != Tk; head dims 16 and 32); at the training shape dq and dk/dv (and
    with a bias dbias, which no model path launches) run twice for
    run-to-run equality. Where one PyTorch call computes the same function
    (no bias, every row with a key), the kernels are held against it too,
    and at the path's shapes and at T = 1024 its time stands beside theirs
    as the library's.
    -> (rows by kernel, library ms by kernel, the library's kernel names,
    further numbers by kernel for the `kernels` line)"""
    import torch

    from aps_tpu_torch.ops.attention import (backward_occupancy,
                                             forward_occupancy,
                                             launch_backward_kernel,
                                             launch_forward, flash_attention,
                                             mha_backward_reference,
                                             mha_reference)
    H = 4
    (B_dec, T_dec, k_dec), (T_trn, lens_trn) = dec_shape, trn_shape
    rows = {name: [] for name in ("fwd", "dq", "dkv", "dbias")}
    library, backends = {}, {}
    more = {f"flash_attention{kernel}": {} for kernel in ("", "_dq", "_dkv")}
    more["flash_attention"].update(occupancy=forward_occupancy(64),
                                   rows=[])

    def make(B, Tq, Tk, with_bias, D=64):
        q = torch.randn((B, H, Tq, D), generator=gen).to(dev)
        k, v = (torch.randn((B, H, Tk, D), generator=gen).to(dev)
                for _ in range(2))
        bias = None
        if with_bias:
            bias = torch.randn((H, Tq, Tk), generator=gen)
            bias[1:] *= 2.0
            bias = bias.to(dev)
        return q, k, v, bias

    def label_of(B, Tq, Tk, causal, bias, lens, D=64):
        return (f"B={B} H=4 D={D} Tq={Tq} Tk={Tk} causal={causal} "
                f"bias={bias is not None} k_len="
                + (f"{lens[0]}" if len(set(lens)) == 1 else "ragged"))

    # forward: decode shape, training shape, then the widening shapes
    D = 64
    for B, Tq, Tk, causal, with_bias, lens, lib in (
            (B_dec, T_dec, T_dec, False, False, [k_dec] * B_dec, "decode"),
            (len(lens_trn), T_trn, T_trn, False, False, lens_trn,
             "training"),
            (8, 200, 300, False, False, _ragged(300), None),
            (8, 300, 200, True, True, _ragged(200), None),
            (8, 601, 601, True, True, _ragged(601), None),
            (16, 1024, 1024, False, False, [1024] * 16, "B=16 T=1024")):
        q, k, v, bias = make(B, Tq, Tk, with_bias)
        k_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(bias=bias, k_len=k_len, causal=causal)
        label = label_of(B, Tq, Tk, causal, bias, lens)
        got = flash_attention(q, k, v, **kw)
        want = mha_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"flash_attention {label}: non-finite output")
        err = (got - want).abs().max().item()
        if not err <= TOL_ATT:
            fail(f"flash_attention {label}: max abs err {err} > {TOL_ATT}")
        for b, n in enumerate(lens):
            if n == 0 and torch.count_nonzero(got[b]) != 0:
                fail(f"flash_attention {label}: batch entry {b} has no key "
                     "but a non-zero output")
        ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: mha_reference(q, k, v, **kw))
        # q read and the output written, k and v read, the bias and k_len;
        # the two products q.k and p.v over the pairs the mask leaves
        nbytes = 4 * (2 * B * H * Tq * D + 2 * B * H * Tk * D + B +
                      (H * Tq * Tk if with_bias else 0))
        bound = bound_ms(nbytes,
                         2 * 2 * D * H * valid_pairs(Tq, lens, causal, Tk))
        rows["fwd"].append((label, err, ms, plain_ms) + bound)
        if lib is not None:
            # no atomics: a second launch gives the same bits
            if not torch.equal(got, flash_attention(q, k, v, **kw)):
                fail(f"flash_attention {label}: two launches differ")
            with torch.no_grad():
                lib_out = _sdpa(q, k, v, k_len)
                lib_err = (lib_out - got).abs().max().item()
                if not lib_err <= TOL_ATT:
                    fail(f"flash_attention {label}: {lib_err} from the "
                         "library's scaled_dot_product_attention")
                lib_ms = time_ms(lambda: _sdpa(q, k, v, k_len))
                lib_queued = time_ms(lambda: _sdpa(q, k, v, k_len),
                                     calls=QUEUED_CALLS)
                if lib == "decode":
                    library["flash_attention"] = lib_ms
                    backends["forward"] = _device_kernel_names(
                        lambda: _sdpa(q, k, v, k_len))[:2]
                elif lib == "training":
                    library["flash_attention (training shape)"] = lib_ms
            queued = time_ms(lambda: flash_attention(q, k, v, **kw),
                             calls=QUEUED_CALLS)
            tensor_ms = tensor_core_ms(
                2 * 2 * D * H * valid_pairs(Tq, lens, causal, Tk))
            if not queued >= tensor_ms:
                fail(f"flash_attention {label}: {queued} ms reads below the "
                     f"tensor cores' bound {tensor_ms}")
            more["flash_attention"]["rows"].append({
                "path": lib, "shape": label, "ms": ms, "ms_queued": queued,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_ms_queued": lib_queued, "bound_ms": bound[0],
                "tensor_core_bound_ms": tensor_ms})
            print(f"flash_attention [{label}]: the library's "
                  f"scaled_dot_product_attention {lib_ms:.4f} ms (queued "
                  f"{lib_queued:.4f}), the kernel queued {queued:.4f} ms, "
                  f"max abs diff from the kernel {lib_err:.3e}", flush=True)

    # backward: (B, Tq, Tk, D, causal, bias, k_len, what the row is for)
    ragged8 = lambda Tk: (8, _ragged(Tk))  # noqa: E731
    for (B, lens), Tq, Tk, D, causal, with_bias, role in (
            ((len(lens_trn), lens_trn), T_trn, T_trn, 64, False, False,
             "path"),
            ((len(lens_trn), lens_trn), T_trn, T_trn, 64, False, True,
             "path"),
            (ragged8(300), 200, 300, 64, False, True, ""),
            (ragged8(200), 300, 200, 64, True, False, ""),
            (ragged8(601), 601, 601, 64, True, True, ""),
            ((16, [1024] * 16), 1024, 1024, 64, False, False, "timed"),
            # the tiles' edges
            (ragged8(63), 63, 63, 64, False, False, ""),
            (ragged8(65), 64, 65, 64, True, False, ""),
            (ragged8(129), 65, 129, 64, False, True, ""),
            (ragged8(64), 129, 64, 64, True, True, ""),
            (ragged8(129), 129, 129, 16, True, False, ""),
            (ragged8(129), 64, 129, 32, False, False, ""),
            ((8, _EDGE_LENS), 129, 129, 64, False, False, "library"),
            ((8, _EDGE_LENS), 65, 129, 32, False, False, "library"),
            # the one-key corner: k_len 1 under a long causal mask
            ((8, _CORNER_LENS), 640, 640, 64, True, False, "corner")):
        q, k, v, bias = make(B, Tq, Tk, with_bias, D)
        scale = D**-0.5
        do = torch.randn((B, H, Tq, D), generator=gen).to(dev)
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        label = label_of(B, Tq, Tk, causal, bias, lens, D)
        kw = dict(bias=bias, k_len=klen, causal=causal)
        out, lse = launch_forward(q, k, v, bias, klen, scale, causal, True)
        kernels = ("dq", "dkv") + (("dbias",) if with_bias else ())
        # dq runs first: it forms delta from do and the forward's output
        # and writes it where the two others read it
        delta_k = torch.full_like(lse, float("nan"))
        run = lambda kernel: launch_backward_kernel(  # noqa: E731
            kernel, q, k, v, bias, klen, do, lse, out, delta_k, scale, causal)
        got = {kernel: run(kernel) for kernel in kernels}
        want = mha_backward_reference(q, k, v, do, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if with_bias:
            leaves.append(bias.clone().requires_grad_())
        ref = mha_reference(*leaves[:3], bias=leaves[3] if with_bias
                            else None, k_len=klen, causal=causal)
        auto = torch.autograd.grad(ref, leaves, do)
        torch.cuda.synchronize()
        fwd_err = (out - ref).abs().max().item()
        if not fwd_err <= TOL_ATT:
            fail(f"flash_attention with lse {label}: max abs err {fwd_err} "
                 f"> {TOL_ATT}")
        dead = lse >= 1e30
        if bool(dead.any()) != (min(lens) == 0) or \
                not torch.isfinite(lse).all():
            fail(f"flash_attention {label}: lse marks the wrong rows as "
                 "without a visible key")
        delta_err = (delta_k - (do * out).sum(-1)).abs().max().item()
        if not delta_err <= TOL_GRAD:
            fail(f"flash_attention_dq {label}: its delta is {delta_err} "
                 "from sum(do * out)")
        grads = {"dq": (got["dq"],), "dkv": got["dkv"]}
        index = {"dq": (0,), "dkv": (1, 2), "dbias": (3,)}
        if with_bias:
            grads["dbias"] = (got["dbias"],)
        if role == "path":
            # every kernel owns its sums: a second launch gives the same
            # bits
            delta_first = delta_k.clone()
            for kernel in kernels:
                first, again = got[kernel], run(kernel)
                if kernel != "dkv":
                    first, again = (first,), (again,)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail(f"flash_attention_{kernel} {label}: two launches "
                         "differ")
            if not torch.equal(delta_first, delta_k):
                fail(f"flash_attention_dq {label}: two launches differ in "
                     "delta")
        plain_ms = time_ms(lambda: mha_backward_reference(q, k, v, do, **kw),
                           iters=5, warmup=1)
        pairs = H * valid_pairs(Tq, lens, causal, Tk)
        qsize, ksize = B * H * Tq * D, B * H * Tk * D
        # every kernel reads q, k, v, do, lse, delta, k_len (and the bias)
        # and recomputes the scores and dp = do.v (4 D operations a pair);
        # dq adds ds.k, dk/dv adds p.do and ds.q; dbias only sums. (dq
        # reads the forward's output where the others read delta, and
        # writes delta: T D floats more, far from binding.)
        reads = 4 * (2 * qsize + 2 * ksize + 2 * B * H * Tq + B +
                     (H * Tq * Tk if with_bias else 0))
        ops = {"dq": 3 * 2 * D * pairs, "dkv": 4 * 2 * D * pairs,
               "dbias": 2 * 2 * D * pairs}
        bounds = {"dq": bound_ms(reads + 4 * qsize, ops["dq"]),
                  "dkv": bound_ms(reads + 8 * ksize, ops["dkv"]),
                  "dbias": bound_ms(reads + 4 * H * Tq * Tk, ops["dbias"])}
        for kernel in kernels:
            err = 0.0
            for g, i in zip(grads[kernel], index[kernel]):
                if not torch.isfinite(g).all():
                    fail(f"flash_attention_{kernel} {label}: non-finite "
                         "gradient")
                for other in (want[i], auto[i]):
                    e = (g - other).abs().max().item()
                    err = max(err, e)
                    if not e <= TOL_GRAD:
                        fail(f"flash_attention_{kernel} {label}: max abs "
                             f"err {e} > {TOL_GRAD}")
            ms = time_ms(lambda: run(kernel))
            rows[kernel].append((label, err, ms, plain_ms) + bounds[kernel])
        # keys past k_len get exactly zero dk and dv
        for g in got["dkv"]:
            for b, n in enumerate(lens):
                if torch.count_nonzero(g[b, :, n:]) != 0:
                    fail(f"flash_attention_dkv {label}: gradient at a "
                         f"padded key of batch entry {b}")
        if role == "corner":
            ref64 = mha_backward_reference(
                *(t.double() for t in (q, k, v, do)), k_len=klen,
                causal=causal)
            more["flash_attention_dkv"]["one_key_corner_float64"] = \
                corner_referee("flash_attention_dkv", label, got["dkv"],
                               want[1:3], ref64[1:3], Tq)
            continue
        if with_bias or not role:
            continue
        # autograd through the library call: one backward gives dq, dk
        # and dv together
        lib_out = _sdpa(*leaves, klen)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do, retain_graph=True)
        lib_err = 0.0
        for g, mine in zip(lib_bwd(), (got["dq"],) + got["dkv"]):
            lib_err = max(lib_err, (g - mine).abs().max().item())
        if not lib_err <= TOL_GRAD:
            fail(f"flash_attention backward {label}: {lib_err} from the "
                 "library's backward")
        if role == "library":
            print(f"flash_attention backward [{label}]: max abs diff from "
                  f"the library's backward {lib_err:.3e}", flush=True)
            continue
        lib_ms = time_ms(lib_bwd)
        # once more with launches queued, which hides the host's share of
        # either side's time
        queued = {kernel: time_ms(lambda: run(kernel), calls=QUEUED_CALLS)
                  for kernel in ("dq", "dkv")}
        lib_queued = time_ms(lib_bwd, calls=QUEUED_CALLS)
        print(f"flash_attention backward [{label}]: autograd through the "
              f"library's scaled_dot_product_attention {lib_ms:.4f} ms for "
              f"dq, dk and dv together, max abs diff {lib_err:.3e}; with "
              f"{QUEUED_CALLS} launches queued: dq {queued['dq']:.4f} ms, "
              f"dk/dv {queued['dkv']:.4f} ms, the library {lib_queued:.4f} "
              "ms", flush=True)
        for kernel in ("dq", "dkv"):
            name = f"flash_attention_{kernel}"
            tensor_ms = tensor_core_ms(ops[kernel])
            if role == "path":
                library[name] = lib_ms
                backends["backward"] = _device_kernel_names(lib_bwd)[:2]
                more[name].update(
                    ms_queued=queued[kernel], library_ms_queued=lib_queued,
                    tensor_core_bound_ms=tensor_ms,
                    tensor_core_bound_note=TF32_NOTE,
                    occupancy=backward_occupancy(D, kernel))
            else:
                more[name]["b16_t1024"] = {
                    "shape": label, "ms": rows[kernel][-1][2],
                    "ms_queued": queued[kernel],
                    "bound_ms": bounds[kernel][0],
                    "tensor_core_bound_ms": tensor_ms,
                    "library_ms": lib_ms, "library_ms_queued": lib_queued}
            if not queued[kernel] >= tensor_ms:
                fail(f"{name} {label}: {queued[kernel]} ms reads below the "
                     f"tensor cores' bound {tensor_ms}")
    return rows, library, backends, more


# K2's dbias (csrc/attention_dbias.cu, one kernel for every head width):
# the long-form training step (the smoke's T and k_len, B = 8, H = 4) at
# DBIAS_STEP_DIMS, the library's training call with a bias beside K2's
# four kernels at DBIAS_LIBRARY_DIMS (every key visible); then (B, H, Tq,
# Tk, D, k_len, causal): a head of 1100, SepFormer's heads of 8 (the batch
# cut into groups), and the tiles' edges (T 63, 64, 65, 129; k_len 0 and
# 1; causal with Tq != Tk; a head off the 16-byte grid)
DBIAS_STEP_DIMS = (64, 96, 128, 256)
DBIAS_LIBRARY_DIMS = (64, 128, 256)
DBIAS_CASES = (
    (4, 2, 129, 129, 1100, [129, 70, 1, 0], False),
    (144, 2, 16, 16, 8, [16] * 144, False),
    (4, 2, 63, 63, 40, [63, 30, 1, 0], False),
    (4, 2, 64, 65, 160, [65, 2, 1, 0], True),
    (5, 2, 65, 129, 256, [129, 52, 1, 0, 43], True),
    (4, 2, 129, 64, 50, [64, 13, 1, 0], False),
)


def _sdpa_bias_train(q, k, v, bias, do):
    """The one PyTorch call that computes K2's forward with a bias H x Tq
    x Tk that requires a gradient (every key visible), and its backward to
    q, k, v and the bias: a function of no arguments that runs both and
    returns the four gradients. The yardstick of check_dbias; nothing in
    the port calls it."""
    import torch
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    B, H, Tq, _ = q.shape

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3].expand(B, H, Tq, -1))
        return torch.autograd.grad(out, leaves, do)
    return run


def _sdpa_bias_backends(run):
    """The backends of torch.nn.attention.sdpa_kernel that take the
    library's training call with a bias gradient, each alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    taken = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run()
            taken.append(backend.name)
        except RuntimeError:
            pass
    return taken


def check_dbias(dev, gen, T_trn, lens_trn, card):
    """K2's dbias, the one tiled kernel of csrc/attention_dbias.cu, at
    DBIAS_STEP_DIMS on the long-form step's shape and at DBIAS_CASES: the
    kernel launched alone on the delta the dq kernel forms, twice for
    bit-equal results, within TOL_GRAD of mha_backward_reference; timed
    alone and with QUEUED_CALLS queued beside the plain version, its
    bound (2 products of 2 D operations a visible pair and batch entry; q,
    k, v, do, lse and delta read, the bias read and dbias written) and the
    tensor cores' bound (TF32/3). At DBIAS_LIBRARY_DIMS with every key
    visible the library's forward and backward with a bias gradient
    (_sdpa_bias_train) is held against K2's forward, dq, dk/dv and dbias
    (the bias's gradient within TOL_GRAD) and timed beside them, queued;
    the profiler names its kernels. -> (rows, library ms at D = 64,
    numbers for the `kernels` line)"""
    import torch

    from aps_tpu_torch.ops.attention import (_sm_count, dbias_groups,
                                             dbias_occupancy,
                                             launch_backward_kernel,
                                             launch_forward,
                                             mha_backward_reference)
    beg = time.perf_counter()
    B = len(lens_trn)
    cases = [(B, 4, T_trn, T_trn, D, list(lens_trn), False)
             for D in DBIAS_STEP_DIMS] + list(DBIAS_CASES)
    rows, more = [], {"occupancy": dbias_occupancy(64), "rows": [],
                      "library": []}
    sms = _sm_count(dev)
    for B, H, Tq, Tk, D, lens, causal in cases:
        q = torch.randn((B, H, Tq, D), generator=gen).to(dev)
        do = torch.randn((B, H, Tq, D), generator=gen).to(dev)
        k, v = (torch.randn((B, H, Tk, D), generator=gen).to(dev)
                for _ in range(2))
        bias = torch.randn((H, Tq, Tk), generator=gen)
        bias[1:] *= 2.0
        bias = bias.to(dev)
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D**-0.5
        groups = dbias_groups(B, H, Tq, Tk, sms)
        label = (f"B={B} H={H} D={D} Tq={Tq} Tk={Tk} causal={causal} k_len="
                 + (f"{lens[0]}" if len(set(lens)) == 1 else "ragged")
                 + f" groups={groups}")
        out, lse = launch_forward(q, k, v, bias, klen, scale, causal, True)
        delta = torch.empty_like(lse)
        run = lambda kernel: launch_backward_kernel(  # noqa: E731
            kernel, q, k, v, bias, klen, do, lse, out, delta, scale, causal)
        run("dq")  # forms delta
        got = run("dbias")
        if not torch.equal(got, run("dbias")):
            fail(f"flash_attention_dbias [{label}]: two launches differ")
        want = mha_backward_reference(q, k, v, do, bias=bias, k_len=klen,
                                      causal=causal)[3]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"flash_attention_dbias [{label}]: non-finite gradient")
        err = (got - want).abs().max().item()
        if not err <= TOL_GRAD:
            fail(f"flash_attention_dbias [{label}]: max abs err {err} > "
                 f"{TOL_GRAD}")
        ops = 2 * 2 * D * H * valid_pairs(Tq, lens, causal, Tk)
        nbytes = 4 * (2 * B * H * (Tq + Tk) * D + 2 * B * H * Tq + B +
                      2 * H * Tq * Tk)
        bound = bound_ms(nbytes, ops)
        queued = time_ms(lambda: run("dbias"), calls=QUEUED_CALLS)
        tensor_ms = tensor_core_ms(ops)
        if not queued >= tensor_ms:
            fail(f"flash_attention_dbias [{label}]: {queued} ms queued reads "
                 f"below the tensor cores' bound {tensor_ms}")
        plain_ms = time_ms(lambda: mha_backward_reference(
            q, k, v, do, bias=bias, k_len=klen, causal=causal), iters=3,
            warmup=1)
        numbers = {"ms_queued": queued, "tensor_core_bound_ms": tensor_ms,
                   "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                   "bound_operations_ms": ops / PEAK_FP32_PER_S * 1e3,
                   "over_tensor_core_bound": queued / tensor_ms,
                   "rel_err": err / want.abs().max().item(),
                   "groups": groups}
        rows.append((label, err, time_ms(lambda: run("dbias")), plain_ms)
                    + bound + (numbers,))
        more["rows"].append({"shape": label, "ms": rows[-1][2], **numbers,
                             "bound_ms": bound[0], "bound_by": bound[1]})
        if not (Tq == T_trn and D in DBIAS_LIBRARY_DIMS):
            continue
        # every key visible: the library's training call with a bias
        # against K2's four kernels, as _Flash launches them
        full = torch.full((B,), Tk, dtype=torch.int32, device=dev)
        lib_run = _sdpa_bias_train(q, k, v, bias, do)

        def k2_train():
            o, s = launch_forward(q, k, v, bias, full, scale, False, True)
            args = (q, k, v, bias, full, do, s, o, delta, scale, False)
            return (launch_backward_kernel("dq", *args),
                    *launch_backward_kernel("dkv", *args),
                    launch_backward_kernel("dbias", *args))
        mine, theirs = k2_train(), lib_run()
        torch.cuda.synchronize()
        lib_err = max((a - b).abs().max().item()
                      for a, b in zip(mine, theirs))
        if not lib_err <= TOL_GRAD:
            fail(f"flash_attention_dbias [{label}]: K2's gradients {lib_err} "
                 "from the library's with a bias")
        entry = {
            "shape": label.replace(f"k_len={lens[0]}", f"k_len={Tk}")
            if len(set(lens)) == 1 else label + " (every key visible)",
            "library_ms": time_ms(lib_run, iters=10, warmup=2),
            "library_ms_queued": time_ms(lib_run, iters=5, warmup=1,
                                         calls=QUEUED_CALLS),
            "k2_train_ms": time_ms(k2_train, iters=10, warmup=2),
            "k2_train_ms_queued": time_ms(k2_train, iters=5, warmup=1,
                                          calls=QUEUED_CALLS),
            "max_abs_diff": lib_err,
            "library_kernels": _device_kernel_names(lib_run)[:3],
            "library_backends": _sdpa_bias_backends(lib_run)}
        entry["k2_over_library_queued"] = (entry["k2_train_ms_queued"] /
                                           entry["library_ms_queued"])
        more["library"].append(entry)
        print(f"flash_attention_dbias [{entry['shape']}]: the library's "
              "scaled_dot_product_attention with a bias gradient, forward "
              f"and backward {entry['library_ms']:.4f} ms (queued "
              f"{entry['library_ms_queued']:.4f}); K2's forward, dq, dk/dv "
              f"and dbias {entry['k2_train_ms']:.4f} ms (queued "
              f"{entry['k2_train_ms_queued']:.4f}, "
              f"{entry['k2_over_library_queued']:.3f}x the library's); max "
              f"abs diff {lib_err:.3e}; backends that take it "
              f"{entry['library_backends']}, its kernels "
              f"{entry['library_kernels']} ({card})", flush=True)
    print(f"flash_attention_dbias: one kernel for every head width, "
          f"{more['occupancy']}; the check took "
          f"{time.perf_counter() - beg:.1f} s ({card})", flush=True)
    return rows, more["library"][0]["library_ms"], more


def dropout_step(egs, dev, gen, card):
    """Two training steps of the full-width flagship with att_dropout 0.1 in
    the encoder, through the trainer, on the card: active attention dropout
    takes the dense rel path (plain PyTorch on the card), so the loss must
    be finite and no attention kernel may launch in a step."""
    import torch

    from aps_tpu_torch.flagship import (build_flagship, flagship_train_conf,
                                        init_weights)
    from aps_tpu_torch.libs import aps_task, aps_trainer
    from aps_tpu_torch.ops import build
    conf = flagship_train_conf(VOCAB)
    conf["nnet_conf"]["enc_kwargs"]["arch_kwargs"]["att_dropout"] = 0.1
    model = build_flagship(conf)
    init_weights(model, gen)
    task = aps_task(conf["task"], model, blank=VOCAB - 1,
                    **conf["task_conf"])
    with tempfile.TemporaryDirectory() as tmp:
        trainer = aps_trainer("dp")(task, device=dev, checkpoint=tmp,
                                    **conf["trainer_conf"])
        torch.cuda.reset_peak_memory_stats(dev)
        secs = []
        for _ in range(2):  # the first step also sets the libraries up
            build.reset_launches()
            torch.cuda.synchronize()
            beg = time.perf_counter()
            done = trainer.train_one_step(egs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - beg)
            if not done:
                break
    launches = dict(build.LAUNCHES)
    loss = float(trainer.reporter.stats["loss"][-1])
    want = {kernel: 0 for kernel in launches}
    want["fused_logmel"] = 1
    if not done or not math.isfinite(loss):
        fail(f"the att_dropout 0.1 step was skipped or its loss {loss} is "
             "not finite")
    if launches != want:
        fail(f"the att_dropout 0.1 step launches {launches}, expected "
             f"{want} (the dense attention path)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"train step (flagship, att_dropout 0.1): dense rel attention on "
          f"the card, loss {loss:.4f}, launches per step {launches}, steps "
          f"{', '.join(f'{v:.4f}' for v in secs)} s (host clock around a "
          f"synchronised step), peak memory {peak:.3f} GiB ({card})",
          flush=True)


def long_decode_phase(root: Path, cpt: Path, wavs, card):
    """LONG_UTTS utterances of LONG_SECS through decode_batch in batches of
    LONG_BATCH, the launch counts reset just before and read just after:
    per batch K1 once and K2's forward once per encoder layer, K4 once per
    search step (the parent beams' operands unexpanded), nothing else.
    -> (stats, launches)."""
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.ops import build
    best = root / "best.txt"
    argv = [str(root / "wav.scp"), str(best), "--am", str(cpt),
            "--dict", str(root / "dict")] + LONG_DECODE_ARGS
    build.reset_launches()
    with scorer_steps() as steps:
        stats = decode_batch.main(argv)
    launches = dict(build.LAUNCHES)
    lines = best.read_text().splitlines()
    if len(lines) != LONG_UTTS or sorted(
            ln.split("\t")[0] for ln in lines) != sorted(wavs):
        fail(f"expected {LONG_UTTS} transcript lines, got {len(lines)}")
    scores = list(stats["scores"].values())
    if len(scores) != LONG_UTTS or not all(map(math.isfinite, scores)):
        fail(f"non-finite or missing scores: {scores}")
    batches = LONG_UTTS // LONG_BATCH
    want = decode_launches("xfmr_abs", batches, len(steps))
    if launches != want or not steps or \
            len(stats["batch_secs"]) != batches:
        fail(f"long-form decode launches {launches} in "
             f"{len(stats['batch_secs'])} batches and {len(steps)} search "
             f"steps, expected {want} with steps > 0")
    secs = stats["decode_secs"]
    print(f"long-form decode: {LONG_UTTS} utterances x {LONG_SECS} s "
          f"through decode_batch in {secs:.4f} s (batches of {LONG_BATCH}: "
          f"{', '.join(f'{b:.4f}' for b in stats['batch_secs'])} s) = "
          f"{stats['audio_secs'] / secs:.2f} audio-s/s, launches "
          f"{launches} ({card})", flush=True)
    return stats, launches


def _ctc_inputs(T, L, groups, parents, dev, gen):
    """Realistic scorer operands: log-probs, monotone gammas with some
    impossible lanes, eos and repeat lanes; the parent beams' gammas and
    scores over `parents` columns, as the search step passes them."""
    import torch

    from aps_tpu_torch.ops.ctc_score import MIN_F32
    p_c = -1.0 - 3.0 * torch.rand((T, L), generator=gen)
    gnx = torch.cumsum(-2.0 * torch.rand((T, parents), generator=gen), 0)
    gbx = torch.cumsum(-2.0 * torch.rand((T, parents), generator=gen), 0)
    gnx[:, ::7] = float(MIN_F32)
    gbx[:3] = float(MIN_F32)
    p_blank = -0.05 - 0.5 * torch.rand((T, groups), generator=gen)
    repeat_ok = (torch.rand((1, L), generator=gen) > 0.1).float()
    eos_mask = (torch.rand((1, L), generator=gen) > 0.92).float()
    old = -50.0 * torch.rand((1, parents), generator=gen)
    return [x.to(dev) for x in (p_c, gnx, gbx, p_blank, repeat_ok, eos_mask,
                                old)]


def _ctc_err(got, want):
    import torch

    from aps_tpu_torch.ops.ctc_score import MIN_F32
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        imp = (g <= MIN_F32 / 2) & (w <= MIN_F32 / 2)
        both = ~imp
        if not torch.isfinite(g[both]).all():
            return math.inf, False
        diff = (g - w).abs()[both]
        worst = max(worst, diff.max().item() if diff.numel() else 0.0)
        ok = ok and bool((diff <= TOL_CTC_ABS +
                          TOL_CTC_REL * w[both].abs()).all())
    return worst, ok


def check_ctc(dev, gen, T, batches=(8, 64), beam=8):
    """K4 at the decode's lanes (8 utterances x beam 8 x ctc beam 12) and
    at the 64-utterance batch of the benchmark shape; for the long-form
    path at its T and its batch of 4; for the chime4 decode at its T and
    beam 16. The parent beams' gammas and scores go
    in unexpanded (beam 8 columns an utterance), as the search step passes
    them; every case launches twice for bit-equal results. The kernel is
    timed on its launch alone, operands and outputs already on the card;
    the first batch's rows once more with launches queued, and through the
    wrapper ctc_score_step with launches queued, whose host work (shape
    checks, the is_first flag, four allocations) outlasts the kernel.
    -> (rows, {label: kernel ms with launches queued}, {label: wrapper ms
    with launches queued})"""
    import torch

    from aps_tpu_torch.ops.ctc_score import (ctc_score_step,
                                             ctc_score_step_plain, launch)
    rows, queued, wrapper = [], {}, {}
    C = 12
    for utts in batches:
        L = utts * beam * C
        ops = _ctc_inputs(T, L, utts, utts * beam, dev, gen)
        for is_first in (True, False):
            got = ctc_score_step(*ops, is_first)
            again = ctc_score_step(*ops, is_first)
            want = ctc_score_step_plain(*ops, is_first)
            torch.cuda.synchronize()
            err, ok = _ctc_err(got, want)
            label = f"T={T} L={L} P={utts * beam} is_first={is_first}"
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"ctc_score_step {label}: two launches differ")
            isf = torch.full((1, 1), float(is_first), device=dev)
            out = tuple(torch.empty_like(x) for x in got)
            kernel = lambda: launch(*ops, isf, out)  # noqa: E731
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: ctc_score_step_plain(*ops, is_first),
                               iters=5, warmup=1)
            if utts == batches[0]:
                queued[label] = time_ms(kernel, calls=QUEUED_CALLS)
                wrapper[label] = time_ms(
                    lambda: ctc_score_step(*ops, is_first),
                    calls=QUEUED_CALLS)
                if not all(torch.equal(x, y) for x, y in zip(got, out)):
                    fail(f"ctc_score_step {label}: the kernel's launch "
                         "differs from the wrapper's")
            # reads p_c (T x L), the parent's two gammas (T x P), the blank
            # columns and the lane rows; writes the two new gammas (T x L)
            # and score and delta; two logaddexp of about eight operations
            # per frame and lane
            P = utts * beam
            bound = bound_ms(4 * (3 * T * L + 2 * T * P + T * utts + 4 * L +
                                  P + 1), 16 * T * L)
            rows.append((label, err, ms, plain_ms) + bound)
            if not ok:
                fail(f"ctc_score_step {label}: outside |d| <= {TOL_CTC_ABS} "
                     f"+ {TOL_CTC_REL} |x| (max abs err {err})")
    for label, ms in queued.items():
        print(f"ctc_score_step [{label}]: {ms:.4f} ms a launch with "
              f"{QUEUED_CALLS} queued; through the wrapper "
              f"{wrapper[label]:.4f} ms", flush=True)
    return rows, queued, wrapper


@contextlib.contextmanager
def scorer_steps():
    """Count the search steps that reach the CTC scorer, and hold every
    call's operands to the parent beams' shapes: gamma_nx, gamma_bx (T x P)
    and old_score (1 x P) reach ctc_score_step with P = L / C columns, so
    the search step repeats none of them across the candidates. Yields the
    list of (L, P), one entry a step."""
    from aps_tpu_torch.asr.beam_search import ctc as scorer_module
    real = scorer_module.ctc_score_step
    steps = []

    def record(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask,
               old_score, is_first):
        T, L = p_c.shape
        P = gamma_nx.shape[1]
        if not (P < L and L % P == 0 and tuple(gamma_bx.shape) == (T, P)
                and tuple(old_score.shape) == (1, P)):
            fail(f"the search step passes the scorer gammas "
                 f"{tuple(gamma_nx.shape)}, {tuple(gamma_bx.shape)} and "
                 f"scores {tuple(old_score.shape)} for {L} lanes: expanded "
                 "to the candidates")
        steps.append((L, P))
        return real(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask,
                    old_score, is_first)

    scorer_module.ctc_score_step = record
    try:
        yield steps
    finally:
        scorer_module.ctc_score_step = real


def decode_launches(name: str, batches: int, steps: int):
    """The launch counts of a decode of `batches` batches and `steps`
    search steps in all: K1 once a batch, the encoder's attention forward
    once per layer and batch, K4 once per search step, nothing else."""
    from aps_tpu_torch.ops import build
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want.update({"fused_logmel": batches,
                 ATTENTION[name][0]: ENC_LAYERS * batches,
                 "ctc_score_step": steps})
    return want


def write_wavs(root: Path, prefix: str, count: int, gen, secs=UTT_SECS):
    """count seeded waveforms of secs (noise under a modulated tone) as
    16-bit files root/<prefix>NN.wav and root/wav.scp -> {key: samples as
    the readers give them back}."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    wavs = {}
    t = np.arange(secs * SR) / SR
    with open(root / "wav.scp", "w") as scp:
        for n in range(count):
            noise = torch.randn(secs * SR, generator=gen).numpy()
            f0 = 150.0 + 20.0 * n
            wav = 0.05 * noise + 0.2 * np.sin(2 * np.pi * f0 * t) * \
                (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
            # 16-bit PCM; the readers give it back as pcm / 32768
            pcm = np.clip(np.round(wav * 32768), -32768, 32767).astype(
                np.int16)
            path = root / f"{prefix}{n:02d}.wav"
            wavfile.write(str(path), SR, pcm)
            scp.write(f"{prefix}{n:02d}\t{path}\n")
            wavs[f"{prefix}{n:02d}"] = pcm.astype(np.float32) / 32768
    return wavs


def write_checkpoint(root: Path, gen, name="flagship", utts=NUM_UTTS,
                     secs=UTT_SECS):
    """The full-width model `name` (flagship: the conformer; xfmr_abs: the
    long-form abs-pose transformer) with seeded weights -> an aps_tpu
    checkpoint directory, a wav.scp of utts waveforms of secs and a dict."""
    import torch

    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.flagship import MODELS, build_flagship, init_weights
    conf = MODELS[name][0](vocab_size=VOCAB, small=False)
    model = build_flagship(conf)
    init_weights(model, gen)
    with torch.no_grad():
        # peaky output layers: well separated candidates, so the CPU and
        # card searches cannot part on near-ties
        model.decoder.output.weight.mul_(8.0)
        model.ctc_head.weight.mul_(8.0)
    cpt = root / "cpt"
    cpt.mkdir()
    full = dict(conf, task="asr@ctc_xent", task_conf={"ctc_weight": 0.4},
                data_conf={}, trainer_conf={})
    # JSON text is valid YAML: read by yaml where present, else by json
    (cpt / "train.yaml").write_text(json.dumps(full, indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "epoch": 0}, fd)
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, VOCAB - 3):
            fd.write(f"t{i} {i}\n")
        fd.write(f"<sos> {VOCAB - 3}\n<eos> {VOCAB - 2}\n")
    wavs = write_wavs(root, "utt", utts, gen, secs)
    return cpt, wavs, model


def write_corpus(root: Path, gen, name="flagship", utts=TRAIN_UTTS,
                 secs=UTT_SECS) -> Path:
    """root/train: utts waveforms of secs with TRAIN_LABELS seeded labels
    each (wav.scp, text, utt2dur) and the train.yaml of the full-width
    model `name` under asr@ctc_xent. The encoder's attention dropout is 0,
    so that its attention takes the flash kernels in training; the other
    dropouts keep their 0.1."""
    import torch

    from aps_tpu_torch.flagship import MODELS
    train = root / "train"
    train.mkdir()
    keys = sorted(write_wavs(train, "trn", utts, gen, secs))
    labels = torch.randint(1, VOCAB - 3, (utts, TRAIN_LABELS),
                           generator=gen).tolist()
    with open(train / "text", "w") as text, \
            open(train / "utt2dur", "w") as dur:
        for key, toks in zip(keys, labels):
            text.write(f"{key} {' '.join(f't{i}' for i in toks)}\n")
            dur.write(f"{key} {secs:.2f}\n")
    conf = MODELS[name][1](VOCAB)
    for key in ("vocab_size", "sos", "eos", "ctc"):
        conf["nnet_conf"].pop(key)  # load_am_conf takes them from the dict
    data = {name: str(train / name) for name in ("text", "utt2dur")}
    data["wav_scp"] = str(train / "wav.scp")
    conf.update(
        # the utterances fill the whole batch size (adaptive batching
        # halves it from adapt_dur seconds on)
        data_conf={"fmt": "am@raw",
                   "loader": {"adapt_dur": secs + 2, "tokenizer": "word"},
                   "train": data, "valid": data})
    (train / "train.yaml").write_text(json.dumps(conf, indent=2))
    return train


def first_batch(root: Path, train: Path, utts=TRAIN_UTTS, count=1):
    """The first of the corpus's count batches of utts utterances as the
    trainer's loader collates them."""
    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.libs import aps_dataloader
    conf, vocab = load_am_conf(str(train / "train.yaml"), str(root / "dict"))
    data_conf = conf["data_conf"]
    loader = aps_dataloader(fmt=data_conf["fmt"], train=False,
                            vocab_dict=vocab, max_batch_size=utts,
                            **data_conf["loader"], **data_conf["valid"])
    batches = list(loader)
    if len(batches) != count or any(b["src_pad"].shape != batches[0][
            "src_pad"].shape for b in batches) or \
            batches[0]["src_pad"].shape[0] != utts:
        fail(f"expected {count} equal batches of {utts} utterances, got "
             f"{[b['src_pad'].shape for b in batches]}")
    return batches[0]


def train_shapes(model, egs):
    """(S, T, k_len list) of the batch: padded samples, encoder frames of
    the padded batch and the valid frames of each utterance."""
    import torch
    S = egs["src_pad"].shape[-1]
    lens = torch.as_tensor(egs["src_len"])
    frames = model.asr_transform._num_frames(
        torch.cat([torch.tensor([S]), lens]))
    T, *k_len = model.encoder.num_frames(frames).tolist()
    return S, T, k_len


def _epoch_losses(log: Path, mode: str):
    """The loss of every "Epoch NN/<mode>" report line of a trainer.log."""
    return [float(re.match(r"[-+]?[0-9.]+", line.split(") = ")[1]).group(0))
            for line in log.read_text().splitlines() if f"/{mode}:" in line]


def step_launches(name: str, passes: int, steps: int):
    """The launch counts of `passes` forward passes of model `name` of
    which `steps` are training steps: K1 once per pass, the encoder's
    attention forward once per layer and pass, its backward kernels once
    per layer and step, every other kernel 0."""
    from aps_tpu_torch.ops import build
    forward, backward = ATTENTION[name]
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want.update({"fused_logmel": passes, forward: ENC_LAYERS * passes})
    want.update({f"{forward}_{k}": ENC_LAYERS * steps for k in backward})
    return want


def train_phase(root: Path, train: Path, egs, dev, card, name="flagship",
                utts=TRAIN_UTTS, secs=UTT_SECS, timed_steps=TIMED_STEPS,
                batches=1):
    """TRAIN_EPOCHS epochs of `batches` steps each through
    aps_tpu_torch.cmd.train_am with the launch counts read over the whole
    run, then timed_steps more steps of the same trainer on the first
    batch, each timed and counted alone.
    -> (launches of the run, launches of one step)."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.ops import build
    cpt = train / "cpt"
    argv = ["--conf", str(train / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(utts),
            "--epochs", str(TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    # the command prints its arguments and configuration: to stderr here,
    # so that every "{" line of this script's stdout is one of its own
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    steps = TRAIN_EPOCHS * batches
    if trainer.device.type != "cuda" or trainer.cur_step != steps:
        fail(f"train_am took {trainer.cur_step} steps on {trainer.device}")
    # every epoch is one training pass over its batches, and a validation
    # pass (forward only) runs before the first and after each
    want = step_launches(name, (2 * TRAIN_EPOCHS + 1) * batches, steps)
    if launches != want:
        fail(f"train_am launches {launches}, expected {want}")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    if len(losses) != TRAIN_EPOCHS or len(valid) != TRAIN_EPOCHS + 1:
        fail(f"trainer.log reports {len(losses)} training and {len(valid)} "
             "validation epochs")
    for written in ("best.ckpt", "last.ckpt", "train.yaml", "dict"):
        if not (cpt / written).is_file():
            fail(f"train_am wrote no {written}")

    per_step = step_launches(name, 1, 1)
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    step_secs = []
    for step in range(timed_steps):
        build.reset_launches()
        torch.cuda.synchronize()
        beg = time.perf_counter()
        done = trainer.train_one_step(egs)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - beg)
        if not done:
            fail(f"timed step {step} was skipped (non-finite loss or norm)")
        if dict(build.LAUNCHES) != per_step:
            fail(f"timed step {step} launches {dict(build.LAUNCHES)}, "
                 f"expected {per_step}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses + valid)):
        fail(f"non-finite loss: training {losses}, validation {valid}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the repeated batch: {losses}")
    print(f"train ({name}): {utts} x {secs} s, {TRAIN_LABELS} labels each, "
          f"asr@ctc_xent through train_am: {TRAIN_EPOCHS} epochs of "
          f"{batches} step(s), launches {launches}; then {timed_steps} "
          f"timed steps on the first batch, launches "
          f"per step {per_step}; training losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; validation losses "
          f"{', '.join(f'{v:.4f}' for v in valid)}", flush=True)
    print(f"train step ({name}): median "
          f"{statistics.median(step_secs):.4f} s of "
          f"{', '.join(f'{v:.4f}' for v in step_secs)} s (host clock around "
          f"a synchronised step), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    return launches, per_step, statistics.median(step_secs)


# per model: the pose table (flagship) or the last layer's feed-forward
# (xfmr_abs), the first layer's in_proj and the CTC head
STEP_GRADS = {
    "flagship": ("encoder.pose_layer.embed.weight",
                 "encoder.encoder.layers.0.self_attn.in_proj.weight",
                 "ctc_head.weight"),
    "xfmr_abs": ("encoder.encoder.layers.11.feedforward.linear1.weight",
                 "encoder.encoder.layers.0.self_attn.in_proj.weight",
                 "ctc_head.weight"),
}


def step_passes(egs, gen, shapes, name, sides):
    """One training-mode pass of asr@ctc_xent over the batch with every
    dropout off for each (device, dtype) of sides, same seeded weights:
    on the card the kernels, on the CPU their plain versions; the front end
    and the encoder must run at the shapes the kernels were checked at.
    -> [(loss, {STEP_GRADS key: gradient on the CPU in float64})]"""
    import torch

    from aps_tpu_torch.flagship import MODELS, build_flagship, init_weights
    from aps_tpu_torch.libs import aps_task
    from aps_tpu_torch.trainer.dp import to_device
    S, T, k_len = shapes
    utts = egs["src_pad"].shape[0]
    grads = STEP_GRADS[name]
    conf = MODELS[name][1](VOCAB)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    model = build_flagship(conf)
    init_weights(model, gen)
    task = aps_task(conf["task"], model, blank=VOCAB - 1,
                    **conf["task_conf"])
    tensors = {k: v for k, v in egs.items() if not k.startswith("#")}
    outs = []
    for where, dtype in sides:
        side = copy.deepcopy(task).to(where, dtype).train()
        seen = []
        side.nnet.encoder.register_forward_hook(
            lambda mod, args, out: seen.append(
                (out[0].shape[1], out[1].tolist())))
        wavs = []
        side.nnet.asr_transform.register_forward_hook(
            lambda mod, args, out: wavs.append(tuple(args[0].shape)))
        batch = to_device(tensors, torch.device(where))
        batch["src_pad"] = batch["src_pad"].to(dtype)
        stats = side(batch)
        stats["loss"].backward()
        if seen != [(T, k_len)] or wavs != [(utts, S)]:
            fail(f"on {where} the front end ran at {wavs} and the encoder "
                 f"at {seen}; the kernels were checked at {utts} x "
                 f"{S} samples, T = {T}, k_len = {k_len}")
        params = dict(side.nnet.named_parameters())
        outs.append((stats["loss"].item(),
                     {k: params[k].grad.double().cpu() for k in grads}))
    return outs


def step_check(egs, dev, gen, shapes, name="flagship"):
    """step_passes on the CPU and on the card in float32: the loss and the
    gradients named in STEP_GRADS must agree."""
    import torch
    (loss_c, grad_c), (loss_g, grad_g) = step_passes(
        egs, gen, shapes, name, (("cpu", torch.float32),
                                 (dev, torch.float32)))
    if not (math.isfinite(loss_g) and
            abs(loss_g - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
        fail(f"training loss card {loss_g} vs CPU {loss_c}: outside "
             f"{TOL_STEP_LOSS} relative")
    errs = {}
    for key in STEP_GRADS[name]:
        scale = grad_c[key].abs().max().item()
        errs[key] = (grad_g[key] - grad_c[key]).abs().max().item() / scale
        if not (scale > 0 and errs[key] <= TOL_STEP_GRAD):
            fail(f"gradient of {key} card vs CPU: {errs[key]} of its "
                 f"largest entry {scale}, over {TOL_STEP_GRAD}")
    return loss_g, loss_c, errs


def referee_step_check(egs, dev, shapes, name, seeds):
    """step_passes at each seed's weights in float32 on the CPU and on the
    card and in float64 on the CPU as the referee (the plain versions run
    in the waveform's dtype). The card's and the referee's losses within
    TOL_STEP_LOSS of the CPU's; each gradient of STEP_GRADS held to the
    float64 one as the separation's are (TOL_SEP_GRAD_*), since at random
    weights float32 passes on either device can land some 1e-3 from it.
    -> {seed: (loss card, loss CPU, {key: (card vs CPU, card vs float64,
    CPU vs float64)})}"""
    import torch
    out = {}
    for seed in seeds:
        (loss_c, grad_c), (loss_g, grad_g), (loss_r, grad_r) = step_passes(
            egs, torch.Generator().manual_seed(seed), shapes, name,
            (("cpu", torch.float32), (dev, torch.float32),
             ("cpu", torch.float64)))
        for loss in (loss_g, loss_r):
            if not (math.isfinite(loss) and
                    abs(loss - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
                fail(f"{name} seed {seed}: training loss card {loss_g} "
                     f"(float64 {loss_r}) vs CPU {loss_c}: outside "
                     f"{TOL_STEP_LOSS} relative")
        errs = {}
        for key in STEP_GRADS[name]:
            scale = grad_r[key].abs().max().item()
            errs[key] = tuple((a - b).abs().max().item() / scale for a, b in
                              ((grad_g[key], grad_c[key]),
                               (grad_g[key], grad_r[key]),
                               (grad_c[key], grad_r[key])))
            _, noise_card, noise_cpu = errs[key]
            bound = TOL_STEP_GRAD + TOL_SEP_GRAD_NOISE * noise_cpu
            if not (scale > 0 and noise_cpu <= TOL_SEP_GRAD_REFEREE and
                    noise_card <= bound):
                fail(f"{name} seed {seed}: gradient of {key} is {noise_card} "
                     f"(card) and {noise_cpu} (CPU) of its largest entry "
                     f"{scale} from the float64 pass, over {bound} or "
                     f"{TOL_SEP_GRAD_REFEREE}")
        out[seed] = (loss_g, loss_c, errs)
    return out


def reference_check(cpt: Path, wavs, dev, stats, shapes):
    """The same checkpoint on the card and on the CPU for two utterances,
    padded to the bucket decode_batch gave them: the encoder output must
    have the shapes the kernels were checked at, and encoder outputs and
    best hypotheses must agree."""
    import torch

    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    S, T, k_len = shapes
    nnet = load_checkpoint(str(cpt))["nnet"]
    keys = sorted(wavs)[:2]
    batch = [wavs[k] for k in keys]
    kw = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=8, nbest=1, max_len=40,
              ctc_weight=0.4, allow_partial=True, pad_to=S)
    outs = {}
    for where in ("cpu", dev):
        model = nnet.to(where)
        x = torch.zeros((1, S), device=where)
        x[0, :len(batch[0])] = torch.from_numpy(batch[0])
        with torch.inference_mode():
            enc, enc_len, _ = model.decode_enc(
                x, torch.tensor([len(batch[0])], device=where))
        if enc.shape[1] != T or enc_len.tolist() != [k_len]:
            fail(f"encoder on {where}: {enc.shape[1]} frames, {enc_len} "
                 f"valid; the kernels were checked at {T}, {k_len}")
        hyps = beam_search_batch(model, batch, device=where, **kw)
        outs[str(where)] = (enc.cpu(), hyps)
    (enc_c, hyp_c), (enc_g, hyp_g) = outs["cpu"], outs[str(dev)]
    enc_err = (enc_c - enc_g).abs().max().item()
    if not enc_err <= 1e-3:
        fail(f"encoder output card vs CPU: max abs err {enc_err} > 1e-3")
    score_err = 0.0
    for key, hc, hg in zip(keys, hyp_c, hyp_g):
        if hc[0]["trans"] != hg[0]["trans"]:
            fail(f"{key}: card and CPU best hypotheses differ")
        score_err = max(score_err, abs(hc[0]["score"] - hg[0]["score"]))
        if abs(hg[0]["score"] - stats["scores"][key]) > 1e-3:
            fail(f"{key}: decode_batch score {stats['scores'][key]} != "
                 f"search score {hg[0]['score']}")
    if not score_err <= 1e-3:
        fail(f"best-hypothesis scores card vs CPU differ by {score_err}")
    return enc_err, score_err


def sep_shapes():
    """(S, T): samples of a SEP_SECS mixture after the separate command's
    padding onto its length grid, and the encoder frames of that length."""
    from aps_tpu_torch.cmd.separate import Separator
    S = Separator.padded_len(SEP_SECS * SEP_SR)
    stride = TCN_CONF["L"] // 2
    return S, (S - TCN_CONF["L"]) // stride + 1


def _tcn_inputs(N, T, dtype, dev, gen):
    """A folded block at the magnitudes the model gives: unit-scale input,
    kernels scaled by 1 / sqrt(fan-in), BatchNorm gains near 1, PReLU slopes
    near 0.25."""
    import torch
    B, H = TCN_CONF["B"], TCN_CONF["H"]
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    pack = 0.3 * rand(11, H)
    pack[[1, 7]] = 1 + 0.2 * torch.rand((2, H), generator=gen)
    pack[[9, 10]] = 0.25 + 0.1 * torch.rand((2, 1), generator=gen)
    x, k1, k2 = rand(N, T, B), rand(B, H) / B**0.5, rand(H, B) / H**0.5
    return (x.to(dev, dtype), k1.to(dev, dtype), pack.to(dev),
            k2.to(dev, dtype), (0.1 * rand(1, B)).to(dev))


def check_tcn(dev, gen, T):
    """K5 at the separation batch's shape, N = SEP_BATCH x T frames x B
    channels: float32 at the eight dilations one repeat runs (the first
    eight rows, whose times add up to a quarter of a forward), bfloat16 at
    the same eight, causal at the largest, a T shorter than twice the
    dilation; two launches of each type give the same bits.
    -> (rows, the per-dilation records of the `kernels` line)"""
    import torch

    from aps_tpu_torch.ops.tcn import (launch_plan, tcn_block_fused,
                                       tcn_block_reference)
    f32, bf16 = torch.float32, torch.bfloat16
    B, H, X = TCN_CONF["B"], TCN_CONF["H"], TCN_CONF["X"]
    cases = [(T, 2**n, False, dtype) for dtype in (f32, bf16)
             for n in range(X)]
    cases += [(T, 128, True, f32), (100, 128, False, f32),
              (100, 64, True, f32), (T, 128, True, bf16)]
    rows, per_dilation = [], {}
    args, made = None, None
    for Tc, d, causal, dtype in cases:
        if made != (Tc, dtype):
            args, made = _tcn_inputs(SEP_BATCH, Tc, dtype, dev, gen), \
                (Tc, dtype)
        got = tcn_block_fused(*args, d, causal=causal)
        want = tcn_block_reference(*args, d, causal=causal)
        torch.cuda.synchronize()
        kind = str(dtype).split('.')[1]
        label = (f"N={SEP_BATCH} T={Tc} B={B} H={H} dilation={d} "
                 f"causal={causal} {kind}")
        if got.dtype != dtype or not torch.isfinite(got).all():
            fail(f"tcn_block_fused {label}: wrong type or non-finite output")
        if d == 16 and not torch.equal(got, tcn_block_fused(*args, d,
                                                            causal=causal)):
            fail(f"tcn_block_fused {label}: two launches differ")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if dtype == f32:
            ok = err <= TOL_TCN
            tol = f"{TOL_TCN}"
        else:
            ok = bool((diff <= TOL_TCN_BF16_ABS +
                       TOL_TCN_BF16_REL * want.float().abs()).all())
            tol = f"{TOL_TCN_BF16_ABS} + {TOL_TCN_BF16_REL} |x|"
        if not ok:
            fail(f"tcn_block_fused {label}: max abs err {err} outside {tol}")
        ms = time_ms(lambda: tcn_block_fused(*args, d, causal=causal))
        plain_ms = time_ms(lambda: tcn_block_reference(*args, d,
                                                       causal=causal))
        # x read and out written once, the weights once; the two products
        # of B x H per frame, whatever part of the first the kernel repeats
        # for its taps
        size = args[0].element_size()
        nbytes = 2 * SEP_BATCH * Tc * B * size + 2 * B * H * size + \
            4 * (11 * H + B)
        ops = 2 * SEP_BATCH * Tc * 2 * B * H
        bound = bound_ms(nbytes, ops, peak=PEAK_FP32_PER_S if dtype == f32
                         else PEAK_BF16_PER_S)
        rows.append((label, err, ms, plain_ms) + bound)
        if Tc != T or causal:
            continue
        plan = launch_plan(Tc, B, d, dtype)
        rec = per_dilation.setdefault(d, {
            "dilation": d, "shape": f"N={SEP_BATCH} T={Tc} B={B} H={H}",
            "first_product_repeat": plan["repeat"],
            "staged_rows_per_block": plan["staged_rows"],
            "blocks": SEP_BATCH * plan["blocks_per_row"] *
            plan["column_groups"]})
        rec[kind] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                     "registers": plan["registers"],
                     "local_bytes": plan["local_bytes"],
                     "smem_bytes": plan["smem_bytes"],
                     "blocks_per_sm": plan["blocks_per_sm"]}
        if dtype == f32:
            tensor_ms = tensor_core_ms(ops)
            rec[kind].update(bound_ms=bound[0], tensor_core_bound_ms=tensor_ms)
            if not ms >= tensor_ms:
                fail(f"tcn_block_fused {label}: {ms} ms reads below the "
                     f"tensor cores' bound {tensor_ms}")
        else:
            rec[kind].update(bound_ms=bound[0], bound_by=bound[1])
        print(f"tcn_block_fused [{label}]: the first product done "
              f"{plan['repeat']:.4f}x over ({plan['staged_rows']} staged rows "
              f"for 64 output rows), {plan['registers']} registers, "
              f"{plan['smem_bytes']} shared bytes, {plan['blocks_per_sm']} "
              "block(s) an SM", flush=True)
    return rows, list(per_dilation.values())


def init_tcn(model, gen) -> None:
    """Seeded weights for the separation run: kernels of unit gain, small
    biases, PReLU slopes of 0.25, BatchNorm gains near 1 and running
    statistics off their initial values."""
    import torch
    from torch import nn
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
                fan_in = mod.weight[0].numel() if not isinstance(
                    mod, nn.ConvTranspose1d) else mod.weight.shape[0]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 / fan_in**0.5)
                mod.bias.copy_(0.05 * torch.randn(mod.bias.shape,
                                                  generator=gen))
            elif isinstance(mod, nn.PReLU):
                mod.weight.fill_(0.25)
            elif isinstance(mod, nn.BatchNorm1d):
                C = mod.weight.shape
                mod.weight.copy_(1 + 0.1 * torch.randn(C, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(C, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(C, generator=gen))
                mod.running_var.copy_(1 + 0.2 * torch.rand(C, generator=gen))


def write_mixtures(root: Path, count: int, gen, sr=SEP_SR, secs=SEP_SECS,
                   names=("mix", "spk1", "spk2")):
    """count seeded two-speaker mixtures of secs at sr (two modulated tones
    and a little noise) as 16-bit files, with their sources: root/<name>.scp
    for the mixture and each source (names) -> {key: mixture samples as the
    readers give them back}."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    S = int(round(secs * sr))
    t = np.arange(S) / sr
    mixes = {}
    scps = {name: open(root / f"{name}.scp", "w") for name in names}
    for n in range(count):
        noise = torch.randn(S, generator=gen).numpy()
        a = 0.2 * np.sin(2 * np.pi * (180.0 + 7.0 * n) * t) * \
            (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
        b = 0.2 * np.sin(2 * np.pi * (520.0 + 11.0 * n) * t) * \
            (0.5 + 0.5 * np.cos(2 * np.pi * 0.9 * t)) + 0.01 * noise
        for name, sig in zip(names, (a + b, a, b)):
            pcm = np.clip(np.round(sig * 32768), -32768, 32767).astype(
                np.int16)
            path = root / f"{name}{n:02d}.wav"
            wavfile.write(str(path), sr, pcm)
            scps[name].write(f"mix{n:02d}\t{path}\n")
            if name == names[0]:
                mixes[f"mix{n:02d}"] = pcm.astype(np.float32) / 32768
    for fd in scps.values():
        fd.close()
    return mixes


def write_tcn_checkpoint(root: Path, gen) -> Path:
    """The full-width sse@time_tcn with seeded weights -> an aps_tpu
    checkpoint directory root/cpt."""
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.libs import aps_sse_nnet
    model = aps_sse_nnet("sse@time_tcn")(**TCN_CONF)
    init_tcn(model, gen)
    cpt = root / "cpt"
    cpt.mkdir()
    conf = dict(nnet="sse@time_tcn", nnet_conf=TCN_CONF, task="sse@sisnr",
                task_conf={"num_spks": 2, "permute": True}, data_conf={},
                trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf, indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "epoch": 0}, fd)
    return cpt


def separate_phase(root: Path, cpt: Path, mixes, shapes, card):
    """SEP_UTTS mixtures through aps_tpu_torch.cmd.separate in batches of
    SEP_BATCH, the launch counts reset just before and read just after;
    every K5 call must see the shape the kernel was checked at.
    -> the launch counts of the run."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.sse.bss import tcn as tcn_mod
    S, T = shapes
    sep_dir = root / "sep"
    argv = [str(root / "mix.scp"), str(sep_dir), "--checkpoint", str(cpt),
            "--sr", str(SEP_SR), "--batch-size", str(SEP_BATCH)]
    seen = []
    launch = tcn_mod.tcn_block_fused

    def recorded(x, *args, dilation, causal):
        seen.append((tuple(x.shape), x.dtype, x.device.type, dilation))
        return launch(x, *args, dilation=dilation, causal=causal)

    tcn_mod.tcn_block_fused = recorded
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = separate.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    tcn_mod.tcn_block_fused = launch
    batches = SEP_UTTS // SEP_BATCH
    if stats["utts"] != SEP_UTTS or len(stats["batch_secs"]) != batches:
        fail(f"separate: {stats['utts']} utterances in "
             f"{len(stats['batch_secs'])} batches")
    want = {name: 0 for name in launches}
    want["tcn_block_fused"] = TCN_BLOCKS * batches
    if launches != want:
        fail(f"separate launches {launches}, expected {want}")
    dilations = [2**n for n in range(TCN_CONF["X"])] * TCN_CONF["R"]
    expect = [((SEP_BATCH, T, TCN_CONF["B"]), torch.float32, "cuda", d)
              for d in dilations] * batches
    if seen != expect:
        fail(f"the TCN block ran at {sorted(set(seen))}; the kernel was "
             f"checked at {SEP_BATCH} x {T} x {TCN_CONF['B']}")
    peak = 0.0
    for spk in ("spk1", "spk2"):
        lines = (sep_dir / f"{spk}.scp").read_text().splitlines()
        if sorted(ln.split()[0] for ln in lines) != sorted(mixes):
            fail(f"separate: {spk}.scp lists {len(lines)} utterances")
        for key, mix in mixes.items():
            sr, pcm = wavfile.read(str(sep_dir / spk / f"{key}.wav"))
            if sr != SEP_SR or pcm.shape != mix.shape or \
                    not np.isfinite(pcm).all():
                fail(f"separate: {spk}/{key}.wav has sr {sr}, shape "
                     f"{pcm.shape}")
            peak = max(peak, float(np.abs(pcm).max()))
    if not peak > 0:
        fail("separate wrote silence")
    secs = stats["batch_secs"]
    audio = SEP_BATCH * SEP_SECS
    print(f"separate: {SEP_UTTS} mixtures x {SEP_SECS} s at {SEP_SR} Hz "
          f"through aps_tpu_torch.cmd.separate, batches of {SEP_BATCH} padded "
          f"to {S} samples (T = {T}): first batch {secs[0]:.4f} s = "
          f"{audio / secs[0]:.2f} audio-s/s (the model's first forward, in a "
          f"process whose CUDA context and libraries are already up), "
          f"second {secs[1]:.4f} s = {audio / secs[1]:.2f} audio-s/s (host "
          f"clock around a synchronised batch, transfers both ways "
          f"included), launches {launches} ({card})", flush=True)
    return launches


def separation_check(cpt: Path, mixes, dev, shapes, card):
    """Two mixtures padded as the command pads them: the folded forward on
    the card (K5) against the same fold on the CPU (the block's plain
    version) and against the module itself on the card; also times a warm
    batch of SEP_BATCH through both forwards on the card."""
    import numpy as np
    import torch

    from aps_tpu_torch.eval.wrapper import load_checkpoint
    S, _ = shapes
    nnet = load_checkpoint(str(cpt))["nnet"]
    batch = np.zeros((2, S), dtype=np.float32)
    for n, key in enumerate(sorted(mixes)[:2]):
        batch[n, :len(mixes[key])] = mixes[key]
    outs = {}
    with torch.inference_mode():
        for where in ("cpu", dev):
            model = nnet.to(where)
            x = torch.from_numpy(batch).to(where)
            outs[str(where)] = [s.cpu() for s in model.make_fused_eval()(x)]
            if where == dev:
                outs["module"] = [s.cpu() for s in model(x)]
                big = torch.from_numpy(np.tile(batch, (SEP_BATCH // 2, 1)))
                big = big.to(dev)
                fused = model.make_fused_eval()
                warm = {"folded": time_ms(lambda: fused(big), iters=5,
                                          warmup=1),
                        "module": time_ms(lambda: model(big), iters=5,
                                          warmup=1)}
    scale = max(s.abs().max().item() for s in outs["cpu"])
    errs = {}
    for name, other in (("card vs CPU", "cpu"), ("folded vs module",
                                                 "module")):
        errs[name] = max((a - b).abs().max().item()
                         for a, b in zip(outs[str(dev)], outs[other]))
        if not (scale > 0 and errs[name] <= TOL_SEP_REL * scale):
            fail(f"separation {name}: max abs err {errs[name]} over "
                 f"{TOL_SEP_REL} of the largest sample {scale}")
    print(f"separation on 2 mixtures: card vs CPU max abs err "
          f"{errs['card vs CPU']:.3e}, folded forward vs module on the card "
          f"{errs['folded vs module']:.3e}, largest sample {scale:.3f}; a "
          f"warm forward of {SEP_BATCH} x {S} samples on the card: folded "
          f"{warm['folded']:.3f} ms, module {warm['module']:.3f} ms "
          f"({card})", flush=True)


def write_sep_corpus(root: Path, gen) -> Path:
    """root/train_ss: SEP_TRAIN_UTTS mixtures with their sources and the
    train.yaml of the full-width sse@time_tcn under sse@sisnr."""
    train = root / "train_ss"
    train.mkdir()
    write_mixtures(train, SEP_TRAIN_UTTS, gen)
    data = {"mix_scp": str(train / "mix.scp"),
            "ref_scp": f"{train / 'spk1.scp'},{train / 'spk2.scp'}"}
    conf = dict(
        nnet="sse@time_tcn", nnet_conf=TCN_CONF, task="sse@sisnr",
        task_conf={"num_spks": 2, "permute": True},
        data_conf={"fmt": "se@chunk",
                   "loader": {"chunk_size": SEP_SECS * SEP_SR, "sr": SEP_SR},
                   "train": data, "valid": data},
        trainer_conf={"optimizer": "adam",
                      "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-5},
                      "lr_scheduler": "reduce_lr",
                      "lr_scheduler_kwargs": {"min_lr": 1e-8, "patience": 1,
                                              "factor": 0.5},
                      "clip_gradient": 10, "no_impr": 6,
                      "report_metrics": ["loss"]})
    (train / "train.yaml").write_text(json.dumps(conf, indent=2))
    return train


def train_ss_phase(train: Path, dev, card):
    """SEP_TRAIN_EPOCHS one-step epochs through aps_tpu_torch.cmd.train_ss
    with the launch counts read over the whole run (training and validation
    reach no hand-written kernel: all 0), then TIMED_STEPS more steps of the
    same trainer on the same batch. -> (the batch, launches of the run)."""
    import torch

    from aps_tpu_torch.cmd import train_ss
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.libs import aps_dataloader
    from aps_tpu_torch.ops import build
    cpt = train / "cpt"
    argv = ["--conf", str(train / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", str(SEP_TRAIN_UTTS), "--epochs",
            str(SEP_TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_ss.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if trainer.device.type != "cuda" or trainer.cur_step != SEP_TRAIN_EPOCHS:
        fail(f"train_ss took {trainer.cur_step} steps on {trainer.device}")
    if any(launches.values()):
        fail(f"train_ss launches {launches}, expected none")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    if len(losses) != SEP_TRAIN_EPOCHS or len(valid) != SEP_TRAIN_EPOCHS + 1:
        fail(f"trainer.log reports {len(losses)} training and {len(valid)} "
             "validation epochs")
    if "weight_decay have no effect" not in (cpt / "trainer.log").read_text():
        fail("trainer.log does not say that weight_decay has no effect")
    for name in ("best.ckpt", "last.ckpt", "train.yaml"):
        if not (cpt / name).is_file():
            fail(f"train_ss wrote no {name}")

    data_conf = load_ss_conf(str(train / "train.yaml"))["data_conf"]
    batches = list(aps_dataloader(fmt=data_conf["fmt"], train=False,
                                  max_batch_size=SEP_TRAIN_UTTS,
                                  **data_conf["loader"],
                                  **data_conf["valid"]))
    shape = (SEP_TRAIN_UTTS, SEP_SECS * SEP_SR)
    if len(batches) != 1 or batches[0]["mix"].shape != shape:
        fail(f"expected one batch of {shape}, got "
             f"{[b['mix'].shape for b in batches]}")
    egs = batches[0]
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for step in range(TIMED_STEPS):
        build.reset_launches()
        torch.cuda.synchronize()
        beg = time.perf_counter()
        done = trainer.train_one_step(egs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - beg)
        if not done:
            fail(f"timed step {step} was skipped (non-finite loss or norm)")
        if any(build.LAUNCHES.values()):
            fail(f"timed step {step} launches {dict(build.LAUNCHES)}, "
                 "expected none")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses + valid)):
        fail(f"non-finite loss: training {losses}, validation {valid}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the repeated batch: {losses}")
    print(f"train_ss: {SEP_TRAIN_UTTS} x {SEP_SECS} s at {SEP_SR} Hz, "
          f"sse@sisnr through train_ss: {SEP_TRAIN_EPOCHS} one-step epochs, "
          f"then {TIMED_STEPS} timed steps, no kernel launches; training "
          f"losses {', '.join(f'{v:.4f}' for v in losses)}; validation "
          f"losses {', '.join(f'{v:.4f}' for v in valid)}", flush=True)
    print(f"train_ss step: median {statistics.median(secs):.4f} s of "
          f"{', '.join(f'{v:.4f}' for v in secs)} s (host clock around a "
          f"synchronised step), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    return egs, launches


# the first layer, the first and the last TCN block, the mask layer
SEP_GRADS = ("encoder.weight", "tcn.block_0_0.linear_in.dense.weight",
             f"tcn.block_{TCN_CONF['R'] - 1}_{TCN_CONF['X'] - 1}.conv.weight",
             "mask_out.weight")


def sep_step_check(egs, dev):
    """One training-mode pass of sse@sisnr over the first SEP_CHECK_UTTS
    mixtures of the batch, same seeded weights, held by step_pass_check
    with the card's float64 pass as the referee (see TOL_SEP_GRAD_*)."""
    import torch

    from aps_tpu_torch.libs import aps_sse_nnet, aps_task
    torch.manual_seed(SEED)
    task = aps_task("sse@sisnr", aps_sse_nnet("sse@time_tcn")(**TCN_CONF),
                    num_spks=2, permute=True)
    return step_pass_check(task, egs, dev, SEP_GRADS, SEP_CHECK_UTTS,
                           referee=True)


# the float32 STFT and a first layer's gradient (step_pass_check's
# stft_first). A first layer on the enh transform's features carries the
# STFT's float32 rounding through a log, where a quiet bin's relative error
# can reach order 1; the card's cuFFT and the CPU's pocketfft round
# differently, and the CPU's own distance from float64 changes by 100x from
# machine to machine, so it cannot set the card's bound there. The
# rounding is bounded where it happens: a framed DFT of N points in
# float32 (the window's product, then the FFT's log2 N stages, each of
# which rounds its sums and reads rounded twiddles) lies, by Higham's
# bound for the Cooley-Tukey FFT (Accuracy and Stability of Numerical
# Algorithms, 2nd ed., Thm. 24.2), frame by frame within
#     ||X32_t - X_t||_2 <= (log2(N) * eta + 1) * u * ||X_t||_2,
#     eta = mu + 4 (sqrt 2 + mu) ~ 6.7 for twiddles good to mu = u,
# u = 2^-24, ||X_t||_2 the whole spectrum's (the onesided bins counted
# twice but for DC and Nyquist), the 1 for the window's product. Its
# effect on the gradient is then computed, not bounded bin by bin at its
# worst: one more float64 pass ("stft32_64") reads the card's own float32
# spectrum, each frame held to the bound above, in place of its float64
# STFT (a teacher's too). A float32 pass on the card that reads that
# spectrum (the card's, and each witness that keeps the float32 STFT) must
# lie within TOL_STEP_GRAD, §2's bound for the network's own rounding, of
# that pass on the first layer; a witness with the STFT in float64 (its
# `stft64` attribute) within TOL_STEP_GRAD of the float64 pass. A missing
# term in the network moves the gradient by order 1 from either.
STFT_ETA = 6.7
F32_UNIT = 2.0**-24


def stft_rounding(x32, x64) -> float:
    """The largest ratio, over the frames of STFTs N x (C) x F x T, of
    ||x32_t - x64_t||_2 to the bound on it in the comment above; fails
    past 1."""
    import torch
    weight = torch.full_like(x64.real[..., :1, :], 2.0).expand(
        x64.shape).clone()
    weight[..., 0, :] = weight[..., -1, :] = 1.0
    norm = lambda x: (weight * x.abs()**2).sum(-2).sqrt()  # noqa: E731
    N = 2 * (x64.shape[-2] - 1)
    bound = (math.log2(N) * STFT_ETA + 1) * F32_UNIT * norm(x64)
    err = norm(x32 - x64)
    if not bool((err <= bound).all()):
        fail(f"the float32 STFT lies {(err - bound).max().item()} over "
             "Higham's bound in a frame")
    return (err / bound.clamp(min=1e-300)).max().item()


def stft32_of(dev, ratios: list):
    """Patch for a float64 model: every enh transform's encode (the
    network's and a teacher's) returns the card's float32 STFT of its
    input, cast to complex128, after holding each frame to Higham's bound
    on the float64 STFT (the ratio goes to `ratios`)."""
    import torch

    def patch(task) -> None:
        for nnet in (task.nnet, getattr(task, "teacher_nnet", None)):
            if nnet is None:
                continue
            encode = nnet.enh_transform.encode

            def encode32(wav, wav_len=None, encode=encode):
                x64, frames = encode(wav, wav_len)
                x32 = encode(wav.to(dev, torch.float32), wav_len)[0].to(
                    x64.device, x64.dtype)
                ratios.append(stft_rounding(x32, x64))
                return x32, frames
            nnet.enh_transform.encode = encode32
    return patch


CPU_DRAW_SEED = 2024


def rounding_moved(batch: dict, seed: int) -> dict:
    """The batch with each float tensor (also in lists) times 1 +
    F32_UNIT xi, xi = +-1 from a generator seeded `seed`."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def move(val):
        if isinstance(val, list):
            return [move(v) for v in val]
        if not val.is_floating_point():
            return val
        xi = torch.randint(0, 2, val.shape, generator=gen).to(val) * 2 - 1
        return val * (1 + F32_UNIT * xi)
    return {k: move(v) for k, v in batch.items()}


def step_pass_check(task, egs, dev, grads, utts: int, referee: bool,
                    referee_on=None, witnesses=None, launched=None,
                    stft_first=None, cpu_draws: int = 0,
                    referee_patch=None):
    """One training-mode pass of a `task` (its model without dropout) over
    the first `utts` utterances or mixtures of the batch, float32 on the
    CPU and on the card (TF32 off, the flags read inside the pass), and
    with `referee` float64 on the card. The losses must agree within
    TOL_STEP_LOSS; each gradient named in `grads` within TOL_STEP_GRAD of
    its largest entry of the CPU's, or with `referee`: at random weights
    the gradient of a layer in front of a batch norm is a small difference
    of large terms, so the CPU's float32 gradient must be within
    TOL_SEP_GRAD_REFEREE of the float64 one and the card's within
    TOL_STEP_GRAD plus TOL_SEP_GRAD_NOISE times the CPU's distance. The
    float64 pass runs on referee_on ("cpu" for a model whose kernels take
    float32 only; default the card), on the copy after referee_patch(copy)
    when that is given (dense_attention: the float64 pass on the card,
    which K3 does not take). witnesses (with referee): {name: fn},
    each one more float32 pass on the card of the copy after fn(copy),
    held as the card's is, to tell what part of the card's distance a part
    of the model accounts for. launched: a dict that gets each pass's
    kernel launches. stft_first (with referee): the name of the first
    layer's weight, a layer on the enh transform's features; its gradient
    is held by the rule of stft32_of's comment instead of by the CPU's
    distance, against one more float64 pass on the card's float32 STFT.
    cpu_draws (with referee): so many more float32 passes on the CPU,
    run at every call, each on the batch's float inputs moved by one
    float32 rounding (times 1 + 2^-24 xi, xi = +-1 drawn from
    CPU_DRAW_SEED + i): each is another realization of the float32 pass's
    rounding. Through an ill-conditioned part a float32 pass on either
    device lands anywhere in a wide spread (CHIME4_PASS_DRAWS' comment),
    which one pass times TOL_SEP_GRAD_NOISE need not cover; so the card's
    bound is TOL_STEP_GRAD plus the larger of TOL_SEP_GRAD_NOISE times the
    first CPU pass's distance and the largest distance of the draws (with
    no factor). That bound must still fail a missing term: the card's
    gradient with TOL_SEP_GRAD_REFEREE of its largest entry planted
    against its own largest error is held by it too, and must be over it.
    -> (loss card, loss CPU, {name: err, or with referee (card, CPU, each
    witness[, with cpu_draws the draws' largest, the bound, the planted
    error])})."""
    import torch

    from aps_tpu_torch.ops import build
    from aps_tpu_torch.trainer.dp import to_device

    def cut(val):
        return [cut(v) for v in val] if isinstance(val, list) else val[:utts]

    def cast(val, dtype):
        if isinstance(val, list):
            return [cast(v, dtype) for v in val]
        return val.to(dtype) if val.is_floating_point() else val

    # the batch's first utts entries of every tensor (a separation batch's
    # mix and ref, or an ASR batch's src_pad, src_len, tgt_pad, tgt_len)
    tensors = {k: cut(v) for k, v in egs.items() if not k.startswith("#")}
    witnesses = witnesses or {}
    if witnesses and not referee:
        fail("step_pass_check: witnesses need the float64 referee")
    sides = [("cpu32", "cpu", torch.float32, None),
             ("card32", dev, torch.float32, None)]
    sides += [(name, dev, torch.float32, fn) for name, fn in witnesses.items()]
    ratios = []
    if referee:
        sides.append(("card64", referee_on or dev, torch.float64,
                      referee_patch))
    if referee and stft_first is not None:
        sides.append(("stft32_64", referee_on or dev, torch.float64,
                      stft32_of(dev, ratios)))
    outs, seen = {}, []

    def run(name, where, dtype, witness):
        side = copy.deepcopy(task).to(where, dtype).train()
        draw = witness if isinstance(witness, int) else None
        if callable(witness):
            witness(side)
        before = dict(build.LAUNCHES)
        hook = side.nnet.register_forward_pre_hook(
            lambda *_: seen.append(tf32_flags()))
        batch = {k: cast(v, dtype) for k, v in
                 to_device(tensors, torch.device(where)).items()}
        if draw is not None:
            batch = rounding_moved(batch, CPU_DRAW_SEED + draw)
        stats = side(batch)
        stats["loss"].backward()
        hook.remove()
        if launched is not None:
            launched[name] = {k: n - before[k] for k, n in
                              build.LAUNCHES.items() if n != before[k]}
        params = dict(side.nnet.named_parameters())
        outs[name] = (stats["loss"].item(),
                      {k: params[k].grad.double().cpu() for k in grads})

    for args in sides:
        run(*args)
    for i in range(cpu_draws if referee else 0):
        run(f"cpu32_{i}", "cpu", torch.float32, i)
    if set(seen) != {(False, False)}:
        fail(f"the float32 passes ran with TF32 flags {set(seen)}")
    loss_c = outs["cpu32"][0]
    for side in outs:
        loss = outs[side][0]
        if not (math.isfinite(loss) and
                abs(loss - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
            fail(f"{type(task).__name__} loss: {side} {loss} vs CPU "
                 f"{loss_c}: outside {TOL_STEP_LOSS} relative")
    errs = {}
    for key in grads:
        want = outs["card64" if referee else "cpu32"][1][key]
        scale = want.abs().max().item()

        def rel(n, ref="card64" if referee else "cpu32"):
            return (outs[n][1][key] -
                    outs[ref][1][key]).abs().max().item() / scale
        if not referee:
            errs[key] = rel("card32")
            if not (scale > 0 and errs[key] <= TOL_STEP_GRAD):
                fail(f"gradient of {key}: card vs CPU {errs[key]} of the "
                     f"largest entry {scale}, over {TOL_STEP_GRAD}")
            continue
        noise_cpu, noise_card = rel("cpu32"), rel("card32")
        noise_draws = max([rel(n) for n in outs if n.startswith("cpu32_")],
                          default=0.0)
        errs[key] = (noise_card, noise_cpu) + tuple(map(rel, witnesses))
        if not (scale > 0 and max(noise_cpu, noise_draws) <=
                TOL_SEP_GRAD_REFEREE):
            fail(f"gradient of {key}: the CPU's float32 passes are "
                 f"{noise_cpu} and up to {noise_draws} of the largest entry "
                 f"{scale} from the card's float64 pass, over "
                 f"{TOL_SEP_GRAD_REFEREE}")
        if key == stft_first:
            held = {side: rel(side, "card64" if getattr(
                witnesses.get(side), "stft64", False) else "stft32_64")
                for side in ("card32",) + tuple(witnesses)}
            print(f"{key}: each float32 pass from the float64 pass on the "
                  "same STFT (the card's float32 one, each frame within "
                  f"{max(ratios):.3e} of Higham's bound, or float64) "
                  + ", ".join(f"{k} {v:.3e}" for k, v in held.items())
                  + f"; the float32 STFT's share {rel('stft32_64'):.3e}; "
                  f"card {noise_card:.3e}, CPU {noise_cpu:.3e} from float64",
                  flush=True)
            for side, err in held.items():
                if not err <= TOL_STEP_GRAD:
                    fail(f"gradient of {key}: the card's float32 pass "
                         f"({side}) is {err} of the largest entry from the "
                         "float64 pass on the same STFT, over "
                         f"{TOL_STEP_GRAD}")
            continue
        bound = TOL_STEP_GRAD + max(TOL_SEP_GRAD_NOISE * noise_cpu,
                                    noise_draws)
        for side in ("card32",) + tuple(witnesses):
            if not rel(side) <= bound:
                fail(f"gradient of {key}: the card's float32 pass "
                     f"({side}) is {rel(side)} of the largest entry from the "
                     f"float64 pass, over {bound} (the CPU's float32 pass: "
                     f"{noise_cpu}, its draws up to {noise_draws})")
        if cpu_draws:
            diff = (outs["card32"][1][key] - want).flatten()
            at = int(diff.abs().argmax())
            planted = diff.clone()
            planted[at] -= (1.0 if diff[at] >= 0 else -1.0) * \
                TOL_SEP_GRAD_REFEREE * scale
            missing = planted.abs().max().item() / scale
            errs[key] += (noise_draws, bound, missing)
            if not missing > bound:
                fail(f"gradient of {key}: a missing term of "
                     f"{TOL_SEP_GRAD_REFEREE} of the largest entry, planted "
                     f"in the card's gradient, is {missing} from the float64 "
                     f"pass, within the bound {bound}: the rule cannot "
                     "catch it")
    return outs["card32"][0], loss_c, errs


# the frequency-domain slice: examples/sse/wham/run.sh stages 2 to 4 with
# recipe 1b as written (sse@base_rnn, a 4 x 600 BLSTM on the enh
# transform's spectrogram-log-cmvn, sse@wa L1, matmul_precision bfloat16),
# then sse@freq_tcn at its default widths. No hand-written kernel is on
# this path: the STFT is torch.fft, the BLSTM cuDNN's, the TCN the module
WHAM_YAML = "examples/sse/wham/conf/1b_bss_c_16k_max.yaml"
WHAM_SR = 16000
WHAM_SECS = 4  # the recipe's chunk_size of 64000 samples
WHAM_BATCH = 32  # run.sh's --batch-size
WHAM_TRAIN_EPOCHS = 2  # one step each: the corpus is one batch
WHAM_TIMED_STEPS = 3
WHAM_CHECK_UTTS = 4  # of the batch, in the card-vs-CPU passes
WHAM_SEP_UTTS = 16
WHAM_SEP_BATCH = 8
WHAM_FREQ_UTTS = 2  # separated with --mode freq
WHAM_NAMES = ("mix", "s1", "s2")
# the mask estimator's gradients held card vs CPU: the first layer's
# input weights, the last layer's reverse recurrence, the mask layer
WHAM_GRADS = ("encoder.layer_0.cells.weight_ih_l0",
              "encoder.layer_3.cells.weight_hh_l0_reverse",
              "mask_out.weight")
FREQ_TCN_GRADS = ("proj.weight", "tcn.block_0_0.linear_in.dense.weight",
                  "tcn.block_2_5.conv.weight", "mask_out.weight")
# the STFT card vs CPU: cuFFT against pocketfft, float32 sums of 512 terms
#   in another order, relative to the largest entry (the parity tests'
#   bound against aps_tpu); the features after a log and cmvn: O(1)
TOL_STFT, TOL_FEATS = 1e-5, 1e-4


def wham_conf(data: Path) -> dict:
    """WHAM_YAML as written, its data sections pointed at data/."""
    from aps_tpu_torch.conf import load_ss_conf
    conf = load_ss_conf(str(REPO / WHAM_YAML))
    scps = {"mix_scp": str(data / "mix.scp"),
            "ref_scp": f"{data / 's1.scp'},{data / 's2.scp'}"}
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = scps
    return conf


def check_stft(egs, enh_conf, dev, card):
    """forward_stft, inverse_stft and the enh features on the recipe's
    batch (WHAM_BATCH x 64000 samples), card (cuFFT) against the CPU; the
    centred round trip's error away from the ends; the times of both."""
    import torch

    from aps_tpu_torch.libs import aps_transform
    from aps_tpu_torch.transform.utils import forward_stft, inverse_stft
    enh = aps_transform("enh")(**enh_conf)
    ctx = enh.ctx()
    kw = dict(window=ctx.window, center=ctx.center)
    wav = torch.from_numpy(egs["mix"])
    out = {}
    for where in ("cpu", dev):
        x = wav.to(where)
        stft = forward_stft(x, ctx.frame_len, ctx.frame_hop, **kw)
        out[str(where)] = (stft, inverse_stft(stft, ctx.frame_len,
                                              ctx.frame_hop, **kw),
                           enh(stft))
    torch.cuda.synchronize()
    # the features after the same STFT (the card's, on both): the log of a
    # bin at the 16-bit floor, 1e-6 of the largest, turns the transform's
    # 1e-5 of the largest into percents, so each device's own STFT is held
    # above and its features are printed, not held
    same = enh(out[str(dev)][0].cpu())
    errs = {"features (own STFT)":
            (out[str(dev)][2].cpu() - out["cpu"][2]).abs().max().item()}
    for i, name in enumerate(("stft", "istft", "features")):
        got, want = out[str(dev)][i].cpu(), out["cpu"][i]
        if name == "features":
            want = same
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[name] = err
        bound = TOL_FEATS if name == "features" else TOL_STFT * scale
        if not (scale > 0 and err <= bound):
            fail(f"{name} card vs CPU: max abs err {err} over {bound}")
    back = out[str(dev)][1].cpu()
    L = ctx.frame_len
    inner = (back[:, L:-L] - wav[:, L:back.shape[-1] - L]).abs().max()
    if back.shape != wav.shape or not inner <= TOL_STFT:
        fail(f"STFT round trip: shape {tuple(back.shape)}, interior error "
             f"{float(inner)}")
    x = wav.to(dev)
    stft = out[str(dev)][0]
    ms = {"stft": time_ms(lambda: forward_stft(x, ctx.frame_len,
                                               ctx.frame_hop, **kw)),
          "istft": time_ms(lambda: inverse_stft(stft, ctx.frame_len,
                                                ctx.frame_hop, **kw)),
          "features": time_ms(lambda: enh(stft))}
    print(f"enh transform ({ctx.frame_len}/{ctx.frame_hop} {ctx.window}, "
          f"center) on {tuple(wav.shape)} samples, card vs CPU: STFT "
          f"{errs['stft']:.3e}, iSTFT {errs['istft']:.3e}, features "
          f"{errs['features']:.3e} of the same STFT "
          f"({errs['features (own STFT)']:.3e} of each one's own) (max abs "
          f"err); round trip on the card "
          f"{float(inner):.3e} away from the ends; device ms: STFT "
          f"{ms['stft']:.4f}, iSTFT {ms['istft']:.4f}, features "
          f"{ms['features']:.4f} ({card})", flush=True)
    return errs, ms


def top_kernels(prof, count: int = 6) -> str:
    """The `count` kernels with the most device time, with their ms."""
    from aps_tpu_torch.cmd.profile_decode import on_device
    total = {}
    for evt in prof.events():
        if on_device(evt):
            total[evt.name] = total.get(evt.name, 0.0) + \
                evt.self_device_time_total / 1e3
    top = sorted(total.items(), key=lambda kv: -kv[1])[:count]
    return "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top)


def rnn_share(prof, device_ms: float):
    """Shares of the device time in cuDNN's recurrences (RNN or LSTM in
    the kernel's name), cuBLAS's products and cuFFT's transforms."""
    from aps_tpu_torch.cmd.profile_decode import on_device
    rnn = gemm = fft = 0.0
    for evt in prof.events():
        if not on_device(evt):
            continue
        name = evt.name.lower()
        ms = evt.self_device_time_total / 1e3
        if "rnn" in name or "lstm" in name or "persist" in name:
            rnn += ms
        elif "fft" in name or "radix" in name:
            fft += ms
        elif "gemm" in name or "nvjet" in name:
            gemm += ms
    return rnn / device_ms, gemm / device_ms, fft / device_ms


def wham_train_phase(root: Path, gen, dev, card):
    """WHAM_YAML as written through aps_tpu_torch.cmd.train_ss on
    WHAM_BATCH seeded mixtures (one batch of the recipe's 32 x 64000
    samples): WHAM_TRAIN_EPOCHS one-step epochs with the launch counts read
    over the run (all 0), then WHAM_TIMED_STEPS timed steps on the same
    batch and one traced. -> (cpt, the batch, launches of the run)."""
    import torch

    from aps_tpu_torch.cmd import train_ss
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.libs import aps_dataloader
    from aps_tpu_torch.ops import build
    data = root / "data"
    data.mkdir()
    write_mixtures(data, WHAM_BATCH, gen, WHAM_SR, WHAM_SECS, WHAM_NAMES)
    conf = wham_conf(data)
    if conf["data_conf"]["loader"]["chunk_size"] != WHAM_SECS * WHAM_SR:
        fail(f"{WHAM_YAML}: chunk_size {conf['data_conf']['loader']}")
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    cpt = root / "cpt"
    argv = ["--conf", str(root / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", str(WHAM_BATCH), "--epochs",
            str(WHAM_TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_ss.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if trainer.device.type != "cuda" or \
            trainer.cur_step != WHAM_TRAIN_EPOCHS:
        fail(f"train_ss took {trainer.cur_step} steps on {trainer.device}")
    if any(launches.values()):
        fail(f"train_ss ({WHAM_YAML}) launches {launches}, expected none")
    if trainer.matmul_precision != "bfloat16":
        fail(f"the recipe trains at {trainer.matmul_precision}")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    batches = list(aps_dataloader(fmt="se@chunk", train=False,
                                  max_batch_size=WHAM_BATCH,
                                  **conf["data_conf"]["loader"],
                                  **conf["data_conf"]["valid"]))
    shape = (WHAM_BATCH, WHAM_SECS * WHAM_SR)
    if len(batches) != 1 or batches[0]["mix"].shape != shape:
        fail(f"expected one batch of {shape}, got "
             f"{[b['mix'].shape for b in batches]}")
    egs = batches[0]
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for step in range(WHAM_TIMED_STEPS):
        done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        if not done:
            fail(f"timed step {step} was skipped (non-finite loss or norm)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, wall, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    rnn, gemm, fft = rnn_share(prof, device_ms)
    if any(build.LAUNCHES.values()):
        fail(f"timed steps launch {dict(build.LAUNCHES)}, expected none")
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the repeated batch: {losses}")
    print(f"train_ss {WHAM_YAML} as written (4 x 600 BLSTM, sse@wa L1, "
          f"TF32): {WHAM_BATCH} x {WHAM_SECS} s at {WHAM_SR} Hz, "
          f"{WHAM_TRAIN_EPOCHS} one-step epochs then {WHAM_TIMED_STEPS + 1} "
          f"steps on the same batch, no kernel launches; losses "
          f"{', '.join(f'{v:.2f}' for v in losses)}", flush=True)
    print(f"wham 1b step: device {device_ms:.3f} ms (traced; cuDNN's "
          f"recurrences {rnn:.3f}, cuBLAS {gemm:.3f}, cuFFT {fft:.3f} of "
          f"it), host {statistics.median(secs):.4f} s median of "
          f"{', '.join(f'{v:.4f}' for v in secs)} (traced {wall:.4f} s, "
          f"{host_launches} launches), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    print(f"wham 1b step, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    return cpt, egs, launches, {"device_ms": device_ms, "rnn_share": rnn,
                                "host_s": statistics.median(secs),
                                "peak_gib": peak}


def wham_task(conf: dict):
    """The recipe's task around its model, dropout off, seeded weights."""
    import torch

    from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_transform
    torch.manual_seed(SEED)
    nnet = aps_sse_nnet(conf["nnet"])(
        enh_transform=aps_transform("enh")(**conf["enh_transform"]),
        **dict(conf["nnet_conf"], dropout=0.0))
    return aps_task(conf["task"], nnet, **conf["task_conf"])


def _wav_dir(sep: Path, keys, length: int):
    """The separated wavs of every key (spk1, spk2), finite and of the
    input's length, and both scps."""
    import numpy as np
    from scipy.io import wavfile
    out = {}
    for spk in ("spk1", "spk2"):
        lines = (sep / f"{spk}.scp").read_text().splitlines()
        if sorted(ln.split()[0] for ln in lines) != sorted(keys):
            fail(f"separate: {spk}.scp of {sep.name} lists {len(lines)}")
        for key in keys:
            sr, pcm = wavfile.read(str(sep / spk / f"{key}.wav"))
            if sr != WHAM_SR or pcm.shape != (length,) or \
                    not np.isfinite(pcm).all():
                fail(f"separate: {sep.name}/{spk}/{key}.wav has sr {sr}, "
                     f"shape {pcm.shape}")
            out[(spk, key)] = pcm
    return out


def wham_separate_phase(root: Path, cpt: Path, gen, dev, card):
    """run.sh stage 3: WHAM_SEP_UTTS seeded mixtures of WHAM_SECS through
    aps_tpu_torch.cmd.separate with the trained checkpoint, batch 1 (as
    run.sh) and in batches of WHAM_SEP_BATCH, and WHAM_FREQ_UTTS of them
    with --mode freq, the launch counts reset before and read after each
    run (all 0); card vs CPU on two mixtures, batched, batch 1 and the
    masks; one batch traced. -> (sep dir of batch 1, launches)."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    data = root / "tt"
    data.mkdir()
    mixes = write_mixtures(data, WHAM_SEP_UTTS, gen, WHAM_SR, WHAM_SECS,
                           WHAM_NAMES)
    keys = sorted(mixes)
    lines = (data / "mix.scp").read_text().splitlines()
    (data / "freq.scp").write_text("\n".join(lines[:WHAM_FREQ_UTTS]) + "\n")
    runs = {"single": ("mix", []),
            "batched": ("mix", ["--batch-size", str(WHAM_SEP_BATCH)]),
            "freq": ("freq", ["--mode", "freq"])}
    stats, launches = {}, {}
    for name, (scp, extra) in runs.items():
        build.reset_launches()
        with contextlib.redirect_stdout(sys.stderr):
            stats[name] = separate.main(
                [str(data / f"{scp}.scp"), str(root / name), "--checkpoint",
                 str(cpt), "--sr", str(WHAM_SR)] + extra)
        torch.cuda.synchronize()
        for kernel, count in build.LAUNCHES.items():
            launches[kernel] = launches.get(kernel, 0) + count
    if any(launches.values()):
        fail(f"separate launches {launches}, expected none")
    length = WHAM_SECS * WHAM_SR
    single = _wav_dir(root / "single", keys, length)
    batched = _wav_dir(root / "batched", keys, length)
    if not max(float(np.abs(v).max()) for v in single.values()) > 0:
        fail("separate wrote silence")
    masks = [np.load(root / "freq" / f"{k}.npy")
             for k in keys[:WHAM_FREQ_UTTS]]
    T = length // 256 + 1
    if any(m.shape != (2, 257, T) or not np.isfinite(m).all()
           for m in masks):
        fail(f"--mode freq wrote masks of {[m.shape for m in masks]}")
    # card vs CPU on two mixtures: batched (the same padding), batch 1 and
    # the masks
    seps = {where: separate.Separator(str(cpt), device=where)
            for where in ("cpu", "cuda")}
    two = [mixes[k] for k in keys[:2]]
    errs, scale = {}, {}
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: (s.run_batch(two), s.run(two[0]),
                    s.run(two[0], mode="freq")) for w, s in seps.items()}
        big = [mixes[k] for k in keys[:WHAM_SEP_BATCH]]
        seps["cuda"].run_batch(big)
        batch_ms, batch_wall, batch_launches, prof = profile(
            lambda: seps["cuda"].run_batch(big))
    for i, name in enumerate(("batched", "batch 1", "masks")):
        got = np.concatenate([np.ravel(a) for a in _flat(outs["cuda"][i])])
        want = np.concatenate([np.ravel(a) for a in _flat(outs["cpu"][i])])
        scale[name] = float(np.abs(want).max())
        errs[name] = float(np.abs(got - want).max())
        if not (scale[name] > 0 and errs[name] <= TOL_SEP_REL * scale[name]):
            fail(f"separation {name} card vs CPU: max abs err {errs[name]} "
                 f"over {TOL_SEP_REL} of the largest entry {scale[name]}")
    rnn, gemm, fft = rnn_share(prof, batch_ms)
    audio = {n: stats[n]["audio_secs"] for n in ("single", "batched")}
    rate = {n: audio[n] / stats[n]["sep_secs"] for n in audio}
    warm = {n: WHAM_SECS * (len(stats[n]["batch_secs"]) - 1) * (
        WHAM_SEP_BATCH if n == "batched" else 1) / sum(
        stats[n]["batch_secs"][1:]) for n in audio}
    print(f"separate (run.sh stage 3) with the trained 1b checkpoint: "
          f"{WHAM_SEP_UTTS} x {WHAM_SECS} s at {WHAM_SR} Hz, batch 1 "
          f"{rate['single']:.2f} audio-s/s ({warm['single']:.2f} without "
          f"the first), batches of {WHAM_SEP_BATCH} {rate['batched']:.2f} "
          f"audio-s/s ({warm['batched']:.2f} without the first) (host "
          f"clock around synchronised forwards, transfers included), "
          f"--mode freq masks {masks[0].shape}; no kernel launches; a "
          f"batch of {WHAM_SEP_BATCH} traced: device {batch_ms:.3f} ms "
          f"(cuDNN's recurrences {rnn:.3f}, cuFFT {fft:.3f}), host "
          f"{batch_wall:.4f} s, {batch_launches} launches ({card})",
          flush=True)
    print(f"separation batch, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    print("separation card vs CPU on 2 mixtures, max abs err (largest "
          "entry): " + ", ".join(f"{k} {errs[k]:.3e} ({scale[k]:.3f})"
                                 for k in errs), flush=True)
    return root / "single", launches, {"rate": rate, "warm": warm,
                                       "batch_ms": batch_ms}


def _flat(out):
    """Nested lists of arrays -> a flat list of arrays."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def wham_score_phase(root: Path, sep: Path, card):
    """run.sh stage 4: compute_ss_metric --metric sisnr on the card's
    separated wavs against the sources; every value finite."""
    import numpy as np

    from aps_tpu_torch.cmd import compute_ss_metric
    data = root / "tt"
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        compute_ss_metric.main([
            f"{sep / 'spk1.scp'},{sep / 'spk2.scp'}",
            f"{data / 's1.scp'},{data / 's2.scp'}", "--metric", "sisnr",
            "--sr", str(WHAM_SR), "--per-utt", str(root / "sisnr.txt")])
    values = [float(ln.split("\t")[1]) for ln in
              (root / "sisnr.txt").read_text().splitlines()]
    if len(values) != WHAM_SEP_UTTS or not np.isfinite(values).all():
        fail(f"compute_ss_metric: {values}")
    print(f"compute_ss_metric (run.sh stage 4) on the card's output: "
          f"{' | '.join(report.getvalue().splitlines())}; per mixture "
          f"{min(values):.2f} to {max(values):.2f} dB (a few steps of "
          f"training on tones)", flush=True)


def freq_tcn_phase(root: Path, conf: dict, egs, gen, dev, card):
    """sse@freq_tcn at its default widths (6 blocks x 3 repeats, 512/256
    channels, BatchNorm with running statistics off their initial values)
    on the recipe's enh transform under sse@freq_linear_sa (tPSA, as wham
    1a): one trainer step on the card, one training pass card vs CPU (the
    float64 pass as referee: a gradient in front of a batch norm), written
    as an aps_tpu checkpoint and two mixtures separated card vs CPU.
    -> launches of the step and the separation."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.libs import (aps_sse_nnet, aps_task, aps_trainer,
                                    aps_transform)
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    nnet_conf = {"in_features": 257, "num_bins": 257}
    task_conf = {"num_spks": 2, "permute": True, "phase_sensitive": True,
                 "truncated": 1}
    model = aps_sse_nnet("sse@freq_tcn")(
        enh_transform=aps_transform("enh")(**conf["enh_transform"]),
        **nnet_conf)
    init_tcn(model, gen)
    task = aps_task("sse@freq_linear_sa", model, **task_conf)
    loss_g, loss_c, errs = step_pass_check(task, egs, dev, FREQ_TCN_GRADS,
                                           WHAM_CHECK_UTTS, referee=True)
    cpt = root / "freq_tcn"
    cpt.mkdir()
    full = dict(nnet="sse@freq_tcn", nnet_conf=nnet_conf,
                enh_transform=conf["enh_transform"],
                task="sse@freq_linear_sa", task_conf=task_conf,
                data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(full, indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "epoch": 0}, fd)
    trainer = aps_trainer("dp")(copy.deepcopy(task), device=dev,
                                checkpoint=root / "freq_tcn_trainer",
                                optimizer="adam",
                                optimizer_kwargs={"lr": 1e-3},
                                clip_gradient=10,
                                matmul_precision="bfloat16")
    build.reset_launches()
    done, step_s = synced(lambda: trainer.train_one_step(egs))
    seps = {w: separate.Separator(str(cpt), device=w)
            for w in ("cpu", "cuda")}
    mix = egs["mix"][:2]
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: s.run_batch(list(mix)) for w, s in seps.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    loss = float(trainer.reporter.stats["loss"][-1]) if done else math.nan
    if not (done and math.isfinite(loss)):
        fail(f"sse@freq_tcn step: done {done}, loss {loss}")
    if any(launches.values()):
        fail(f"sse@freq_tcn launches {launches}, expected none")
    got = np.concatenate([np.ravel(a) for a in _flat(outs["cuda"])])
    want = np.concatenate([np.ravel(a) for a in _flat(outs["cpu"])])
    scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
    if not (scale > 0 and err <= TOL_SEP_REL * scale):
        fail(f"sse@freq_tcn separation card vs CPU: {err} over "
             f"{TOL_SEP_REL} of {scale}")
    print(f"sse@freq_tcn (default widths) under sse@freq_linear_sa: one "
          f"step on the card of {WHAM_BATCH} x {WHAM_SECS} s, loss "
          f"{loss:.4f}, {step_s:.4f} s host (the first, with its set-up); "
          f"training pass on {WHAM_CHECK_UTTS} mixtures: loss card "
          f"{loss_g:.6f} vs CPU {loss_c:.6f}, gradients' distance (card, "
          "CPU) from the card's float64 pass relative to the largest entry "
          + ", ".join(f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in errs.items())
          + f"; separation of 2 mixtures card vs CPU {err:.3e} (largest "
          f"sample {scale:.3f}); no kernel launches ({card})", flush=True)
    return launches


def wham_phase(root: Path, gen, dev, card):
    """The frequency-domain slice: check_stft, wham_train_phase, the
    recipe's pass card vs CPU, wham_separate_phase, wham_score_phase,
    freq_tcn_phase. -> (launch counts of training, of separation, of the
    sse@freq_tcn step and separation, and the numbers for the summary)."""
    beg = time.perf_counter()
    root.mkdir()
    cpt, egs, launches_train, numbers = wham_train_phase(root, gen, dev,
                                                         card)
    conf = wham_conf(root / "data")
    stft_errs, stft_ms = check_stft(egs, conf["enh_transform"], dev, card)
    loss_g, loss_c, errs = step_pass_check(wham_task(conf), egs, dev,
                                           WHAM_GRADS, WHAM_CHECK_UTTS,
                                           referee=False)
    print(f"wham 1b training pass card vs CPU at float32 (dropout off, "
          f"TF32 flags read off inside) on {WHAM_CHECK_UTTS} mixtures: loss "
          f"{loss_g:.6f} vs {loss_c:.6f}; gradient errors relative to the "
          "largest entry " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in errs.items()),
          flush=True)
    sep, launches_sep, sep_numbers = wham_separate_phase(root, cpt, gen,
                                                         dev, card)
    wham_score_phase(root, sep, card)
    launches_tcn = freq_tcn_phase(root, conf, egs, gen, dev, card)
    numbers.update(sep_numbers, stft_ms=stft_ms,
                   phase_s=time.perf_counter() - beg)
    print(f"the frequency-domain phase took {numbers['phase_s']:.1f} s",
          flush=True)
    return launches_train, launches_sep, launches_tcn, numbers


# the rest of the SSE zoo: three recipes as their run.sh stages 2 and 3 run
# them, at their published widths (the batch, the loader's chunk and sample
# rate of each YAML), and sse@freq_xfmr through K3. wsj0_2mix/1b: a
# time-domain DPRNN (12 LSTM blocks, 128 units, sse@sisnr); dns_is2020/1a:
# DEMUCS (resampling 4, 5 layers of 64 to 1024 channels, a 2 x 1024 LSTM,
# sse@wa L1); export_dcunet/1a: the complex DCUNet (sse@sisnr, 512-point
# STFT), its 7 stride-2 layers cut to 6 with the output padding the 257
# bins need: as written the 7th layer takes each half's 2 bins to 0 and
# neither package builds it. None of the three reaches a hand-written
# kernel (cuDNN's LSTMs and convolutions, cuBLAS, cuFFT)
ZOO_DCUNET_CUT = dict(K="7,5;7,5;7,5;5,3;5,3;5,3",
                      S="2,1;2,1;2,1;2,1;2,1;2,1", C="32,32,64,64,64,64",
                      P="1,1,1,1,1,1", O="0,0,1,0,1,1")
ZOO_RECIPES = {
    # recipe -> run.sh's batch, the files written (mixture first), the
    # gradients held card vs CPU, the float64 referee (a batch norm in the
    # model), the change to nnet_conf
    "wsj0_2mix/1b": dict(
        batch=32, names=("mix", "spk1", "spk2"), referee=False, patch={},
        grads=("encoder.weight",
               "separator.block_0.single_rnn.cells.weight_ih_l0",
               "separator.block_11.single_rnn.cells.weight_hh_l0_reverse",
               "separator.dense.weight", "decoder.weight")),
    "dns_is2020/1a": dict(
        batch=32, names=("mix", "spk1"), referee=False, patch={},
        grads=("enc_conv_0.weight", "enc_pw_4.weight",
               "lstm.layer_1.cells.weight_hh_l0", "dec_pw_0.weight",
               "dec_conv_4.weight")),
    "export_dcunet/1a": dict(
        batch=16, names=("mix", "spk1"), referee=True,
        patch=ZOO_DCUNET_CUT,
        grads=("enc.enc_0.real_conv.conv.weight",
               "enc.enc_5.imag_conv.conv.weight",
               "dec.dec_0.real_convt.conv_t.weight",
               "dec.dec_5.imag_convt.conv_t.weight")),
}
ZOO_TRAIN_EPOCHS = 2  # one step each: the corpus is one batch
ZOO_TIMED_STEPS = 2
ZOO_CHECK_UTTS = 2  # of the batch, in the card-vs-CPU training pass
ZOO_SEP_UTTS = 4  # separated as run.sh stage 3 does, batch 1
ZOO_SEP_CHECK = 2  # of them, card vs CPU
# sse@freq_xfmr: no recipe; the class's 257 bins and 6 layers, the
# encoders' width 512 with 8 heads of 64 and feed-forward 2048, the rel
# pose, every dropout 0 (an active attention dropout takes the dense path);
# wham 1a's enh transform (512/256 sqrthann frames, spectrogram-log-cmvn)
# and task (tPSA), 16 mixtures of 4 s at 16 kHz, 251 frames each
FREQ_XFMR_CONF = dict(input_size=257, num_bins=257, num_spks=2, arch="xfmr",
                      pose="rel", num_layers=6,
                      arch_kwargs=dict(att_dim=512, nhead=8,
                                       feedforward_dim=2048,
                                       att_dropout=0.0, ffn_dropout=0.0))
FREQ_XFMR_YAML = "examples/sse/wham/conf/1a_bss_c_16k_max.yaml"
FREQ_XFMR_BATCH = 16
FREQ_XFMR_SECS = 4
FREQ_XFMR_HEADS = 8
FREQ_XFMR_GRADS = ("xfmr.proj_layer.dense.weight",
                   "xfmr.encoder.layers.0.self_attn.in_proj.weight",
                   "xfmr.encoder.layers.5.self_attn.in_proj.weight",
                   "xfmr.pose_layer.embed.weight", "xfmr.outp.weight")
REL_KERNELS = ("flash_attention_rel",) + tuple(
    f"flash_attention_rel_{k}" for k in BACKWARD)


def _sep_files(sep: Path, keys, names, sr: int, length: int):
    """The separated wavs of every key (spk<i>/<key>.wav for two streams,
    <key>.wav for one), finite, at sr and of the input's length."""
    import numpy as np
    from scipy.io import wavfile
    streams = [f"spk{i}/" for i in range(1, len(names))] \
        if len(names) > 2 else [""]
    for key in keys:
        for stream in streams:
            sr_got, pcm = wavfile.read(str(sep / f"{stream}{key}.wav"))
            if sr_got != sr or pcm.shape != (length,) or \
                    not np.isfinite(pcm).all():
                fail(f"separate: {sep.name}/{stream}{key}.wav has sr "
                     f"{sr_got}, shape {pcm.shape}")


def _card_vs_cpu_separation(cpt: Path, mixes, dev, label: str,
                            tag: str = "best"):
    """ZOO_SEP_CHECK mixtures through Separator.run (batch 1 on the length
    grid, as separate runs it) on the CPU and on the card, the checkpoint
    of `tag`: the largest difference within TOL_SEP_REL of the largest
    sample. -> (err, scale)."""
    import numpy as np

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    keys = sorted(mixes)[:ZOO_SEP_CHECK]
    seps = {w: separate.Separator(str(cpt), cpt_tag=tag, device=w)
            for w in ("cpu", "cuda")}
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: [s.run(mixes[k]) for k in keys] for w, s in seps.items()}
    got = np.concatenate([np.ravel(a) for a in _flat(outs["cuda"])])
    want = np.concatenate([np.ravel(a) for a in _flat(outs["cpu"])])
    scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
    if not (scale > 0 and np.isfinite(got).all() and
            err <= TOL_SEP_REL * scale):
        fail(f"{label} separation card vs CPU: max abs err {err} over "
             f"{TOL_SEP_REL} of the largest sample {scale}")
    return err, scale


def _train_ss_run(root: Path, conf: dict, batch: int, dev):
    """conf (written as root/train.yaml) through aps_tpu_torch.cmd.train_ss,
    ZOO_TRAIN_EPOCHS one-step epochs on the one batch of its data, the
    launch counts reset before and read after; then ZOO_TIMED_STEPS timed
    steps on that batch and one traced. -> (trainer, checkpoint, the
    batch, launches of the run, the losses, validation passes, numbers of
    the step: median host s, peak GiB, device ms, host launches, the
    kernels with the most device time)."""
    import torch

    from aps_tpu_torch.cmd import train_ss
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.libs import aps_dataloader
    from aps_tpu_torch.ops import build
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    cpt = root / "cpt"
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_ss.main([
            "--conf", str(root / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", str(batch), "--epochs", str(ZOO_TRAIN_EPOCHS),
            "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if trainer.device.type != "cuda" or \
            trainer.cur_step != ZOO_TRAIN_EPOCHS:
        fail(f"train_ss took {trainer.cur_step} steps on {trainer.device}")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    loader = conf["data_conf"]["loader"]
    batches = list(aps_dataloader(fmt="se@chunk", train=False,
                                  max_batch_size=batch, **loader,
                                  **conf["data_conf"]["valid"]))
    shape = (batch, loader["chunk_size"])
    if len(batches) != 1 or batches[0]["mix"].shape != shape:
        fail(f"expected one batch of {shape}, got "
             f"{[b['mix'].shape for b in batches]}")
    egs = batches[0]
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for step in range(ZOO_TIMED_STEPS):
        done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        if not done:
            fail(f"timed step {step} was skipped (non-finite loss or norm)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, _, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses + valid)):
        fail(f"non-finite loss: training {losses}, validation {valid}")
    step = {"host_s": statistics.median(secs), "peak_gib": peak,
            "device_ms": device_ms, "host_launches": host_launches,
            "top": top_kernels(prof, 4)}
    return trainer, cpt, egs, launches, losses, len(valid), step


def _traced_separation_ms(cpt: Path, mix) -> float:
    """Device ms of one traced Separator.run of mix on the card (batch 1 on
    the length grid), after one untraced run."""
    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.cmd.profile_decode import profile
    sep = separate.Separator(str(cpt), device="cuda")
    sep.run(mix)
    return profile(lambda: sep.run(mix))[0]


def _seeded_task(conf: dict):
    """The YAML's task around its model with seeded weights."""
    import torch

    from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_transform
    torch.manual_seed(SEED)
    kwargs = dict(conf["nnet_conf"])
    if "enh_transform" in conf:
        kwargs["enh_transform"] = aps_transform("enh")(
            **conf["enh_transform"])
    return aps_task(conf["task"], aps_sse_nnet(conf["nnet"])(**kwargs),
                    **conf["task_conf"])


def zoo_recipe_phase(root: Path, recipe: str, gen, dev, card):
    """examples/sse/<recipe>.yaml as written (nnet_conf patched as
    ZOO_RECIPES says) through train_ss on run.sh's batch of seeded
    mixtures of the loader's chunk, no kernel launched; one training pass
    card vs CPU on ZOO_CHECK_UTTS of them (PERF.md section 2's gate, the
    float64 referee where a batch norm is in the model); the trained
    checkpoint through separate as run.sh stage 3 (batch 1) on
    ZOO_SEP_UTTS mixtures, no kernel launched, and card vs CPU on
    ZOO_SEP_CHECK. -> (launches of training, of separation, numbers)."""
    import torch

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    beg = time.perf_counter()
    spec = ZOO_RECIPES[recipe]
    exp, name = recipe.split("/")
    root.mkdir()
    conf = load_ss_conf(str(REPO / "examples/sse" / exp / "conf" /
                            f"{name}.yaml"))
    conf["nnet_conf"].update(spec["patch"])
    loader = conf["data_conf"]["loader"]
    sr, S, names = loader["sr"], loader["chunk_size"], spec["names"]
    # se@chunk's training offset is drawn from [0, length mod hop], hop =
    # chunk // 2: with an odd chunk (dns's 32085) an utterance of the
    # chunk's length loses its chunk half the time, so the training
    # mixtures are longer by what makes the offset 0 (one chunk each)
    hop = S // 2
    data = root / "data"
    data.mkdir()
    write_mixtures(data, spec["batch"], gen, sr, (S + (-S) % hop) / sr,
                   names)
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = {
        "mix_scp": str(data / "mix.scp"),
        "ref_scp": ",".join(str(data / f"{n}.scp") for n in names[1:])}
    trainer, cpt, egs, launches_train, losses, _, step = \
        _train_ss_run(root, conf, spec["batch"], dev)
    if any(launches_train.values()):
        fail(f"train_ss ({recipe}) launches {launches_train}, expected none")
    if trainer.matmul_precision != "bfloat16":
        fail(f"{recipe} trains at {trainer.matmul_precision}")
    params = sum(p.numel() for p in trainer.task.nnet.parameters())
    del trainer
    loss_g, loss_c, errs = step_pass_check(
        _seeded_task(conf), egs, dev, spec["grads"], ZOO_CHECK_UTTS,
        referee=spec["referee"])
    tt = root / "tt"
    tt.mkdir()
    mixes = write_mixtures(tt, ZOO_SEP_UTTS, gen, sr, S / sr, names)
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = separate.main([str(tt / "mix.scp"), str(root / "sep"),
                               "--checkpoint", str(cpt), "--sr", str(sr)])
    torch.cuda.synchronize()
    launches_sep = dict(build.LAUNCHES)
    if any(launches_sep.values()):
        fail(f"separate ({recipe}) launches {launches_sep}, expected none")
    _sep_files(root / "sep", sorted(mixes), names, sr, S)
    err, scale = _card_vs_cpu_separation(cpt, mixes, dev, recipe)
    with matmul_precision(INFERENCE_PRECISION, dev):
        sep_ms = _traced_separation_ms(cpt, mixes[sorted(mixes)[0]])
    rate = stats["audio_secs"] / stats["sep_secs"]
    numbers = dict(step, sep_rate=rate, sep_device_ms=sep_ms, params=params,
                   phase_s=time.perf_counter() - beg)
    cut = f", nnet_conf {spec['patch']}" if spec["patch"] else " as written"
    print(f"{recipe}{cut} ({conf['nnet']}, {params} parameters, "
          f"{conf['task']}): train_ss on {spec['batch']} x {S} samples at "
          f"{sr} Hz, {ZOO_TRAIN_EPOCHS} one-step epochs then "
          f"{ZOO_TIMED_STEPS} timed steps, no kernel launches; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step: device "
          f"{step['device_ms']:.3f} ms (traced; {step['host_launches']} "
          f"launches), host {step['host_s']:.4f} s median (host clock around "
          f"a synchronised step, TF32), peak memory {step['peak_gib']:.3f} "
          f"GiB ({card})", flush=True)
    print(f"{recipe} step, the kernels with the most device time (ms): "
          f"{step['top']}", flush=True)
    print(f"{recipe} training pass card vs CPU at float32 on "
          f"{ZOO_CHECK_UTTS} chunks: loss {loss_g:.6f} vs {loss_c:.6f}; "
          + ("gradients' distance (card, CPU) from the card's float64 pass "
             "relative to the largest entry " + ", ".join(
                 f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in errs.items())
             if spec["referee"] else
             "gradient errors relative to the largest entry " + ", ".join(
                 f"{k} {v:.3e}" for k, v in errs.items())), flush=True)
    print(f"{recipe} separate (run.sh stage 3, batch 1): {ZOO_SEP_UTTS} x "
          f"{S} samples, {rate:.2f} audio-s/s (host clock around "
          f"synchronised forwards, the first included), a mixture's forward "
          f"{sep_ms:.3f} ms of device time (traced), no kernel launches; "
          f"card vs CPU on {ZOO_SEP_CHECK} mixtures: max abs err {err:.3e} "
          f"(largest sample {scale:.3f}); the phase took "
          f"{numbers['phase_s']:.1f} s", flush=True)
    return launches_train, launches_sep, numbers


@contextlib.contextmanager
def rel_calls():
    """Record (B, H, T, D, Hp, k_len, causal, grad enabled) of every call
    that reaches flash_attention_rel through the attention modules."""
    import torch

    from aps_tpu_torch.asr.transformer import impl
    real = impl.flash_attention_rel
    seen = []

    def record(q_c, q_p, k, v, pose, k_len=None, causal=False):
        B, _, T, _ = q_c.shape
        lens = (T,) * B if k_len is None else tuple(k_len.tolist())
        seen.append((*q_c.shape, pose.shape[0], lens, causal,
                     torch.is_grad_enabled()))
        return real(q_c, q_p, k, v, pose, k_len=k_len, causal=causal)

    impl.flash_attention_rel = record
    try:
        yield seen
    finally:
        impl.flash_attention_rel = real


def freq_xfmr_phase(root: Path, gen, dev, card):
    """sse@freq_xfmr (FREQ_XFMR_CONF) under wham 1a's transform and task
    through train_ss on FREQ_XFMR_BATCH mixtures of FREQ_XFMR_SECS s: K3's
    forward once a layer a pass (training and validation), each backward
    kernel once a layer a step, counted exactly; a training pass card vs
    CPU (K3's four kernels on the card, launched once a layer); separate on
    ZOO_SEP_UTTS mixtures, batch 1 (K3's forward once a layer each), card vs
    CPU on ZOO_SEP_CHECK; then K3's forward and backward kernels against
    their plain versions at the shapes the runs handed them.
    -> (launches of training, of separation, rows by kernel, numbers)."""
    import torch

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    beg = time.perf_counter()
    root.mkdir()
    wham = load_ss_conf(str(REPO / FREQ_XFMR_YAML))
    data = root / "data"
    data.mkdir()
    write_mixtures(data, FREQ_XFMR_BATCH, gen, WHAM_SR, FREQ_XFMR_SECS,
                   WHAM_NAMES)
    scps = {"mix_scp": str(data / "mix.scp"),
            "ref_scp": f"{data / 's1.scp'},{data / 's2.scp'}"}
    conf = dict(nnet="sse@freq_xfmr", nnet_conf=FREQ_XFMR_CONF,
                enh_transform=wham["enh_transform"], task=wham["task"],
                task_conf=wham["task_conf"],
                trainer_conf=wham["trainer_conf"],
                data_conf={"fmt": "se@chunk",
                           "loader": {"chunk_size": FREQ_XFMR_SECS * WHAM_SR,
                                      "sr": WHAM_SR},
                           "train": scps, "valid": scps})
    layers = FREQ_XFMR_CONF["num_layers"]
    with rel_calls() as seen_train:
        _, cpt, egs, launches_train, losses, valid, step = \
            _train_ss_run(root, conf, FREQ_XFMR_BATCH, dev)
    passes = ZOO_TRAIN_EPOCHS + valid
    want = {"flash_attention_rel": layers * passes}
    want.update({k: layers * ZOO_TRAIN_EPOCHS for k in REL_KERNELS[1:]})
    got = {k: launches_train[k] for k in REL_KERNELS}
    others = {k: n for k, n in launches_train.items()
              if k not in REL_KERNELS and n}
    if got != want or others:
        fail(f"train_ss (sse@freq_xfmr) launches {launches_train}, expected "
             f"{want} ({ZOO_TRAIN_EPOCHS} steps, {valid} validation passes)")
    # the float64 referee on the CPU (K3 takes float32 only): the card's and
    # the CPU's float32 gradients of the input projection, under 6 layers,
    # parted by 1.0e-3 and 1.6e-3 of its largest entry in two runs on an
    # NVIDIA H100 80GB HBM3, 700.00 W
    launched = {}
    loss_g, loss_c, errs = step_pass_check(
        _seeded_task(conf), egs, dev, FREQ_XFMR_GRADS, ZOO_CHECK_UTTS,
        referee=True, referee_on="cpu", launched=launched,
        witnesses={"stft64": enh_transform_float64(("stft",))},
        stft_first=FREQ_XFMR_GRADS[0])
    if {k: launched["card32"].get(k, 0) for k in REL_KERNELS} != \
            {k: layers for k in REL_KERNELS}:
        fail(f"the sse@freq_xfmr pass launched {launched['card32']}")
    tt = root / "tt"
    tt.mkdir()
    mixes = write_mixtures(tt, ZOO_SEP_UTTS, gen, WHAM_SR, FREQ_XFMR_SECS,
                           WHAM_NAMES)
    build.reset_launches()
    with rel_calls() as seen_sep, contextlib.redirect_stdout(sys.stderr):
        stats = separate.main([str(tt / "mix.scp"), str(root / "sep"),
                               "--checkpoint", str(cpt), "--sr",
                               str(WHAM_SR)])
    torch.cuda.synchronize()
    launches_sep = dict(build.LAUNCHES)
    want_sep = {k: 0 for k in launches_sep}
    want_sep["flash_attention_rel"] = layers * ZOO_SEP_UTTS
    if launches_sep != want_sep:
        fail(f"separate (sse@freq_xfmr) launches {launches_sep}, expected "
             f"{want_sep}")
    _sep_files(root / "sep", sorted(mixes), WHAM_NAMES, WHAM_SR,
               FREQ_XFMR_SECS * WHAM_SR)
    err, scale = _card_vs_cpu_separation(cpt, mixes, dev, "sse@freq_xfmr")
    with matmul_precision(INFERENCE_PRECISION, dev):
        sep_ms = _traced_separation_ms(cpt, mixes[sorted(mixes)[0]])
    # the shapes the runs handed K3: (B, H, T, D, Hp, k_len, causal)
    trn = {c[:7] for c in seen_train if c[7]}
    sep = {c[:7] for c in seen_sep}
    if len(trn) != 1 or len(sep) != 1:
        fail(f"sse@freq_xfmr handed K3 {trn} in training, {sep} in "
             "separation")
    (B, H, T, D, Hp, lens, causal), = trn
    (B_s, _, T_s, _, Hp_s, lens_s, causal_s), = sep
    if (H, D, Hp, causal, causal_s) != (FREQ_XFMR_HEADS, 64, 1, False,
                                        False) or B != FREQ_XFMR_BATCH:
        fail(f"sse@freq_xfmr's K3 calls: {trn}, {sep}")
    rows = {"flash_attention_rel": check_rel_attention(
        dev, gen, H=H, cases=((T_s, Hp_s, causal_s, list(lens_s),
                               "path"),))[0]}
    bwd = check_rel_attention_bwd(dev, gen, H=H, cases=[
        (T, Hp, causal, list(lens), "freq_xfmr")])[0]
    rows["flash_attention_rel"] += bwd.pop("fwd")
    for kernel, krows in bwd.items():
        rows[f"flash_attention_rel_{kernel}"] = krows
    rate = stats["audio_secs"] / stats["sep_secs"]
    numbers = dict(step, sep_rate=rate, sep_device_ms=sep_ms,
                   train_shape=(B, H, T), separate_shape=(B_s, H, T_s),
                   phase_s=time.perf_counter() - beg)
    print(f"sse@freq_xfmr (6 x 512 rel, 8 heads) under {conf['task']}: "
          f"train_ss on {FREQ_XFMR_BATCH} x {FREQ_XFMR_SECS} s at {WHAM_SR} "
          f"Hz (K3 at B = {B}, H = {H}, T = {T}), {ZOO_TRAIN_EPOCHS} "
          f"one-step epochs and {valid} validation passes then "
          f"{ZOO_TIMED_STEPS} timed steps; launches of the run {got}; "
          f"losses {', '.join(f'{v:.4f}' for v in losses)}; step: device "
          f"{step['device_ms']:.3f} ms (traced; {step['host_launches']} "
          f"launches), host {step['host_s']:.4f} s median, peak memory "
          f"{step['peak_gib']:.3f} GiB ({card})", flush=True)
    print(f"sse@freq_xfmr step, the kernels with the most device time (ms): "
          f"{step['top']}", flush=True)
    print(f"sse@freq_xfmr training pass card vs CPU at float32 on "
          f"{ZOO_CHECK_UTTS} mixtures (K3's four kernels once a layer on the "
          f"card): loss {loss_g:.6f} vs {loss_c:.6f}; gradients' distance "
          "(card, CPU, the card with the STFT in float64) from the CPU's "
          "float64 pass relative to the largest entry "
          + ", ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in e)
                      for k, e in errs.items()), flush=True)
    print(f"sse@freq_xfmr separate, batch 1: {ZOO_SEP_UTTS} mixtures (K3 at "
          f"B = {B_s}, T = {T_s}), {rate:.2f} audio-s/s, a mixture's "
          f"forward {sep_ms:.3f} ms of device time (traced), launches "
          f"{launches_sep['flash_attention_rel']} of K3's forward; card vs "
          f"CPU on {ZOO_SEP_CHECK}: max abs err {err:.3e} (largest sample "
          f"{scale:.3f}); the phase took {numbers['phase_s']:.1f} s",
          flush=True)
    return launches_train, launches_sep, rows, numbers


def write_recipe(root: Path, train: Path) -> Path:
    """root/recipe/train.yaml: RECIPE_YAML as written, its data sections
    pointed at the tone corpus of the training path."""
    from aps_tpu_torch.conf import load_yaml
    conf = load_yaml(REPO / RECIPE_YAML)
    data = {name: str(train / name) for name in ("text", "utt2dur")}
    data["wav_scp"] = str(train / "wav.scp")
    conf["data_conf"].update(train=data, valid=dict(data))
    recipe = root / "recipe"
    recipe.mkdir()
    (recipe / "train.yaml").write_text(json.dumps(conf, indent=2))
    return recipe


@contextlib.contextmanager
def training_operands():
    """Record what training passes (gradients enabled; validation runs
    without) hand K1 and K3: K1's first waveform, and (B, H, T, D, Hp,
    k_len, causal) of every K3 call. Yields {"wav": tensor or None, "rel":
    [...]}."""
    import torch

    from aps_tpu_torch.asr.transformer import impl
    from aps_tpu_torch.ops import fbank
    real_fbank, real_rel = fbank.fused_logmel, impl.flash_attention_rel
    seen = {"wav": None, "rel": []}

    def record_fbank(wav, *args, **kw):
        if torch.is_grad_enabled() and seen["wav"] is None:
            seen["wav"] = wav.detach().clone()
        return real_fbank(wav, *args, **kw)

    def record_rel(q_c, q_p, k, v, pose, k_len=None, causal=False):
        if torch.is_grad_enabled():
            B, _, T, _ = q_c.shape
            lens = (T,) * B if k_len is None else tuple(k_len.tolist())
            seen["rel"].append((*q_c.shape, pose.shape[0], lens, causal))
        return real_rel(q_c, q_p, k, v, pose, k_len=k_len, causal=causal)

    fbank.fused_logmel, impl.flash_attention_rel = record_fbank, record_rel
    try:
        yield seen
    finally:
        fbank.fused_logmel, impl.flash_attention_rel = real_fbank, real_rel


def recipe_steps(trainer, egs, precision: str, per_step):
    """One accumulation cycle (acmu_gradient mini-steps) of the recipe's
    trainer on egs under matmul_precision `precision`, each mini-step timed
    and counted alone: the parameters must stay put on every mini-step but
    the last, and move on it. -> host seconds of each mini-step."""
    import torch

    from aps_tpu_torch.ops import build
    trainer.matmul_precision = precision
    if trainer.mini_step != 0:
        fail(f"the recipe's trainer is {trainer.mini_step} mini-steps into "
             "an accumulation")
    secs = []
    for step in range(trainer.acmu_gradient):
        before = [p.detach().clone() for p in trainer.params]
        build.reset_launches()
        torch.cuda.synchronize()
        beg = time.perf_counter()
        done = trainer.train_one_step(egs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - beg)
        trainer.cur_step += 1
        trainer.lr_scheduler.step()
        if not done:
            fail(f"recipe mini-step {step} ({precision}) was skipped")
        if dict(build.LAUNCHES) != per_step:
            fail(f"recipe mini-step {step} launches {dict(build.LAUNCHES)}, "
                 f"expected {per_step}")
        moved = any(not torch.equal(p, b)
                    for p, b in zip(trainer.params, before))
        if moved != (step == trainer.acmu_gradient - 1):
            fail(f"recipe mini-step {step + 1} of {trainer.acmu_gradient} "
                 f"({precision}) {'moved' if moved else 'left'} the "
                 "parameters")
    return secs


def gemm_share(prof, device_ms: float):
    """Shares of the device time in cuDNN's convolutions (fprop, dgrad,
    wgrad or conv in the kernel's name) and in cuBLAS's products (gemm,
    or nvjet for cuBLASLt's Hopper kernels)."""
    from aps_tpu_torch.cmd.profile_decode import on_device
    gemm = conv = 0.0
    for evt in prof.events():
        if not on_device(evt):
            continue
        name = evt.name.lower()
        ms = evt.self_device_time_total / 1e3
        if any(k in name for k in ("conv", "fprop", "dgrad", "wgrad")):
            conv += ms
        elif "gemm" in name or "nvjet" in name:
            gemm += ms
    return gemm / device_ms, conv / device_ms


def recipe_phase(root: Path, train: Path, dev, card):
    """RECIPE_YAML through aps_tpu_torch.cmd.train_am on the tone corpus:
    RECIPE_EPOCHS epochs of 8 mini-steps with the launch counts read over
    the run (K1 once and each K3 kernel once a layer per mini-step, K1 and
    K3's forward per validation batch); no epoch.N.ckpt (the recipe asks
    for no averaging); then one accumulation cycle at the recipe's
    bfloat16 (TF32) and one at float32 on the first batch, each mini-step
    timed and counted, the parameters moving on the 4th only, and each
    cycle traced once. -> (egs, launches of the run, of one mini-step,
    {precision: (median mini-step s, device ms of a cycle, GEMM share,
    conv share)}, the trainer, what its training passes handed K1 and K3
    (training_operands))."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.ops import build
    recipe = write_recipe(root, train)
    cpt = recipe / "cpt"
    argv = ["--conf", str(recipe / "train.yaml"), "--dict",
            str(root / "dict"), "--checkpoint", str(cpt), "--batch-size",
            str(RECIPE_BATCH), "--epochs", str(RECIPE_EPOCHS), "--seed",
            str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr), training_operands() as seen:
        trainer = train_am.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    batches = TRAIN_UTTS // RECIPE_BATCH
    steps = RECIPE_EPOCHS * batches
    model = trainer.task.nnet
    transform = model.asr_transform
    layers = len(model.encoder.encoder.layers)
    if trainer.device.type != "cuda" or trainer.cur_step != steps or \
            trainer.mini_step != 0:
        fail(f"train_am took {trainer.cur_step} mini-steps on "
             f"{trainer.device}, {trainer.mini_step} into an accumulation")
    setup = (trainer.acmu_gradient, trainer.matmul_precision,
             type(trainer.optimizer).__name__, layers,
             transform.rescale is not None, transform.perturb is not None,
             transform.specaug is not None, transform.generator is
             trainer.generator, trainer.generator.device.type)
    if setup != (4, "bfloat16", "AdamW", ENC_LAYERS, True, True, True, True,
                 "cuda"):
        fail(f"the recipe's trainer and front end are not as written: "
             f"{setup}")
    want = step_launches("flagship", steps + (RECIPE_EPOCHS + 1) * batches,
                         steps)
    if launches != want:
        fail(f"recipe launches {launches}, expected {want}")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    if len(losses) != RECIPE_EPOCHS or len(valid) != RECIPE_EPOCHS + 1:
        fail(f"the recipe's trainer.log reports {len(losses)} training and "
             f"{len(valid)} validation epochs")
    # best.ckpt only once the accuracy beats its start by no_impr_thres
    written = sorted(p.name for p in cpt.glob("*.ckpt"))
    if "last.ckpt" not in written or \
            not set(written) <= {"best.ckpt", "last.ckpt"}:
        fail(f"the recipe's run wrote {written}: it asks for no epoch "
             "checkpoints")
    egs = first_batch(root, recipe, RECIPE_BATCH, batches)
    per_step = step_launches("flagship", 1, 1)
    trainer.reporter.train()
    timed = {}
    for precision in ("bfloat16", "float32"):
        secs = recipe_steps(trainer, egs, precision, per_step)
        device_ms, wall, _, prof = profile(
            lambda: recipe_steps(trainer, egs, precision, per_step))
        timed[precision] = (statistics.median(secs), device_ms,
                            *gemm_share(prof, device_ms))
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses + valid)):
        fail(f"non-finite recipe loss: training {losses}, validation "
             f"{valid}")
    print(f"recipe ({RECIPE_YAML}, as written): {TRAIN_UTTS} x "
          f"{UTT_SECS} s through train_am in batches of {RECIPE_BATCH}: "
          f"{RECIPE_EPOCHS} epochs of {batches} mini-steps (acmu_gradient "
          f"{trainer.acmu_gradient}), launches {launches}; per mini-step "
          f"{per_step}; training losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; validation losses "
          f"{', '.join(f'{v:.4f}' for v in valid)}", flush=True)
    for precision, (med, device_ms, gemm, conv) in timed.items():
        print(f"recipe mini-step at matmul_precision {precision}: median "
              f"{med:.4f} s (host clock around a synchronised mini-step); "
              f"one cycle of {trainer.acmu_gradient} mini-steps traced: "
              f"device {device_ms:.3f} ms, cuBLAS products {gemm:.4f} and "
              f"cuDNN convolutions {conv:.4f} of it ({card})", flush=True)
    return egs, launches, per_step, timed, trainer, seen


def check_recipe_kernels(dev, gen, model, seen):
    """K1 and K3 as the recipe's training passes called them: K1 on the
    first rescaled, speed-perturbed batch with the recipe transform's own
    options (check_fbank), K3's forward and its backward kernels at every
    (B, H, T, k_len) the passes gave it (the branches of the perturbation
    give other k_len), with one pose table a head (xl), each launched
    twice for bit-equal results and held to its plain version.
    -> {kernel name: rows}"""
    shapes = sorted(set(seen["rel"]), key=seen["rel"].index)
    wav = seen["wav"]
    if wav is None or tuple(wav.shape) != (RECIPE_BATCH, wav.shape[1]) or \
            {(B, H, D, Hp, causal) for B, H, _, D, Hp, _, causal in shapes} \
            != {(RECIPE_BATCH, RECIPE_HEADS, 64, RECIPE_HEADS, False)}:
        fail(f"the recipe's training passes handed K1 "
             f"{None if wav is None else tuple(wav.shape)} and K3 {shapes}")
    print(f"recipe path: K1 on {tuple(wav.shape)} samples (rescaled and "
          f"perturbed), K3 at (B, H, T, D, Hp, k_len, causal) {shapes}",
          flush=True)
    rows = {"fused_logmel": check_fbank(dev, model,
                                        (("recipe training", wav),))[0]}
    cases = [(T, Hp, causal, list(lens), "recipe")
             for _, _, T, _, Hp, lens, causal in shapes]
    rows["flash_attention_rel"] = check_rel_attention(
        dev, gen, H=RECIPE_HEADS, cases=cases)[0]
    bwd = check_rel_attention_bwd(dev, gen, H=RECIPE_HEADS, cases=cases)[0]
    rows["flash_attention_rel"] += bwd.pop("fwd")
    for kernel, kernel_rows in bwd.items():
        rows[f"flash_attention_rel_{kernel}"] = kernel_rows
    return rows


RECIPE_GRADS = ("encoder.encoder.layers.0.self_attn.in_proj.weight",
                "encoder.encoder.layers.11.feedforward2.linear1.weight",
                "ctc_head.weight", "decoder.output.weight")


def tf32_flags():
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def recipe_check(root: Path, egs, dev, gen):
    """One training pass of the recipe with every dropout off and the
    draws fed in (the 0.9 branch of the speed perturbation, one seeded
    SpecAugment mask): on the CPU, on the card at matmul_precision
    float32 and at the recipe's bfloat16 (TF32). Card vs CPU within the
    training pass's tolerances; TF32 vs float32 on the card within
    TOL_TF32_* and not bit-equal, with cuBLAS's and cuDNN's TF32 flags read
    inside each card pass and after it. -> (losses, errors of the card,
    errors of TF32)."""
    import torch

    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.flagship import build_flagship, init_weights
    from aps_tpu_torch.libs import aps_task
    from aps_tpu_torch.trainer.base import matmul_precision
    from aps_tpu_torch.trainer.dp import to_device
    from aps_tpu_torch.transform.augment import tf_mask
    conf, _ = load_am_conf(str(root / "recipe" / "train.yaml"),
                           str(root / "dict"))
    nnet_conf = conf["nnet_conf"]
    for part in ("enc_kwargs", "dec_kwargs"):
        nnet_conf[part]["pose_kwargs"]["dropout"] = 0.0
        nnet_conf[part]["arch_kwargs"].update(att_dropout=0.0,
                                              ffn_dropout=0.0)
    model = build_flagship(conf)
    init_weights(model, gen)
    task = aps_task(conf["task"], model, **conf["task_conf"])
    transform = model.asr_transform
    frames = int(transform._num_frames(torch.tensor(egs["src_pad"].shape[-1])))
    aug = transform.specaug
    mask = tf_mask(RECIPE_BATCH, (frames, transform.dim()), pm=aug.pm,
                   ps=aug.ps, max_bands=aug.freq_args[0],
                   max_frame=aug.time_args[0],
                   num_freq_masks=aug.freq_args[1],
                   num_time_masks=aug.time_args[1], generator=gen)
    if not 0 < float(mask.mean()) < 1:
        fail("the fed SpecAugment mask masks nothing or everything")
    tensors = {k: v for k, v in egs.items() if not k.startswith("#")}
    outs = []
    for where, precision in (("cpu", "float32"), (dev, "float32"),
                             (dev, "bfloat16")):
        side = copy.deepcopy(task).to(where).train()
        tf = side.nnet.asr_transform
        tf.perturb.draw = lambda generator: 0
        tf.specaug.draw = lambda x, generator: (
            mask.to(x.device), torch.ones(x.shape[0], dtype=torch.bool,
                                          device=x.device))
        with matmul_precision(precision, torch.device(where)):
            flags_in = tf32_flags()
            stats = side(to_device(tensors, torch.device(where)))
            stats["loss"].backward()
        want = where != "cpu" and precision == "bfloat16"
        if where != "cpu" and (flags_in, tf32_flags()) != \
                ((want, want), (False, False)):
            fail(f"matmul_precision {precision}: TF32 flags (cuBLAS, cuDNN) "
                 f"{flags_in} inside the pass, {tf32_flags()} after it")
        params = dict(side.nnet.named_parameters())
        outs.append((stats["loss"].item(),
                     {k: params[k].grad.cpu() for k in RECIPE_GRADS}))
    cpu, card, tf32 = outs

    def distance(got, ref):
        loss = abs(got[0] - ref[0]) / abs(ref[0])
        grads = {k: ((got[1][k] - ref[1][k]).abs().max() /
                     ref[1][k].abs().max()).item() for k in RECIPE_GRADS}
        return loss, grads

    loss_err, errs = distance(card, cpu)
    if not (math.isfinite(card[0]) and loss_err <= TOL_STEP_LOSS and
            all(v <= TOL_STEP_GRAD for v in errs.values())):
        fail(f"recipe pass card vs CPU at float32: loss {card[0]} vs "
             f"{cpu[0]}, gradient errors {errs}")
    tf32_loss_err, tf32_errs = distance(tf32, card)
    if tf32[0] == card[0] and all(torch.equal(tf32[1][k], card[1][k])
                                  for k in RECIPE_GRADS):
        fail("recipe pass: TF32 equals float32 on the card bit for bit")
    if not (tf32_loss_err <= TOL_TF32_LOSS and
            all(v <= TOL_TF32_GRAD for v in tf32_errs.values())):
        fail(f"recipe pass TF32 vs float32 on the card: loss {tf32[0]} vs "
             f"{card[0]}, gradient errors {tf32_errs}")
    return (cpu[0], card[0], tf32[0]), (loss_err, errs), \
        (tf32_loss_err, tf32_errs)


# ---------------------------------------------------------------------------
# the LM slice: run.sh stages 3 to 5 of the LM recipes
# ---------------------------------------------------------------------------
def init_lm(model, gen) -> None:
    """Seeded weights for an LM: each trainable matrix N(0, 1 / fan_in),
    each vector 0.1 N(0, 1) (a bias frozen at 0 stays 0), the output
    layer LM_PEAKY times larger, so that the fused log-probabilities are
    far from uniform."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) /
                        math.sqrt(p.shape[-1]))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        model.dist.weight.mul_(LM_PEAKY)


def write_lm(root: Path, yaml: str, gen, name: str):
    """The LM of the recipe `yaml` as written, its vocabulary the smoke's
    dict, with seeded weights -> a checkpoint directory root/name as
    train_lm writes it (train.yaml from load_lm_conf, best.ckpt, dict) and
    the model."""
    from aps_tpu_torch.conf import dump_conf, load_lm_conf
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.libs import aps_asr_nnet
    conf, _ = load_lm_conf(str(REPO / yaml), str(root / "dict"))
    model = aps_asr_nnet(conf["nnet"])(**conf["nnet_conf"])
    init_lm(model, gen)
    cpt = root / name
    cpt.mkdir()
    (cpt / "train.yaml").write_text(dump_conf(conf))
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": to_variables(model)["params"], "epoch": 0},
                    fd)
    (cpt / "dict").write_bytes((root / "dict").read_bytes())
    return cpt, model


def synced(fn):
    """(fn(), host seconds around it, synchronised on the card)."""
    import torch
    torch.cuda.synchronize()
    beg = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - beg


def lm_decode_phase(root: Path, cpt: Path, lm_dir: Path, wavs, shapes, dev,
                    card):
    """run.sh stage 4 with the LM: NUM_UTTS utterances through
    aps_tpu_torch.cmd.decode_batch with LM_STAGE4_ARGS in batches of
    LM_BATCH, without the LM and then with it (shallow fusion), the launch
    counts reset just before and read just after each; then stage 5,
    compute_wer --cer true of the fused transcripts against the unfused
    ones (the reference text the smoke writes); one batch of each profiled
    (device time, wall time, host launches a search step); the first
    LM_CHECK_UTTS utterances card vs CPU with the LM.
    -> (launches of the fused decode, numbers for the summary)"""
    import io

    from aps_tpu_torch.asr.beam_search.lm import lm_adapter
    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    from aps_tpu_torch.cmd import compute_wer, decode, decode_batch
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.ops import build
    S, T, k_len = shapes
    runs = {}
    for tag, extra in (("plain", []), ("lm", ["--lm", str(lm_dir)])):
        best = root / f"best.{tag}"
        argv = [str(root / "wav.scp"), str(best), "--am", str(cpt),
                "--dict", str(root / "dict"), "--batch-size",
                str(LM_BATCH)] + LM_STAGE4_ARGS + extra
        build.reset_launches()
        with scorer_steps() as steps:
            stats = decode_batch.main(argv)
        launches = dict(build.LAUNCHES)
        lines = best.read_text().splitlines()
        if sorted(ln.split("\t")[0] for ln in lines) != sorted(wavs) or \
                not all(map(math.isfinite, stats["scores"].values())):
            fail(f"decode_batch ({tag}): {len(lines)} transcript lines, "
                 f"scores {list(stats['scores'].values())}")
        batches = len(stats["batch_secs"])
        want = decode_launches("flagship", batches, len(steps))
        if launches != want or batches != NUM_UTTS // LM_BATCH:
            fail(f"decode_batch ({tag}) launches {launches} in {batches} "
                 f"batches and {len(steps)} search steps, expected {want}")
        runs[tag] = (stats, launches, len(steps), argv)
        print(f"decode_batch {' '.join(LM_STAGE4_ARGS)} ({tag}): "
              f"{NUM_UTTS} x {UTT_SECS} s in batches of {LM_BATCH}: "
              f"{', '.join(f'{b:.4f}' for b in stats['batch_secs'])} s (host "
              f"clock around a synchronised batch); {len(steps)} search "
              f"steps; launches a batch: K1 {launches['fused_logmel'] / batches:g},"
              f" K3 forward {launches['flash_attention_rel'] / batches:g}, K4 "
              f"{launches['ctc_score_step'] / batches:g} ({card})",
              flush=True)
    stats, launches, _, argv = runs["lm"]
    if stats["scores"] == runs["plain"][0]["scores"]:
        fail("the LM changed no score of the decode")
    # stage 5: compute_wer --cer true, the unfused transcripts as reference
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        compute_wer.main([str(root / "best.lm"), str(root / "best.plain"),
                          "--cer", "true"])
    cer = re.search(r"Total \((\d+) utterances\): (\d+)/(\d+) = ([\d.]+)%",
                    report.getvalue())
    if cer is None or int(cer.group(1)) != NUM_UTTS:
        fail(f"compute_wer printed {report.getvalue()!r}")
    print(f"compute_wer --cer true, fused against unfused transcripts: "
          f"{cer.group(0)}", flush=True)

    # one batch of each profiled
    kw = decode.search_kwargs(decode_batch.make_parser().parse_args(argv))
    nnet = load_checkpoint(str(cpt))["nnet"].to(dev)
    lm = load_checkpoint(str(lm_dir))["nnet"].to(dev)
    batch = [wavs[k] for k in sorted(wavs)[:LM_BATCH]]
    sos, eos = VOCAB - 3, VOCAB - 2
    prof = {}
    for tag, adapter in (("plain", None),
                         ("lm", lm_adapter(lm, max_len=LM_MAX_LEN,
                                           sos=sos))):
        search = lambda: beam_search_batch(  # noqa: E731
            nnet, batch, lm=adapter, sos=sos, eos=eos, device=dev,
            pad_to=S, **kw)
        search()
        build.reset_launches()
        device_ms, wall, host_launches, _ = profile(search)
        steps = build.LAUNCHES["ctc_score_step"]
        prof[tag] = (device_ms, wall, host_launches / max(steps, 1), steps)
        print(f"decode batch of {LM_BATCH} x {UTT_SECS} s ({tag}), "
              f"profiled: device time {device_ms:.3f} ms in {wall:.4f} s "
              f"wall, {steps} search steps, "
              f"{host_launches / max(steps, 1):.1f} host launches a step "
              f"({card})", flush=True)
    del nnet, lm

    # the first LM_CHECK_UTTS utterances, card vs CPU, with the LM
    model = load_checkpoint(str(cpt))["nnet"]
    lm = load_checkpoint(str(lm_dir))["nnet"]
    keys = sorted(wavs)[:LM_CHECK_UTTS]
    outs = {}
    for where in ("cpu", dev):
        hyps = beam_search_batch(
            model.to(where), [wavs[k] for k in keys],
            lm=lm_adapter(lm.to(where), max_len=LM_MAX_LEN, sos=sos),
            sos=sos, eos=eos, device=where, pad_to=S, **kw)
        outs[str(where)] = hyps
    score_err = token_err = largest = 0.0
    for key, hc, hg in zip(keys, outs["cpu"], outs[str(dev)]):
        if [h["trans"] for h in hc] != [h["trans"] for h in hg]:
            fail(f"{key}: card and CPU n-best lists differ with the LM")
        for a, b in zip(hc, hg):
            diff = abs(a["score"] - b["score"])
            score_err = max(score_err, diff)
            token_err = max(token_err, diff / (len(a["trans"]) - 1))
            largest = max(largest, abs(a["score"]))
        if abs(hg[0]["score"] - stats["scores"][key]) > \
                LM_SCORE_TOL * (len(hg[0]["trans"]) - 1):
            fail(f"{key}: decode_batch score {stats['scores'][key]} != "
                 f"search score {hg[0]['score']}")
    if not token_err <= LM_SCORE_TOL:
        fail(f"n-best scores with the LM card vs CPU differ by {token_err} "
             "a token")
    print(f"LM-fused search card vs CPU on {LM_CHECK_UTTS} utterances: "
          f"n-best of {len(outs['cpu'][0])} equal, largest score diff "
          f"{score_err:.3e} ({token_err:.3e} a token; the largest score "
          f"{largest:.3f})", flush=True)
    return launches, {"batch_secs": {t: runs[t][0]["batch_secs"]
                                     for t in runs},
                      "profiled": prof, "cer": cer.group(0),
                      "score_err": score_err}


def xfmr_lm_phase(root: Path, cpt: Path, lm_dir: Path, wavs, card):
    """The Transformer LM of XFMR_LM_YAML in the single-utterance search:
    XFMR_LM_UTTS utterances through aps_tpu_torch.cmd.decode with --lm and
    LM_STAGE4_ARGS, --dump-nbest, on the card (launches counted: K1 once
    and K3's forward once a layer per utterance, K4 once a search step)
    and on the CPU: the same best transcripts, scores within 1e-3.
    -> (launches, the nbest file, seconds per utterance on the card)"""
    from aps_tpu_torch.cmd import decode
    from aps_tpu_torch.ops import build
    keys = sorted(wavs)[:XFMR_LM_UTTS]
    scp = root / "xfmr_lm.scp"
    scp.write_text("".join(f"{k}\t{root / (k + '.wav')}\n" for k in keys))
    outs = {}
    for where in ("cuda", "cpu"):
        best, nbest = root / f"xfmr_lm.{where}", root / f"nbest.{where}"
        argv = [str(scp), str(best), "--am", str(cpt), "--dict",
                str(root / "dict"), "--lm", str(lm_dir), "--dump-nbest",
                str(nbest), "--device", where] + LM_STAGE4_ARGS
        build.reset_launches()
        with scorer_steps() as steps:
            stats = decode.main(argv)
        outs[where] = (stats, best.read_text(), dict(build.LAUNCHES),
                       len(steps))
    stats, text, launches, steps = outs["cuda"]
    want = decode_launches("flagship", XFMR_LM_UTTS, steps)
    if launches != want:
        fail(f"decode --lm (Transformer LM) launches {launches}, expected "
             f"{want}")
    if text != outs["cpu"][1] or len(text.splitlines()) != XFMR_LM_UTTS:
        fail("decode --lm (Transformer LM): card and CPU transcripts differ")
    # each best hypothesis's length: its token count in the nbest file
    # and the eos
    lengths = {}
    lines = (root / "nbest.cuda").read_text().splitlines()
    for n, line in enumerate(lines):
        if line in keys:
            lengths[line] = int(lines[n + 1].split("\t")[1]) + 1
    score_err = max(abs(stats["scores"][k] - outs["cpu"][0]["scores"][k])
                    for k in keys)
    token_err = max(abs(stats["scores"][k] - outs["cpu"][0]["scores"][k]) /
                    lengths[k] for k in keys)
    if not token_err <= LM_SCORE_TOL:
        fail(f"decode --lm (Transformer LM) scores card vs CPU differ by "
             f"{token_err} a token")
    shown = ", ".join(f"{stats['scores'][k]:.3f}" for k in keys)
    print(f"decode --lm {XFMR_LM_YAML} ({' '.join(LM_STAGE4_ARGS)}): "
          f"{XFMR_LM_UTTS} x {UTT_SECS} s, one utterance at a time: "
          f"{', '.join(f'{v:.4f}' for v in stats['utt_secs'])} s on the "
          f"card (host clock around a synchronised search), CPU "
          f"{', '.join(f'{v:.4f}' for v in outs['cpu'][0]['utt_secs'])} s; "
          f"{steps} search steps; launches {launches}; card vs CPU best "
          f"transcripts equal, score diff {score_err:.3e} ({token_err:.3e} "
          f"a token; scores {shown}) ({card})",
          flush=True)
    return launches, root / "nbest.cuda", stats["utt_secs"]


ARPA_SMOKE = """\\data\\
ngram 1=5
ngram 2=2

\\1-grams:
-0.8\t<s>\t-0.3
-0.6\tt1\t-0.2
-0.9\tt2\t-0.4
-0.7\t</s>
-3.0\t<unk>

\\2-grams:
-0.2\t<s> t1
-0.3\tt1 t2

\\end\\
"""


def lm_rescore_phase(root: Path, nbest: Path, lm_dir: Path, card):
    """Stage 4's --dump-nbest output through aps_tpu_torch.cmd.lm_rescore,
    with the RNN LM (on the card) and with a small ARPA file: one best
    line for each utterance of the nbest file."""
    from aps_tpu_torch.cmd import lm_rescore
    arpa = root / "lm.arpa"
    arpa.write_text(ARPA_SMOKE)
    keys = [ln for ln in nbest.read_text().splitlines()[1:]
            if ln and "\t" not in ln]
    secs = {}
    for tag, lm in (("nn", lm_dir), ("arpa", arpa)):
        best = root / f"rescored.{tag}"
        _, secs[tag] = synced(lambda: lm_rescore.main(
            [str(nbest), str(best), "--lm", str(lm), "--dict",
             str(root / "dict"), "--lm-weight", "0.2"]))
        lines = best.read_text().splitlines()
        if sorted(ln.split("\t")[0] for ln in lines) != sorted(keys):
            fail(f"lm_rescore ({tag}) wrote {lines}")
    print(f"lm_rescore of {len(keys)} utterances' nbest: NN LM "
          f"{secs['nn']:.4f} s on the card, ARPA {secs['arpa']:.4f} s "
          f"(host clock, model loading included) ({card})", flush=True)


def write_lm_corpus(root: Path, gen) -> Path:
    """root/lm_train: LM_TRAIN_LINES seeded lines of 10 to 40 tokens of
    the smoke's vocabulary (kaldi format) for training and for validation,
    and RNN_LM_YAML as written with its data paths pointed at them."""
    import torch

    from aps_tpu_torch.conf import load_yaml
    train = root / "lm_train"
    train.mkdir()
    for split in ("train", "valid"):
        with open(train / f"{split}.txt", "w") as fd:
            for n in range(LM_TRAIN_LINES):
                size = int(torch.randint(10, 41, (1,), generator=gen))
                toks = torch.randint(1, VOCAB - 3, (size,), generator=gen)
                fd.write(f"{split}{n:03d} " +
                         " ".join(f"t{t}" for t in toks.tolist()) + "\n")
    conf = load_yaml(REPO / RNN_LM_YAML)
    conf["data_conf"]["train"] = {"text": str(train / "train.txt")}
    conf["data_conf"]["valid"] = {"text": str(train / "valid.txt")}
    (train / "nnlm.yaml").write_text(json.dumps(conf, indent=2))
    return train


def train_lm_phase(root: Path, train: Path, dev, card):
    """RNN_LM_YAML as written through aps_tpu_torch.cmd.train_lm on the
    card (LM_TRAIN_EPOCHS epochs, batch LM_TRAIN_BATCH), launch counts
    reset before and read after (no port kernel runs in LM training); then
    LM_TIMED_STEPS steps on the first batch, each timed, the loss falling;
    then one training pass with dropout off, card vs CPU at float32: loss
    and three gradients. -> (launches, median step s, peak GiB)"""
    import torch

    from aps_tpu_torch.cmd import train_lm
    from aps_tpu_torch.conf import load_lm_conf
    from aps_tpu_torch.libs import aps_asr_nnet, aps_dataloader, aps_task
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.trainer.dp import to_device
    cpt = train / "cpt"
    argv = ["--conf", str(train / "nnlm.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(LM_TRAIN_BATCH),
            "--epochs", str(LM_TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_lm.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if any(launches.values()):
        fail(f"train_lm launched port kernels: {launches}")
    if trainer.device.type != "cuda" or trainer.cur_step < LM_TRAIN_EPOCHS:
        fail(f"train_lm took {trainer.cur_step} steps on {trainer.device}")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    if len(valid) != LM_TRAIN_EPOCHS + 1:
        fail(f"train_lm reported {len(valid)} validation epochs")
    conf, vocab = load_lm_conf(str(train / "nnlm.yaml"), str(root / "dict"))
    loader = aps_dataloader(fmt="lm@utt", train=False, vocab_dict=vocab,
                            sos=conf["sos"], eos=conf["eos"],
                            max_batch_size=LM_TRAIN_BATCH,
                            **conf["data_conf"]["loader"],
                            **conf["data_conf"]["train"])
    egs = next(iter(loader))
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    step_secs, losses = [], []
    for step in range(LM_TIMED_STEPS):
        done, secs = synced(lambda: trainer.train_one_step(egs))
        if not done:
            fail(f"train_lm timed step {step} was skipped")
        step_secs.append(secs)
        losses.append(float(trainer.reporter.stats["loss"][-1]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not (all(map(math.isfinite, losses + valid)) and
            losses[-1] < losses[0]):
        fail(f"the LM loss did not fall on the repeated batch: {losses}")
    # one training pass with dropout off, card vs CPU
    conf["nnet_conf"]["dropout"] = 0.0
    model = aps_asr_nnet(conf["nnet"])(**conf["nnet_conf"])
    init_lm(model, torch.Generator().manual_seed(SEED))
    task = aps_task(conf["task"], model, **conf["task_conf"])
    tensors = {k: v for k, v in egs.items() if not k.startswith("#")}
    outs = []
    for where in ("cpu", dev):
        side = copy.deepcopy(task).to(where).train()
        stats = side(to_device(tensors, torch.device(where)))
        stats["loss"].backward()
        params = dict(side.nnet.named_parameters())
        outs.append((stats["loss"].item(),
                     {k: params[k].grad.double().cpu() for k in LM_GRADS}))
    (loss_c, grad_c), (loss_g, grad_g) = outs
    if not abs(loss_g - loss_c) <= TOL_STEP_LOSS * abs(loss_c):
        fail(f"LM training loss card {loss_g} vs CPU {loss_c}")
    errs = {}
    for key in LM_GRADS:
        scale = grad_c[key].abs().max().item()
        errs[key] = (grad_g[key] - grad_c[key]).abs().max().item() / scale
        if not (scale > 0 and errs[key] <= TOL_STEP_GRAD):
            fail(f"LM gradient of {key} card vs CPU: {errs[key]} of its "
                 f"largest entry {scale}")
    print(f"train_lm {RNN_LM_YAML} as written: {trainer.cur_step} steps in "
          f"{LM_TRAIN_EPOCHS} epochs of batches of {LM_TRAIN_BATCH}, "
          f"validation losses {', '.join(f'{v:.4f}' for v in valid)}; "
          f"{LM_TIMED_STEPS} steps on a batch of {egs['src'].shape}: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, median "
          f"{statistics.median(step_secs):.4f} s of "
          f"{', '.join(f'{v:.4f}' for v in step_secs)} s (host clock around "
          f"a synchronised step), peak memory {peak:.3f} GiB; pass with "
          f"dropout off card vs CPU: loss {loss_g:.6f} vs {loss_c:.6f}, "
          "gradients relative to the largest entry "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" ({card})", flush=True)
    return launches, statistics.median(step_secs), peak


@contextlib.contextmanager
def parent_precision(*modules):
    """The commands as they ran before they stated their precision: torch's
    defaults for the TF32 flags (cuBLAS off, cuDNN on) and no scoping."""
    import torch
    saved = [m.matmul_precision for m in modules]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for m in modules:
        m.matmul_precision = lambda *args: contextlib.nullcontext()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        for m, real in zip(modules, saved):
            m.matmul_precision = real
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags


def precision_phase(root: Path, cpt: Path, sep_root: Path, tcn_cpt: Path,
                    card):
    """decode_batch (DECODE_ARGS) and separate (batches of SEP_BATCH) as
    the commands run now (float32: both TF32 flags off) and as they ran
    before (torch's defaults: cuDNN's convolutions at TF32), in turns
    (now, before, before, now): the seconds of each batch; the device time
    of a whole command run, profiled, in the first turn of each (a
    profiled run's trace takes some 20 s of the host to read)."""
    from aps_tpu_torch.cmd import decode_batch, separate
    from aps_tpu_torch.cmd.profile_decode import profile
    runs = {"now": [], "before": []}
    for turn, tag in enumerate(("now", "before", "before", "now")):
        scope = parent_precision(decode_batch, separate) \
            if tag == "before" else contextlib.nullcontext()
        with scope, contextlib.redirect_stdout(sys.stderr):
            dec = decode_batch.main(
                [str(root / "wav.scp"), str(root / "best.precision"), "--am",
                 str(cpt), "--dict", str(root / "dict")] + DECODE_ARGS)
            dec_ms = profile(lambda: decode_batch.main(
                [str(root / "wav.scp"), str(root / "best.precision"), "--am",
                 str(cpt), "--dict", str(root / "dict")] + DECODE_ARGS))[0] \
                if turn < 2 else None
            sep_argv = [str(sep_root / "mix.scp"),
                        str(sep_root / "sep.precision"), "--checkpoint",
                        str(tcn_cpt), "--sr", str(SEP_SR), "--batch-size",
                        str(SEP_BATCH)]
            sep = separate.main(sep_argv)
            sep_ms = profile(lambda: separate.main(sep_argv))[0] \
                if turn < 2 else None
        runs[tag].append((dec["batch_secs"], sep["batch_secs"], dec_ms,
                          sep_ms))
    for tag, entries in runs.items():
        print(f"precision {tag} ("
              f"{'float32' if tag == 'now' else 'TF32 in cuDNN'}): "
              "decode_batch batches of 8 "
              + " | ".join(", ".join(f"{v:.4f}" for v in e[0])
                           for e in entries)
              + f" s; separate batches of {SEP_BATCH} "
              + " | ".join(", ".join(f"{v:.4f}" for v in e[1])
                           for e in entries)
              + " s (host clock around a synchronised batch); device time "
              "of a whole command run (profiled, loading included): "
              "decode_batch " + " | ".join(f"{e[2]:.3f}" for e in entries
                                           if e[2] is not None)
              + " ms, separate " + " | ".join(f"{e[3]:.3f}" for e in entries
                                             if e[3] is not None)
              + f" ms ({card})", flush=True)
    return runs


# the multi-channel slice: examples/asr/chime4/run.sh stages 2, 4 and 5
# with conf/1b.yaml (asr@enh_xfmr: a 3 x 512 BLSTM mask estimator and the
# MVDR, then 12 cfmr/rel layers at 256 and 6 decoder layers) as written
# but for one change, the asr transform's feats (CHIME4_FEATS: aps_tpu's
# fbank-log-cmvn frames the beamformed magnitude as samples and fails), on
# 5-channel audio; then examples/sse/chime4_ml/run.sh stages 2 and 3 with
# conf/1a.yaml as written (sse@rnn_enh_ml under sse@enh_ml)
CHIME4_YAML = "examples/asr/chime4/conf/1b.yaml"
CHIME4_LM_YAML = "examples/asr/chime4/conf/nnlm/1a.yaml"
CHIME4_ML_YAML = "examples/sse/chime4_ml/conf/1a.yaml"
CHIME4_FEATS = "abs-mel-log-cmvn"
CHIME4_CHANNELS = 5  # the recipe's CH1, CH3-CH6
CHIME4_SECS = 8
CHIME4_TRAIN_UTTS = 32  # run.sh's --batch-size
CHIME4_TRAIN_EPOCHS = 2  # one step each: the corpus is one batch
CHIME4_TIMED_STEPS = 5
CHIME4_DECODE_UTTS = 8  # one batch of decode_batch's 8
# of the decode, in the card-vs-CPU search; one: the CPU's search with the
# LM over 5 channels is the decode's longest part
CHIME4_CHECK_UTTS = 1
CHIME4_PASS_UTTS = 4  # of the batch, in the card-vs-CPU training pass
# run.sh stage 4 (beam 16, nbest 8, ctc 0.4, the char RNN LM at 0.2,
# len_norm true), max_len cut from 200 to CHIME4_MAX_LEN search steps
CHIME4_MAX_LEN = 40
CHIME4_STAGE4_ARGS = ["--beam-size", "16", "--nbest", "8", "--ctc-weight",
                      "0.4", "--lm-weight", "0.2", "--len-norm", "true",
                      "--max-len", str(CHIME4_MAX_LEN), "--space", "<space>"]
CHIME4_UNITS = [chr(c) for c in range(ord("a"), ord("z") + 1)] + \
    ["'", "<space>"]
# the mask network's first layer, the MVDR's reference attention, the
# encoder's first in_proj and the CTC head
CHIME4_GRADS = ("enh_net.mask_net.impl.layer_0.cells.weight_ih_l0",
                "enh_net.mvdr_net.ref.linear1.weight",
                "encoder.encoder.layers.0.self_attn.in_proj.weight",
                "ctc_head.weight")
ML_SECS = 4  # the recipe's chunk_size of 64000 samples
ML_UTTS = 16  # run.sh's --batch-size
ML_EPOCHS = 2  # one step each
ML_TIMED_STEPS = 3
ML_SEP_UTTS = 4
ML_GRADS = ("base_rnn.proj.weight",
            "base_rnn.impl.layer_0.cells.weight_ih_l0",
            "base_rnn.impl.layer_2.cells.weight_hh_l0_reverse",
            "base_rnn.outp.weight")
# the beamformer's output (the enhanced magnitude) with the TF32 flags
# set against float32 on the card, relative to its largest entry: the
# mask network's products and the complex covariances with operands
# rounded to 10 bits, then the solve
TOL_TF32_BEAM = 2e-2


def write_multichannel(root: Path, prefix: str, count: int, gen, secs,
                       channels=CHIME4_CHANNELS):
    """count seeded C-channel recordings of secs: one source (noise under
    a modulated tone) reaching each microphone 2 samples later than the
    one before, and noise of each channel's own at a quarter of the
    source's level, as 16-bit files root/<prefix>NN.wav and root/wav.scp
    -> {key: C x S samples as the readers give them back}."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    wavs = {}
    S = int(secs * SR)
    t = np.arange(S) / SR
    with open(root / "wav.scp", "w") as scp:
        for n in range(count):
            noise = torch.randn((channels + 1, S), generator=gen).numpy()
            f0 = 150.0 + 20.0 * n
            src = 0.05 * noise[0] + 0.2 * np.sin(2 * np.pi * f0 * t) * \
                (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
            wav = np.stack([np.roll(src, 2 * c) + 0.05 * noise[c + 1]
                            for c in range(channels)])
            pcm = np.clip(np.round(wav * 32768), -32768, 32767).astype(
                np.int16)
            path = root / f"{prefix}{n:02d}.wav"
            wavfile.write(str(path), SR, pcm.T)
            scp.write(f"{prefix}{n:02d}\t{path}\n")
            wavs[f"{prefix}{n:02d}"] = pcm.astype(np.float32) / 32768
    return wavs


def chime4_conf(data: Path) -> dict:
    """CHIME4_YAML as written but for the asr transform's feats, its data
    sections pointed at data/."""
    from aps_tpu_torch.conf import load_yaml
    conf = load_yaml(str(REPO / CHIME4_YAML))
    if conf["asr_transform"]["feats"] != "fbank-log-cmvn":
        fail(f"{CHIME4_YAML}: asr_transform {conf['asr_transform']}")
    conf["asr_transform"]["feats"] = CHIME4_FEATS
    paths = {name: str(data / name) for name in ("text", "utt2dur")}
    paths["wav_scp"] = str(data / "wav.scp")
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = paths
    return conf


def write_chime4(root: Path, gen):
    """root/dict (the char units, <sos>, <eos>, <unk>) and root/train: a
    corpus of CHIME4_TRAIN_UTTS 5-channel utterances of CHIME4_SECS with
    TRAIN_LABELS seeded chars each and train.yaml (chime4_conf)."""
    import torch
    vocab = ["<unk>"] + CHIME4_UNITS + ["<sos>", "<eos>"]
    (root / "dict").write_text("".join(f"{u} {i}\n"
                                       for i, u in enumerate(vocab)))
    data = root / "train"
    data.mkdir()
    keys = sorted(write_multichannel(data, "trn", CHIME4_TRAIN_UTTS, gen,
                                     CHIME4_SECS))
    labels = torch.randint(0, len(CHIME4_UNITS),
                           (CHIME4_TRAIN_UTTS, TRAIN_LABELS),
                           generator=gen).tolist()
    with open(data / "text", "w") as text, \
            open(data / "utt2dur", "w") as dur:
        for key, toks in zip(keys, labels):
            text.write(f"{key} {' '.join(CHIME4_UNITS[i] for i in toks)}\n")
            dur.write(f"{key} {CHIME4_SECS:.2f}\n")
    (data / "train.yaml").write_text(json.dumps(chime4_conf(data),
                                                indent=2))
    return data


def chime4_launches(passes: int = 0, steps: int = 0):
    """The launch counts of `passes` eval-mode forwards (validation or a
    decode batch: K3's forward once a layer) and `steps` search steps (K4
    once each) of the chime4 model; its training passes launch nothing
    (att_dropout 0.2: the dense attention path), nor does its front end
    (no K1: the features start from the beamformed magnitude)."""
    from aps_tpu_torch.ops import build
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want.update({"flash_attention_rel": ENC_LAYERS * passes,
                 "ctc_score_step": steps})
    return want


def no_dropout(module):
    """module with every dropout off (nn.Dropout and the attention's rate,
    which also sends training through the flash kernels)."""
    import torch
    for mod in module.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    return module


def chime4_train_phase(root: Path, data: Path, dev, card):
    """train_am (run.sh stage 2) on the corpus: CHIME4_TRAIN_EPOCHS
    one-step epochs, launch counts over the run; then CHIME4_TIMED_STEPS
    timed steps on the same batch, each counted (nothing launched), one
    traced; the batch's loss with dropouts off before and after them must
    fall. -> (cpt, the batch, launches of the run, numbers)."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.trainer.dp import to_device
    cpt = root / "exp"
    argv = ["--conf", str(data / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(CHIME4_TRAIN_UTTS),
            "--epochs", str(CHIME4_TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    model = trainer.task.nnet
    setup = (trainer.device.type, trainer.cur_step, trainer.matmul_precision,
             type(trainer.optimizer).__name__, type(model).__name__,
             type(model.enh_net).__name__, len(model.encoder.encoder.layers),
             model.asr_transform.feats)
    if setup != ("cuda", CHIME4_TRAIN_EPOCHS, "bfloat16", "AdamW",
                 "EnhXfmrASR", "RNNMaskMvdr", ENC_LAYERS, CHIME4_FEATS):
        fail(f"train_am ({CHIME4_YAML}) is not as written: {setup}")
    # a validation pass before the first epoch and after each
    want = chime4_launches(passes=CHIME4_TRAIN_EPOCHS + 1)
    if launches != want:
        fail(f"train_am ({CHIME4_YAML}) launches {launches}, expected "
             f"{want}")
    egs = first_batch(root, data, CHIME4_TRAIN_UTTS)
    shape = (CHIME4_TRAIN_UTTS, CHIME4_CHANNELS)
    if tuple(egs["src_pad"].shape[:2]) != shape:
        fail(f"the loader's batch is {egs['src_pad'].shape}, not {shape} x S")
    batch = to_device(egs, dev)
    probe = no_dropout(copy.deepcopy(trainer.task)).train()

    def loss_now():
        probe.load_state_dict(trainer.task.state_dict())
        with torch.no_grad():
            return probe(batch)["loss"].item()

    before = loss_now()
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for step in range(CHIME4_TIMED_STEPS):
        build.reset_launches()
        done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        if not done or any(build.LAUNCHES.values()):
            fail(f"timed step {step}: done {done}, launches "
                 f"{dict(build.LAUNCHES)}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, wall, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    after = loss_now()
    losses = _epoch_losses(cpt / "trainer.log", "train") + \
        [float(v) for v in trainer.reporter.stats["loss"]]
    lr = trainer.optimizer.param_groups[0]["lr"]
    if not all(map(math.isfinite, losses + [before, after])):
        fail(f"non-finite chime4 loss: {losses}, {before}, {after}")
    if not after < before:
        fail(f"the loss with dropouts off did not fall over the timed "
             f"steps: {before} -> {after}")
    rnn, gemm, fft = rnn_share(prof, device_ms)
    print(f"train_am {CHIME4_YAML} as written (feats {CHIME4_FEATS}): "
          f"{CHIME4_TRAIN_UTTS} x {CHIME4_CHANNELS} x {CHIME4_SECS} s, "
          f"{CHIME4_TRAIN_EPOCHS} one-step epochs, launches {launches}; "
          f"{CHIME4_TIMED_STEPS + 1} more steps on the same batch (no "
          f"launches; warmup_noam_lr at {lr:.3e}); training losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; the batch's loss with "
          f"dropouts off {before:.6f} -> {after:.6f}", flush=True)
    print(f"chime4 1b step: device {device_ms:.3f} ms (traced; cuDNN's "
          f"recurrences {rnn:.3f}, cuBLAS {gemm:.3f}, cuFFT {fft:.3f} of "
          f"it), host {statistics.median(secs):.4f} s median of "
          f"{', '.join(f'{v:.4f}' for v in secs)} (traced {wall:.4f} s, "
          f"{host_launches} launches), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    print(f"chime4 1b step, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    return cpt, egs, launches, {"device_ms": device_ms, "peak_gib": peak,
                                "host_s": statistics.median(secs),
                                "launches": host_launches}


def chime4_model(conf: dict, gen):
    """conf's asr@enh_xfmr (as load_am_conf gives it: the vocabulary's
    size, sos, eos and blank filled in) with every dropout off and seeded
    weights, in its task."""
    from aps_tpu_torch.flagship import init_weights
    from aps_tpu_torch.libs import aps_asr_nnet, aps_task, aps_transform
    nnet_conf = dict(conf["nnet_conf"])
    model = aps_asr_nnet(conf["nnet"])(
        asr_transform=aps_transform("asr")(**conf["asr_transform"]),
        enh_transform=aps_transform("enh")(**conf["enh_transform"]),
        **nnet_conf)
    init_weights(no_dropout(model), gen)
    return aps_task(conf["task"], model, **conf["task_conf"])


def chime4_beam_check(conf: dict, egs, dev, gen, card):
    """The front end (enh transform, mask network, MVDR) on the batch:
    TF32 against float32 on the card; the times of the covariance, the
    solve and the beamforming at this batch."""
    import torch

    from aps_tpu_torch.asr.filter.mvdr import beamform, estimate_covar
    from aps_tpu_torch.cplx import solve_hermitian
    model = chime4_model(conf, gen).nnet.to(dev).eval()
    x = torch.from_numpy(egs["src_pad"]).to(dev)
    x_len = torch.as_tensor(egs["src_len"]).to(dev)
    outs = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.no_grad():
            cstft, frames = model.enh_transform.encode(x, x_len)
            feats = model.enh_transform(cstft)
            outs[tf32] = model.enh_net(feats, cstft, inp_len=frames).abs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scale = outs[False].abs().max().item()
    err = (outs[True] - outs[False]).abs().max().item() / scale
    if not (math.isfinite(err) and err <= TOL_TF32_BEAM):
        fail(f"beamformer output TF32 vs float32: {err} of the largest "
             f"entry, over {TOL_TF32_BEAM}")
    print(f"chime4 front end on {tuple(cstft.shape)} bins: TF32 vs float32 "
          f"{err:.3e} of the largest enhanced magnitude ({card})",
          flush=True)
    # the MVDR's parts, float32, at the training batch and at a decode
    # batch's CHIME4_DECODE_UTTS
    ms = {}
    for N in (cstft.shape[0], CHIME4_DECODE_UTTS):
        x_N = cstft[:N]
        _, C, F, T = x_N.shape
        mask = torch.rand((N, F, T), generator=gen).to(dev)
        with torch.no_grad():
            Rs = estimate_covar(mask, x_N)
            Rn = estimate_covar(1 - mask, x_N) + \
                1e-5 * torch.eye(C, device=dev)
            w = torch.randn((N, C, F), dtype=torch.complex64,
                            generator=gen).to(dev)
            ms[N] = {"covariance": time_ms(lambda: estimate_covar(mask, x_N)),
                     "solve": time_ms(lambda: solve_hermitian(Rn, Rs)),
                     "beamform": time_ms(lambda: beamform(w, x_N))}
        print(f"chime4 MVDR at {N} x {C} x {F} x {T} bins, device ms "
              f"(float32, one call between events): speech covariance "
              f"{ms[N]['covariance']:.4f}, Hermitian solve "
              f"{ms[N]['solve']:.4f} (the clamped Cholesky of {C} x {C} and "
              f"two triangular solves), beamforming {ms[N]['beamform']:.4f} "
              f"({card})", flush=True)
    return err, ms


def chime4_shapes(model, S):
    """(T, k_len) of a decode batch of CHIME4_SECS utterances padded to S
    samples: encoder frames and the valid ones."""
    import torch
    frames = model.enh_transform.num_frames(
        torch.tensor([S, CHIME4_SECS * SR]))
    T, k_len = model.encoder.num_frames(frames).tolist()
    return T, k_len


def write_decodable(cpt: Path, root: Path) -> Path:
    """The trained checkpoint with its decoder output and CTC head x 8
    (peaky: well separated candidates, so the CPU and card searches cannot
    part on near-ties after a few steps of training) -> root/decode_am."""
    out = root / "decode_am"
    out.mkdir()
    with open(cpt / "last.ckpt", "rb") as fd:
        state = pickle.load(fd)
    params = state["params"]
    params = params.get("nnet", params)
    params["decoder"]["output"]["kernel"] = \
        params["decoder"]["output"]["kernel"] * 8.0
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8.0
    with open(out / "best.ckpt", "wb") as fd:
        pickle.dump(state, fd)
    (out / "train.yaml").write_bytes((cpt / "train.yaml").read_bytes())
    return out


def chime4_decode_phase(root: Path, am: Path, lm_dir: Path, gen, dev,
                        card):
    """run.sh stages 4 and 5: CHIME4_DECODE_UTTS 5-channel utterances
    through decode_batch with CHIME4_STAGE4_ARGS and the char RNN LM
    (--channel -1), launch counts read (K3's forward 12 a batch, K4 once a
    search step, nothing else), compute_wer; one batch profiled; the first
    CHIME4_CHECK_UTTS card vs CPU, n-best equal and scores within 1e-3.
    -> (launches, (T, k_len), numbers)."""
    import io

    from aps_tpu_torch.asr.beam_search.lm import lm_adapter
    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    import torch

    from aps_tpu_torch.cmd import compute_wer, decode, decode_batch
    from aps_tpu_torch.cmd.decode_batch import quantize_dur
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.ops import build
    data = root / "test"
    data.mkdir()
    wavs = write_multichannel(data, "tst", CHIME4_DECODE_UTTS, gen,
                              CHIME4_SECS)
    # the reference text of stage 5: seeded chars, TRAIN_LABELS an
    # utterance, words split at <space>
    labels = torch.randint(0, len(CHIME4_UNITS),
                           (CHIME4_DECODE_UTTS, TRAIN_LABELS),
                           generator=gen).tolist()
    (data / "text").write_text("".join(
        f"{key} " + "".join(" " if CHIME4_UNITS[i] == "<space>" else
                            CHIME4_UNITS[i] for i in toks).strip() + "\n"
        for key, toks in zip(sorted(wavs), labels)))
    best = root / "test.decode"
    argv = [str(data / "wav.scp"), str(best), "--am", str(am), "--dict",
            str(root / "dict"), "--lm", str(lm_dir)] + CHIME4_STAGE4_ARGS
    build.reset_launches()
    with scorer_steps() as steps:
        stats = decode_batch.main(argv)
    launches = dict(build.LAUNCHES)
    lines = best.read_text().splitlines()
    if sorted(ln.split("\t")[0] for ln in lines) != sorted(wavs) or \
            not all(map(math.isfinite, stats["scores"].values())):
        fail(f"chime4 decode_batch: {len(lines)} lines, scores "
             f"{list(stats['scores'].values())}")
    batches = len(stats["batch_secs"])
    want = chime4_launches(passes=batches, steps=len(steps))
    if launches != want or batches != 1:
        fail(f"chime4 decode launches {launches} in {batches} batches and "
             f"{len(steps)} search steps, expected {want}")
    # stage 5: compute_wer against the reference text
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        compute_wer.main([str(best), str(data / "text")])
    if not re.search(rf"Total \({CHIME4_DECODE_UTTS} utterances\)",
                     report.getvalue()):
        fail(f"compute_wer printed {report.getvalue()!r}")
    kw = decode.search_kwargs(decode_batch.make_parser().parse_args(argv))
    am_state = load_checkpoint(str(am))
    nnet = am_state["nnet"]
    lm = load_checkpoint(str(lm_dir))["nnet"]
    sos, eos = (am_state["conf"]["nnet_conf"][k] for k in ("sos", "eos"))
    S = quantize_dur(CHIME4_SECS * SR)
    shapes = chime4_shapes(nnet, S)
    keys = sorted(wavs)
    batch = [wavs[k] for k in keys]
    search = lambda: beam_search_batch(  # noqa: E731
        nnet.to(dev), batch, lm=lm_adapter(lm.to(dev), max_len=CHIME4_MAX_LEN,
                                           sos=sos),
        sos=sos, eos=eos, device=dev, pad_to=S, **kw)
    search()
    build.reset_launches()
    device_ms, wall, host_launches, _ = profile(search)
    n_steps = build.LAUNCHES["ctc_score_step"]
    outs = {}
    for where in ("cpu", dev):
        outs[str(where)] = beam_search_batch(
            nnet.to(where), batch[:CHIME4_CHECK_UTTS],
            lm=lm_adapter(lm.to(where), max_len=CHIME4_MAX_LEN, sos=sos),
            sos=sos, eos=eos, device=where, pad_to=S, **kw)
    score_err = 0.0
    for key, hc, hg in zip(keys, outs["cpu"], outs[str(dev)]):
        err = nbest_error(hc, hg)
        if err is None:
            fail(f"{key}: card and CPU n-best lists differ")
        score_err = max(score_err, err)
        if abs(hg[0]["score"] - stats["scores"][key]) > 1e-3:
            fail(f"{key}: decode_batch score {stats['scores'][key]} != "
                 f"search score {hg[0]['score']}")
    if not score_err <= 1e-3:
        fail(f"chime4 n-best scores card vs CPU differ by {score_err}")
    print(f"chime4 decode_batch {' '.join(CHIME4_STAGE4_ARGS)} with the char "
          f"RNN LM: {CHIME4_DECODE_UTTS} x {CHIME4_CHANNELS} x "
          f"{CHIME4_SECS} s padded to {S} samples (T = {shapes[0]}, "
          f"{shapes[1]} valid), {stats['batch_secs'][0]:.4f} s (host clock "
          f"around the synchronised batch), {len(steps)} search steps, "
          f"launches {launches}; profiled: device {device_ms:.3f} ms in "
          f"{wall:.4f} s wall, {n_steps} steps, "
          f"{host_launches / max(n_steps, 1):.1f} host launches a step "
          f"({card}); compute_wer: "
          f"{' | '.join(report.getvalue().splitlines())}", flush=True)
    print(f"chime4 search card vs CPU on {CHIME4_CHECK_UTTS} utterances: "
          f"n-best of {len(outs['cpu'][0])} equal, largest score diff "
          f"{score_err:.3e} ({card})", flush=True)
    return launches, shapes, {"device_ms": device_ms, "wall": wall,
                              "batch_s": stats["batch_secs"][0],
                              "score_err": score_err}


def chime4_ml_phase(root: Path, gen, dev, card):
    """examples/sse/chime4_ml/run.sh stages 2 and 3 with CHIME4_ML_YAML as
    written: train_ss on ML_UTTS 5-channel recordings of ML_SECS (one
    batch of the recipe's chunks), ML_EPOCHS one-step epochs and timed
    steps on the same batch, one traced, no kernel launched; one training
    pass card vs CPU at float32; separate on ML_SEP_UTTS recordings with
    the trained checkpoint (the masks, written as aps_tpu writes them),
    card vs CPU on two. -> (launches of training, of separation)."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import separate, train_ss
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.flagship import init_weights
    from aps_tpu_torch.libs import (aps_dataloader, aps_sse_nnet, aps_task,
                                    aps_transform)
    from aps_tpu_torch.ops import build
    beg = time.perf_counter()
    root.mkdir()
    trn = root / "trn"
    trn.mkdir()
    write_multichannel(trn, "trn", ML_UTTS, gen, ML_SECS)
    conf = load_ss_conf(str(REPO / CHIME4_ML_YAML))
    if conf["data_conf"]["loader"]["chunk_size"] != ML_SECS * SR:
        fail(f"{CHIME4_ML_YAML}: {conf['data_conf']['loader']}")
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = {
        "mix_scp": str(trn / "wav.scp")}
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    cpt = root / "exp"
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_ss.main([
            "--conf", str(root / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", str(ML_UTTS), "--epochs", str(ML_EPOCHS),
            "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if trainer.device.type != "cuda" or trainer.cur_step != ML_EPOCHS or \
            any(launches.values()):
        fail(f"train_ss ({CHIME4_ML_YAML}): {trainer.cur_step} steps on "
             f"{trainer.device}, launches {launches}")
    batches = list(aps_dataloader(fmt="se@chunk", train=False,
                                  max_batch_size=ML_UTTS,
                                  **conf["data_conf"]["loader"],
                                  **conf["data_conf"]["valid"]))
    shape = (ML_UTTS, CHIME4_CHANNELS, ML_SECS * SR)
    if len(batches) != 1 or batches[0]["mix"].shape != shape:
        fail(f"expected one batch of {shape}, got "
             f"{[b['mix'].shape for b in batches]}")
    egs = batches[0]
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for step in range(ML_TIMED_STEPS):
        done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        if not done:
            fail(f"timed step {step} was skipped (non-finite loss or norm)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, wall, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    if any(build.LAUNCHES.values()):
        fail(f"chime4_ml steps launch {dict(build.LAUNCHES)}")
    losses = _epoch_losses(cpt / "trainer.log", "train") + \
        [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite sse@enh_ml loss: {losses}")
    rnn, gemm, fft = rnn_share(prof, device_ms)
    print(f"train_ss {CHIME4_ML_YAML} as written (spectrogram-log-cmvn-ipd, "
          f"input {conf['nnet_conf']['input_size']}, 3 x 512 BLSTM, "
          f"sse@enh_ml): {ML_UTTS} x {CHIME4_CHANNELS} x {ML_SECS} s, "
          f"{ML_EPOCHS} one-step epochs then {ML_TIMED_STEPS + 1} steps on "
          f"the same batch, no kernel launches; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
    print(f"chime4_ml step: device {device_ms:.3f} ms (traced; cuDNN's "
          f"recurrences {rnn:.3f}, cuBLAS {gemm:.3f}, cuFFT {fft:.3f} of "
          f"it), host {statistics.median(secs):.4f} s median of "
          f"{', '.join(f'{v:.4f}' for v in secs)} (traced {wall:.4f} s, "
          f"{host_launches} launches), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    print(f"chime4_ml step, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    # one pass card vs CPU at float32, dropout off, seeded weights
    nnet = aps_sse_nnet(conf["nnet"])(
        enh_transform=aps_transform("enh")(**conf["enh_transform"]),
        **dict(conf["nnet_conf"], dropout=0.0))
    init_weights(nnet, gen)
    loss_g, loss_c, errs = step_pass_check(
        aps_task(conf["task"], nnet, **conf["task_conf"]), egs, dev,
        ML_GRADS, WHAM_CHECK_UTTS, referee=False)
    print(f"chime4_ml training pass card vs CPU at float32 (dropout off, "
          f"TF32 flags read off inside) on {WHAM_CHECK_UTTS} recordings: "
          f"loss {loss_g:.6f} vs {loss_c:.6f}; gradient errors relative to "
          "the largest entry " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items()) +
          f" ({card})", flush=True)
    # run.sh stage 3
    dev_dir = root / "dev"
    dev_dir.mkdir()
    mixes = write_multichannel(dev_dir, "dev", ML_SEP_UTTS, gen, ML_SECS)
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = separate.main([str(dev_dir / "wav.scp"), str(root / "enhan"),
                               "--checkpoint", str(cpt), "--tag", "last",
                               "--sr", str(SR)])
    torch.cuda.synchronize()
    launches_sep = dict(build.LAUNCHES)
    if any(launches_sep.values()) or stats["utts"] != ML_SEP_UTTS:
        fail(f"chime4_ml separate: {stats['utts']} utterances, launches "
             f"{launches_sep}")
    seps = {w: separate.Separator(str(cpt), cpt_tag="last", device=w)
            for w in ("cpu", "cuda")}
    keys = sorted(mixes)[:2]
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: [s.run(mixes[k]) for k in keys] for w, s in seps.items()}
    got = np.concatenate([np.ravel(a) for a in outs["cuda"]])
    want = np.concatenate([np.ravel(a) for a in outs["cpu"]])
    T = (ML_SECS * SR) // 256  # the masks of the padded input's frames
    scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
    if not (scale > 0 and err <= TOL_SEP_REL * scale) or \
            outs["cuda"][0].shape[1] != 257 or \
            not outs["cuda"][0].shape[0] >= T:
        fail(f"chime4_ml masks card vs CPU: {err} over {TOL_SEP_REL} of "
             f"{scale}, shape {outs['cuda'][0].shape}")
    rate = stats["audio_secs"] / stats["sep_secs"]
    print(f"chime4_ml separate (run.sh stage 3, --channel -1): "
          f"{ML_SEP_UTTS} x {CHIME4_CHANNELS} x {ML_SECS} s, "
          f"{rate:.2f} audio-s/s (host clock, batch 1), masks "
          f"{outs['cuda'][0].shape} written as aps_tpu's separate writes "
          f"them (a WAV file whose channels are the bins); card vs CPU on "
          f"2 recordings {err:.3e} (largest mask {scale:.3f}); no kernel "
          f"launches; the phase took {time.perf_counter() - beg:.1f} s "
          f"({card})", flush=True)
    return launches, launches_sep, {"device_ms": device_ms, "peak_gib": peak,
                                    "rate": rate}


def dense_attention(task) -> None:
    """A witness of the chime4 training pass: every attention of `task` on
    the dense path, so the pass launches no K3 kernel."""
    from aps_tpu_torch.asr.transformer.impl import ApsMultiheadAttention
    for module in task.modules():
        if isinstance(module, ApsMultiheadAttention):
            module._flash = lambda *args: None


# the pass at more weights and utterances than the phase's own: (the seed
# of the model's weights, the seed of a corpus of its own (write_chime4)
# or None for the phase's, the first of the CHIME4_PASS_UTTS utterances).
# The last one failed the referee rule when the CPU's distance came from
# one float32 pass: the card's gradient of the mask network's first LSTM
# weight 1.16e-2 of the largest entry from float64, against a bound of
# 5.9e-3 (the CPU 3.9e-4; probes/chime4_referee.py on an NVIDIA H100 80GB
# HBM3, 700.00 W). Float64 passes there move by up to 1.2e-2 when the
# MVDR's covariances are moved by one float32 rounding: the gradients in
# front of the MVDR's solve are ill-conditioned, every float32 pass on
# either device lands anywhere in a wide spread (the CPU's own, on inputs
# moved by one rounding: 3.9e-4 to 4.2e-2 there), and no single part in
# float64 removes the card's distance at every draw (the probe's
# witnesses). So each pass also runs CHIME4_CPU_DRAWS such CPU passes,
# and the bound takes their largest distance as it is (step_pass_check's
# cpu_draws), which a missing term of TOL_SEP_GRAD_REFEREE must still
# exceed
CHIME4_PASS_DRAWS = ((SEED + 11, None, 4), (SEED + 12, None, 8),
                     (SEED + 43, SEED + 30, 12))
CHIME4_CPU_DRAWS = 2


# the K3 kernels of a training pass on the flash path (every dropout off)
K3_TRAIN = ("flash_attention_rel", "flash_attention_rel_dq",
            "flash_attention_rel_dkv", "flash_attention_rel_dpose")


def chime4_pass_check(conf, egs, dev, gen, card, root: Path):
    """The 1b training pass card vs CPU at float32, held by the referee
    rule with a float64 pass on the card on the dense path (K3 takes
    float32 only; the dense float64 pass lands within 1.6e-9 of the
    CPU's, probes/chime4_referee.py): the MVDR's solve passes the gradients of the
    mask network and of the reference attention through covariances of
    delayed copies, so a float32 pass on either device lands some 1e-3
    from the float64 one. The pass runs at the phase's own weights (drawn
    from gen) on the batch's first utterances, then at each of
    CHIME4_PASS_DRAWS (a corpus of its own written under root), each with
    CHIME4_CPU_DRAWS CPU passes on inputs moved by one float32 rounding
    (CHIME4_PASS_DRAWS' comment) and a planted missing term that must
    fail the bound.
    -> (K3's (B, H, T, D, Hp, k_len, causal) in the pass, numbers)"""
    import torch
    numbers = {"pass_loss": {}, "pass_grads": {}}
    runs = [("phase", gen, egs)]
    for seed, corpus, first in CHIME4_PASS_DRAWS:
        source = egs
        if corpus is not None:
            (root / f"corpus{corpus}").mkdir()
            data = write_chime4(root / f"corpus{corpus}",
                                torch.Generator().manual_seed(corpus))
            source = first_batch(root / f"corpus{corpus}", data,
                                 CHIME4_TRAIN_UTTS)
        rows = slice(first, first + CHIME4_PASS_UTTS)
        runs.append((seed, torch.Generator().manual_seed(seed),
                     {k: v[rows] for k, v in source.items()
                      if not k.startswith("#")}))
    for label, weights, batch in runs:
        launched = {}
        with training_operands() as seen:
            loss_g, loss_c, errs = step_pass_check(
                chime4_model(conf, weights), batch, dev, CHIME4_GRADS,
                CHIME4_PASS_UTTS, referee=True, launched=launched,
                cpu_draws=CHIME4_CPU_DRAWS, referee_patch=dense_attention)
        if not all(launched["card32"].get(k, 0) > 0 for k in K3_TRAIN):
            fail(f"the chime4 pass launched {launched['card32']}, expected "
                 f"each of {K3_TRAIN}")
        if any(launched["card64"].get(k, 0) for k in K3_TRAIN):
            fail(f"the dense float64 pass launched {launched['card64']}")
        print(f"chime4 1b training pass at float32 (dropouts off, TF32 "
              f"flags read off inside; float32 matmul precision "
              f"{torch.get_float32_matmul_precision()}) on "
              f"{CHIME4_PASS_UTTS} utterances, weights of seed {label}: "
              f"loss card {loss_g:.6f} vs CPU {loss_c:.6f}; the gradients' "
              "distance from the card's float64 pass (dense) relative to "
              "the largest entry (card with K3, the CPU's float32 pass, "
              f"the largest of its {CHIME4_CPU_DRAWS} passes on inputs "
              "moved by one rounding, the bound, a planted missing term "
              f"of {TOL_SEP_GRAD_REFEREE}) "
              + ", ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in e)
                          for k, e in errs.items())
              + f"; K3 launches in the card's pass {launched['card32']} "
              f"({card})", flush=True)
        if label == "phase":
            shapes = sorted(set(seen["rel"]), key=seen["rel"].index)
        numbers["pass_loss"][label] = (loss_g, loss_c)
        numbers["pass_grads"][label] = errs
    return shapes, numbers


def chime4_phase(root: Path, gen, dev, card):
    """The chime4 recipe: write_chime4, chime4_train_phase,
    chime4_pass_check, chime4_beam_check, the char RNN LM of
    CHIME4_LM_YAML (seeded), chime4_decode_phase; then chime4_ml_phase.
    -> (launch counts of each path, the decode's (T, k_len), K3's shapes
    in the training pass, numbers)."""
    beg = time.perf_counter()
    root.mkdir()
    data = write_chime4(root, gen)
    with phase("chime4 / train_am"):
        cpt, egs, launches_train, numbers = chime4_train_phase(
            root, data, dev, card)
    from aps_tpu_torch.conf import load_am_conf
    conf, _ = load_am_conf(str(data / "train.yaml"), str(root / "dict"))
    with phase("chime4 / passes card vs CPU"):
        pass_shapes, pass_numbers = chime4_pass_check(conf, egs, dev, gen,
                                                      card, root)
    numbers.update(pass_numbers)
    with phase("chime4 / beamformer"):
        numbers["tf32_beam"], numbers["mvdr_ms"] = chime4_beam_check(
            conf, egs, dev, gen, card)
    lm_dir, _ = write_lm(root, CHIME4_LM_YAML, gen, "rnn_lm")
    with phase("chime4 / decode"):
        launches_dec, shapes, dec_numbers = chime4_decode_phase(
            root, write_decodable(cpt, root), lm_dir, gen, dev, card)
    numbers.update(decode=dec_numbers, phase_s=time.perf_counter() - beg)
    print(f"the chime4 phase took {numbers['phase_s']:.1f} s ({card})",
          flush=True)
    with phase("chime4 / chime4_ml"):
        launches_ml, launches_ml_sep, numbers["ml"] = chime4_ml_phase(
            root / "ml", gen, dev, card)
    return launches_train, launches_dec, launches_ml, launches_ml_sep, \
        shapes, pass_shapes, numbers


# the RNN attention slice: examples/asr/wsj/run.sh stages 2 and 4 with
# conf/1a.yaml as written (asr@att: conv2d on the three delta orders as
# channels -> 3 x 512 BLSTM, ctx attention, a 2 x 512 input-feeding LSTM
# decoder, asr@ctc_xent, Adam, clip 5, TF32) and the char RNN LM of
# conf/nnlm/1a.yaml (seeded) at 0.6; examples/asr/timit/run.sh stages 2
# and 4 with conf/1a.yaml as written but for one patch, its schedule
# sampling's window (variant_rnn 3 x 320 BLSTM with projections, loc
# attention of 201 taps, linear schedule sampling). K1 and K4 are the
# path's kernels: the fbank-log pair of both transforms, and the CTC
# fusion of every search step
WSJ_YAML = "examples/asr/wsj/conf/1a.yaml"
WSJ_LM_YAML = "examples/asr/wsj/conf/nnlm/1a.yaml"
TIMIT_YAML = "examples/asr/timit/conf/1a.yaml"
ATT_TRAIN_UTTS = 32  # WSJ's and TIMIT's batch of 32 (WSJ's run.sh: 64)
ATT_EPOCHS = 2  # one step each: the corpus is one batch
ATT_TIMED_STEPS = 3
ATT_DECODE_UTTS = 8  # one batch of decode_batch's 8
# of the decode, in the card-vs-CPU search; one: the CPU's search with
# the LM is the phase's longest part
ATT_CHECK_UTTS = 1
ATT_PASS_UTTS = 4  # of the batch, in the card-vs-CPU training pass
# the card-vs-CPU search runs ATT_CHECK_LEN steps and keeps the unfinished
# hypotheses (allow_partial): with CTC fusion the seeded model ends no
# hypothesis, and once one outgrows the valid frames (WSJ: 200 of run.sh's
# 220 steps) every prefix's CTC score sits at the float32 floor, where the
# beams tie exactly and either device's top-k may keep any of them
ATT_CHECK_LEN = 40
ATT_SECS = 8  # the decoded utterances
TIMIT_UNITS = [f"p{i}" for i in range(61)]  # TIMIT's 61 phones
ATT_RECIPES = {
    # WSJ: 8 s of read speech with 96 chars (12 a second; at most the
    # loader's adapt_token_num of 100, so the batch of 32 stays whole);
    # run.sh stage 4: beam 16, nbest 8, ctc 0.4, the LM at 0.6, len_norm
    # true, max_len 220
    "wsj": dict(yaml=WSJ_YAML, units=CHIME4_UNITS, secs=8, labels=96,
                lm=WSJ_LM_YAML,
                stage4=["--beam-size", "16", "--nbest", "8", "--ctc-weight",
                        "0.4", "--lm-weight", "0.6", "--len-norm", "true",
                        "--max-len", "220", "--space", "<space>"],
                beam=16,
                grads=("encoder.enc_list_0.conv_0.conv.weight",
                       "encoder.enc_list_1.impl.layer_0.cells.weight_ih_l0",
                       "decoder.att_net.enc_proj.weight",
                       "decoder.decoder.OptimizedLSTMCell_1.weight_hh_l0",
                       "ctc_head.weight")),
    # TIMIT: utterances of 3 s with 36 phones; run.sh stage 4: beam 8,
    # nbest 4, ctc 0.4, len_norm true, max_len 80. The patch: the linear
    # schedule's window [10, 26] becomes [0, 4], so that the second epoch
    # trains at ssr 0.2 (the scheduler's value after epoch 1)
    "timit": dict(yaml=TIMIT_YAML, units=TIMIT_UNITS, secs=3, labels=36,
                  lm=None, ss_epochs=[0, 4],
                  stage4=["--beam-size", "8", "--nbest", "4", "--ctc-weight",
                          "0.4", "--len-norm", "true", "--max-len", "80"],
                  beam=8,
                  grads=("encoder.layer_0.single_rnn.cells.weight_ih_l0",
                         "encoder.layer_2.dense.weight",
                         "decoder.att_net.F.weight",
                         "decoder.decoder.OptimizedLSTMCell_0.weight_ih_l0",
                         "ctc_head.weight")),
}
# the device kernels of K1 and K4, as the profiler names them
ATT_KERNEL_NAMES = {"fused_logmel": "fbank_fft_kernel",
                    "ctc_score_step": "ctc_score_kernel"}


def att_launches(passes: int = 0, steps: int = 0):
    """The launch counts of `passes` passes of the RNN attention model (K1
    once each; no other kernel: the encoders and the decoder are cuDNN and
    cuBLAS) and `steps` search steps (K4 once each)."""
    from aps_tpu_torch.ops import build
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want.update({"fused_logmel": passes, "ctc_score_step": steps})
    return want


def att_kernels_ran(prof, what: str, names) -> None:
    """Fail unless the profiler trace `prof` names each of `names`' device
    kernels (kernel_names). main() runs the phases that call it first
    (see there)."""
    seen = kernel_names(prof)
    for kernel in names:
        if not any(ATT_KERNEL_NAMES[kernel] in s for s in seen):
            fail(f"{what}: the profile shows no {ATT_KERNEL_NAMES[kernel]} "
                 f"({kernel}) among its {len(seen)} device kernels: "
                 f"{sorted(n[:40] for n in seen)}")


def write_att_recipe(root: Path, name: str, gen) -> Path:
    """root/dict (the recipe's units, <sos>, <eos>, <unk>) and root/train:
    ATT_TRAIN_UTTS seeded utterances with the recipe's label count each
    (wav.scp, text, utt2dur) and train.yaml: the recipe's YAML with its
    data sections pointed there (and TIMIT's patch)."""
    import torch

    from aps_tpu_torch.conf import load_yaml
    spec = ATT_RECIPES[name]
    units = spec["units"]
    vocab = ["<unk>"] + units + ["<sos>", "<eos>"]
    (root / "dict").write_text("".join(f"{u} {i}\n"
                                       for i, u in enumerate(vocab)))
    data = root / "train"
    data.mkdir()
    keys = sorted(write_wavs(data, "trn", ATT_TRAIN_UTTS, gen, spec["secs"]))
    labels = torch.randint(0, len(units), (ATT_TRAIN_UTTS, spec["labels"]),
                           generator=gen).tolist()
    with open(data / "text", "w") as text, \
            open(data / "utt2dur", "w") as dur:
        for key, toks in zip(keys, labels):
            text.write(f"{key} {' '.join(units[i] for i in toks)}\n")
            dur.write(f"{key} {spec['secs']:.2f}\n")
    conf = load_yaml(str(REPO / spec["yaml"]))
    if "ss_epochs" in spec:
        conf["trainer_conf"]["ss_scheduler_kwargs"]["epochs"] = \
            spec["ss_epochs"]
    paths = {key: str(data / key) for key in ("text", "utt2dur")}
    paths["wav_scp"] = str(data / "wav.scp")
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = paths
    (data / "train.yaml").write_text(json.dumps(conf, indent=2))
    return data


def att_train_phase(root: Path, name: str, data: Path, dev, card):
    """train_am (run.sh stage 2) on the corpus: ATT_EPOCHS one-step epochs
    with the launch counts over the run and the schedule-sampling rate of
    each training pass; then ATT_TIMED_STEPS timed steps on the same batch,
    each counted, one traced (its kernels named, the TF32 flags read
    inside it), and one more traced for K1's kernel name. -> (cpt, the
    batch, launches of the run, numbers, the waveform a training pass
    handed K1)."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.task.asr import CtcXentHybridTask
    spec = ATT_RECIPES[name]
    cpt = root / "exp"
    argv = ["--conf", str(data / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(ATT_TRAIN_UTTS),
            "--epochs", str(ATT_EPOCHS), "--seed", str(SEED)]
    rates = []
    forward = CtcXentHybridTask.forward

    def record(task, egs):
        if task.training:
            rates.append(egs.get("#ssr"))
        return forward(task, egs)

    CtcXentHybridTask.forward = record
    build.reset_launches()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            trainer = train_am.main(argv)
        torch.cuda.synchronize()
    finally:
        CtcXentHybridTask.forward = forward
    launches = dict(build.LAUNCHES)
    model = trainer.task.nnet
    setup = (trainer.device.type, trainer.cur_step, trainer.matmul_precision,
             type(trainer.optimizer).__name__, type(model).__name__,
             type(model.encoder).__name__, model.asr_transform.feats,
             trainer.ss_scheduler is not None)
    want_setup = ("cuda", ATT_EPOCHS, "bfloat16", "Adam", "AttASR",
                  {"wsj": "ConcatEncoder", "timit": "VariantRNNEncoder"}[name],
                  {"wsj": "perturb-fbank-log-aug-delta",
                   "timit": "perturb-fbank-log-cmvn-delta"}[name],
                  name == "timit")
    if setup != want_setup:
        fail(f"train_am ({spec['yaml']}) is not as written: {setup}")
    # a validation pass before the first epoch and after each
    want = att_launches(passes=2 * ATT_EPOCHS + 1)
    if launches != want:
        fail(f"train_am ({spec['yaml']}) launches {launches}, expected "
             f"{want}")
    want_rates = [0] + ([0.2] if name == "timit" else [0]) * \
        (ATT_EPOCHS - 1)
    if len(rates) != ATT_EPOCHS or any(
            abs(a - b) > 1e-9 for a, b in zip(rates, want_rates)):
        fail(f"{name}: the training passes ran at ssr {rates}, expected "
             f"{want_rates}")
    egs = first_batch(root, data, ATT_TRAIN_UTTS)
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs, per_step = [], []
    flags = []
    hook = model.register_forward_pre_hook(
        lambda *_: flags.append(tf32_flags()))
    for step in range(ATT_TIMED_STEPS):
        build.reset_launches()
        with training_operands() as seen:
            done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        per_step.append(dict(build.LAUNCHES))
        if not done or per_step[-1] != att_launches(passes=1):
            fail(f"{name} timed step {step}: done {done}, launches "
                 f"{per_step[-1]}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, wall, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    att_kernels_ran(prof, f"{name} training step", ("fused_logmel",))
    hook.remove()
    if set(flags) != {(True, True)} or tf32_flags() != (False, False):
        fail(f"{name} steps at matmul_precision bfloat16: TF32 flags "
             f"(cuBLAS, cuDNN) {set(flags)} inside, {tf32_flags()} after")
    losses = _epoch_losses(cpt / "trainer.log", "train") + \
        [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite {name} loss: {losses}")
    rnn, gemm, _ = rnn_share(prof, device_ms)
    T_max = int(egs["tgt_len"].max()) + 1
    patch = f" (ss epochs {spec['ss_epochs']})" if "ss_epochs" in spec \
        else ""
    print(f"train_am {spec['yaml']} as written{patch}: {ATT_TRAIN_UTTS} x "
          f"{spec['secs']} s, {T_max} decoder steps, "
          f"{ATT_EPOCHS} one-step epochs at ssr {rates}, launches "
          f"{launches}; {ATT_TIMED_STEPS + 1} more steps on the same batch "
          f"(K1 once each), TF32 flags (cuBLAS, cuDNN) {flags[0]} inside "
          f"them; losses {', '.join(f'{v:.4f}' for v in losses)}",
          flush=True)
    print(f"{name} step: device {device_ms:.3f} ms (traced; cuDNN's "
          f"recurrences {rnn:.3f}, cuBLAS {gemm:.3f} of it), host "
          f"{statistics.median(secs):.4f} s median of "
          f"{', '.join(f'{v:.4f}' for v in secs)} (traced {wall:.4f} s, "
          f"{host_launches} launches), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    print(f"{name} step, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    return cpt, egs, launches, {
        "device_ms": device_ms, "peak_gib": peak,
        "host_s": statistics.median(secs), "launches": host_launches,
        "traced_s": wall}, seen["wav"]


def att_pass_check(root: Path, name: str, data: Path, egs, dev, gen, card):
    """The recipe's training pass with every dropout off and the draws fed
    in (the identity branch of the speed perturbation, one seeded
    SpecAugment mask for WSJ), float32 on the card and on the CPU, held by
    the referee rule with a float64 pass on the CPU."""
    import torch

    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.flagship import init_weights
    from aps_tpu_torch.libs import aps_asr_nnet, aps_task, aps_transform
    from aps_tpu_torch.transform.augment import tf_mask
    conf, _ = load_am_conf(str(data / "train.yaml"), str(root / "dict"))
    model = aps_asr_nnet(conf["nnet"])(
        asr_transform=aps_transform("asr")(**conf["asr_transform"]),
        **conf["nnet_conf"])
    init_weights(no_dropout(model), gen)
    task = aps_task(conf["task"], model, **conf["task_conf"])
    tf = model.asr_transform
    tf.perturb.draw = lambda generator: tf.perturb.identity
    if tf.specaug is not None:
        frames = int(tf._num_frames(torch.tensor(egs["src_pad"].shape[-1])))
        aug = tf.specaug
        # SpecAugment masks the log-mel's bins, ahead of the deltas
        mask = tf_mask(ATT_PASS_UTTS, (frames, tf.mel.shape[-1]), pm=aug.pm,
                       ps=aug.ps, max_bands=aug.freq_args[0],
                       max_frame=aug.time_args[0],
                       num_freq_masks=aug.freq_args[1],
                       num_time_masks=aug.time_args[1], generator=gen)
        tf.specaug.draw = lambda x, generator: (
            mask.to(x.device), torch.ones(x.shape[0], dtype=torch.bool,
                                          device=x.device))
    loss_g, loss_c, errs = step_pass_check(
        task, egs, dev, ATT_RECIPES[name]["grads"], ATT_PASS_UTTS,
        referee=True, referee_on="cpu")
    print(f"{name} training pass at float32 (dropouts off, draws fed in, "
          f"TF32 flags read off inside) on {ATT_PASS_UTTS} utterances: loss "
          f"card {loss_g:.6f} vs CPU {loss_c:.6f}; the gradients' distance "
          "from the CPU's float64 pass relative to the largest entry (card, "
          "CPU) " + ", ".join(f"{k} {a:.3e}, {b:.3e}"
                             for k, (a, b) in errs.items()) + f" ({card})",
          flush=True)
    return {"pass_loss": (loss_g, loss_c), "pass_grads": errs}


def write_att_decodable(cpt: Path, root: Path) -> Path:
    """The trained checkpoint with its decoder output and CTC head x 8
    (peaky: well separated candidates, so that the CPU and card searches
    cannot part on near-ties) -> root/decode_am."""
    out = root / "decode_am"
    out.mkdir()
    with open(cpt / "last.ckpt", "rb") as fd:
        state = pickle.load(fd)
    params = state["params"]
    params = params.get("nnet", params)
    params["decoder"]["pred"]["kernel"] = \
        params["decoder"]["pred"]["kernel"] * 8.0
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8.0
    with open(out / "best.ckpt", "wb") as fd:
        pickle.dump(state, fd)
    (out / "train.yaml").write_bytes((cpt / "train.yaml").read_bytes())
    return out


def att_decode_phase(root: Path, name: str, am: Path, lm_dir, gen, dev,
                     card):
    """run.sh stage 4: ATT_DECODE_UTTS utterances of ATT_SECS through
    decode_batch with the recipe's options (and WSJ's LM), launch counts
    read (K1 once a batch, K4 once a search step, nothing else); one batch
    profiled (K1's and K4's kernels named in it); the first ATT_CHECK_UTTS
    card vs CPU, n-best equal and scores within 1e-3. -> (launches,
    (S, T, k_len), numbers)."""
    import numpy as np
    import torch

    from aps_tpu_torch.asr.beam_search.att import beam_search_batch
    from aps_tpu_torch.asr.beam_search.lm import lm_adapter
    from aps_tpu_torch.cmd import decode, decode_batch
    from aps_tpu_torch.cmd.decode_batch import quantize_dur
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.ops import build
    spec = ATT_RECIPES[name]
    data = root / "test"
    data.mkdir()
    wavs = write_wavs(data, "tst", ATT_DECODE_UTTS, gen, ATT_SECS)
    best = root / "test.decode"
    argv = [str(data / "wav.scp"), str(best), "--am", str(am), "--dict",
            str(root / "dict")] + spec["stage4"]
    if lm_dir is not None:
        argv += ["--lm", str(lm_dir)]
    build.reset_launches()
    with scorer_steps() as steps:
        stats = decode_batch.main(argv)
    launches = dict(build.LAUNCHES)
    lines = best.read_text().splitlines()
    if sorted(ln.split("\t")[0] for ln in lines) != sorted(wavs) or \
            not all(map(math.isfinite, stats["scores"].values())):
        fail(f"{name} decode_batch: {len(lines)} lines, scores "
             f"{list(stats['scores'].values())}")
    batches = len(stats["batch_secs"])
    want = att_launches(passes=batches, steps=len(steps))
    if launches != want or batches != 1:
        fail(f"{name} decode launches {launches} in {batches} batches and "
             f"{len(steps)} search steps, expected {want}")
    kw = decode.search_kwargs(decode_batch.make_parser().parse_args(argv))
    am_state = load_checkpoint(str(am))
    nnet = am_state["nnet"].to(dev)
    lm = load_checkpoint(str(lm_dir))["nnet"] if lm_dir else None
    sos, eos = (am_state["conf"]["nnet_conf"][k] for k in ("sos", "eos"))
    S = quantize_dur(ATT_SECS * SR)
    keys = sorted(wavs)
    batch = [wavs[k] for k in keys]
    x = torch.from_numpy(np.stack([np.pad(w, (0, S - len(w)))
                                   for w in batch])).to(dev)
    with torch.no_grad():
        enc, enc_len, _ = nnet.decode_enc(x, torch.tensor(
            [len(w) for w in batch], device=dev))
    shapes = (S, enc.shape[1], int(enc_len.max()))
    max_len = int(spec["stage4"][spec["stage4"].index("--max-len") + 1])

    def adapter(where):
        return None if lm is None else lm_adapter(
            lm.to(where), max_len=max_len, sos=sos)

    search = lambda: beam_search_batch(  # noqa: E731
        nnet.to(dev), batch, lm=adapter(dev), sos=sos, eos=eos, device=dev,
        pad_to=S, **kw)
    for key, hyps in zip(keys, search()):
        if abs(hyps[0]["score"] - stats["scores"][key]) > 1e-3:
            fail(f"{name} {key}: decode_batch score {stats['scores'][key]} "
                 f"!= search score {hyps[0]['score']}")
    build.reset_launches()
    device_ms, wall, host_launches, prof = profile(search)
    n_steps = build.LAUNCHES["ctc_score_step"]
    att_kernels_ran(prof, f"{name} decode batch",
                    ("fused_logmel", "ctc_score_step"))
    outs = {}
    check_kw = dict(kw, max_len=ATT_CHECK_LEN, allow_partial=True)
    for where in ("cpu", dev):
        outs[str(where)] = beam_search_batch(
            nnet.to(where), batch[:ATT_CHECK_UTTS], lm=adapter(where),
            sos=sos, eos=eos, device=where, pad_to=S, **check_kw)
    score_err = 0.0
    for key, hc, hg in zip(keys, outs["cpu"], outs[str(dev)]):
        err = nbest_error(hc, hg)
        if err is None:
            for side, hyps in (("CPU", hc), ("card", hg)):
                print(f"{name} {key} {side}: " + "; ".join(
                    f"{h['score']:.6f} ({len(h['trans'])}) "
                    f"{' '.join(map(str, h['trans']))}" for h in hyps),
                    flush=True)
            fail(f"{name} {key}: card and CPU n-best lists differ")
        score_err = max(score_err, err)
    if not (score_err <= 1e-3 and len(outs["cpu"][0]) > 1):
        fail(f"{name} n-best scores card vs CPU differ by {score_err}")
    print(f"{name} decode_batch {' '.join(spec['stage4'])}"
          f"{' with the char RNN LM' if lm_dir else ''}: "
          f"{ATT_DECODE_UTTS} x {ATT_SECS} s padded to {S} samples (T = "
          f"{shapes[1]}, {shapes[2]} valid), {stats['batch_secs'][0]:.4f} s "
          f"(host clock around the synchronised batch), {len(steps)} search "
          f"steps over {steps[0][0]} K4 lanes, launches {launches}; "
          f"profiled: device {device_ms:.3f} ms in {wall:.4f} s wall, "
          f"{n_steps} steps, {host_launches / max(n_steps, 1):.1f} host "
          f"launches a step ({card})", flush=True)
    print(f"{name} search card vs CPU on {ATT_CHECK_UTTS} utterances, "
          f"{ATT_CHECK_LEN} steps with allow_partial: n-best of "
          f"{len(outs['cpu'][0])} equal, largest score diff {score_err:.3e}, "
          f"the best of {[len(h[0]['trans']) for h in outs['cpu']]} ids "
          f"({card})", flush=True)
    return launches, shapes, {"device_ms": device_ms, "wall": wall,
                              "batch_s": stats["batch_secs"][0],
                              "steps": len(steps), "score_err": score_err,
                              "decode_wav": x}


def att_phase(root: Path, name: str, gen, dev, card):
    """One RNN attention recipe: write_att_recipe, att_train_phase,
    att_pass_check, WSJ's LM (seeded), att_decode_phase; then K1 at the
    decode's and the training pass's batches and K4 at the decode's T and
    lanes. -> (launches of training, of the decode, {kernel: rows},
    numbers)."""
    from types import SimpleNamespace

    from aps_tpu_torch.libs import aps_transform
    beg = time.perf_counter()
    root.mkdir()
    spec = ATT_RECIPES[name]
    data = write_att_recipe(root, name, gen)
    with phase(f"{name} / train_am"):
        cpt, egs, launches_train, numbers, trn_wav = att_train_phase(
            root, name, data, dev, card)
    with phase(f"{name} / pass card vs CPU"):
        numbers.update(att_pass_check(root, name, data, egs, dev, gen,
                                      card))
    lm_dir = write_lm(root, spec["lm"], gen, "rnn_lm")[0] \
        if spec["lm"] else None
    with phase(f"{name} / decode and search card vs CPU"):
        launches_dec, (S, T, k_len), dec_numbers = att_decode_phase(
            root, name, write_att_decodable(cpt, root), lm_dir, gen, dev,
            card)
    numbers["decode"] = dec_numbers
    # K1 with the recipe transform's options on the decode batch (int16
    # scale) and on the rescaled, perturbed batch a training pass handed
    # it; K4 at the decode's T and lanes, and TIMIT's at a 3 s
    # utterance's T too
    from aps_tpu_torch.conf import load_yaml
    tf = aps_transform("asr")(**load_yaml(str(REPO / spec["yaml"]))[
        "asr_transform"])
    rows = {"fused_logmel": check_fbank(
        dev, SimpleNamespace(asr_transform=tf),
        ((f"{name} decode", tf.rescale(dec_numbers.pop("decode_wav"))),
         (f"{name} training", trn_wav)))[0]}
    rows["ctc_score_step"] = check_ctc(dev, gen, T, batches=(ATT_DECODE_UTTS,),
                                       beam=spec["beam"])[0]
    if name == "timit":
        rows["ctc_score_step"] += check_ctc(
            dev, gen, 300, batches=(ATT_DECODE_UTTS,), beam=spec["beam"])[0]
    numbers["phase_s"] = time.perf_counter() - beg
    print(f"the {name} phase took {numbers['phase_s']:.1f} s ({card})",
          flush=True)
    return launches_train, launches_dec, rows, numbers


# the transducer slice: examples/asr/aishell_v1/run.sh stages 2 and 4 with
# conf/1f.yaml as written (asr@transducer: 12 conformer layers of 256 with
# rel pose, 4 heads, feed-forward 2048, kernel 15, a 3-layer conv2d front
# end; a 3 x 512 LSTM prediction net, joint 512; asr@transducer's RNN-T
# loss, AdamW, warmup_linear_decay_lr, matmul_precision bfloat16 as TF32)
TRD_YAML = "examples/asr/aishell_v1/conf/1f.yaml"
TRD_LM_YAML = "examples/asr/aishell_v1/conf/nnlm/1a.yaml"
# a synthetic character dictionary of AISHELL-1's order: <unk> and 4231
# characters, so the model's vocabulary with the blank is 4233
TRD_UNITS = [f"c{i}" for i in range(4231)]
TRD_TRAIN_UTTS = 16  # one batch: 8 s utterances, adapt_dur 5 halves 32
TRD_BATCH_SIZE = 32  # train_am's --batch-size (run.sh: 64)
TRD_LABELS = 40  # characters in 8 s of read Mandarin
TRD_EPOCHS = 2  # one step each: the corpus is one batch
TRD_TIMED_STEPS = 2
TRD_PASS_UTTS = 2  # of the batch, in the card-vs-CPU training pass
TRD_DECODE_UTTS = 8  # one batch of decode_batch's 8
TRD_CHECK_UTTS = 2  # of the decode, in the card-vs-CPU searches
TRD_SECS = 8
# run.sh's stage 4 (beam 16, nbest 8, len_norm false); no LM: the weight 0
TRD_STAGE4 = ["--beam-size", "16", "--nbest", "8", "--len-norm", "false",
              "--lm-weight", "0"]
TRD_LM_WEIGHT = 0.2  # run.sh's lm_weight, in the fused search
TRD_GRADS = ("encoder.pose_layer.embed.weight",
             "encoder.encoder.layers.0.self_attn.in_proj.weight",
             "decoder.decoder.OptimizedLSTMCell_0.weight_hh_l0",
             "decoder.enc_proj.weight", "decoder.output.weight")
# rnnt_loss at the step's shape, card vs CPU: float32 log-softmax over V =
# 4233 and a T'-step recursion of log-sum-exps; the loss relative, the
# gradient relative to its largest entry: PERF.md section 2's training
# bounds (an occupancy is exp(alpha + beta - log p), the three ~1e3 in
# size, so float32 leaves ~1e-4 of it: the card read 2.9e-4 from the CPU
# on an NVIDIA H100 80GB HBM3, 700.00 W; each float32 pass's distance
# from a float64 pass on the CPU is printed beside it)
TOL_RNNT_LOSS, TOL_RNNT_GRAD = TOL_STEP_LOSS, TOL_STEP_GRAD


def trd_launches(passes: int = 0, steps: int = 0):
    """The launch counts of `passes` passes of 1f's model (K1 once, K3's
    forward once a layer) of which `steps` train (each K3 backward kernel
    once a layer); no other kernel: the prediction net is cuDNN's LSTM, the
    joint cuBLAS, the loss plain PyTorch."""
    from aps_tpu_torch.ops import build
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want.update({"fused_logmel": passes,
                 "flash_attention_rel": ENC_LAYERS * passes})
    want.update({f"flash_attention_rel_{k}": ENC_LAYERS * steps
                 for k in BACKWARD})
    return want


def write_trd_recipe(root: Path, gen) -> Path:
    """root/dict (<unk> and TRD_UNITS) and root/train: TRD_TRAIN_UTTS
    seeded utterances of TRD_SECS with TRD_LABELS characters each and
    train.yaml, TRD_YAML with its data sections pointed there."""
    import torch

    from aps_tpu_torch.conf import load_yaml
    vocab = ["<unk>"] + TRD_UNITS
    (root / "dict").write_text("".join(f"{u} {i}\n"
                                       for i, u in enumerate(vocab)))
    data = root / "train"
    data.mkdir()
    keys = sorted(write_wavs(data, "trn", TRD_TRAIN_UTTS, gen, TRD_SECS))
    labels = torch.randint(0, len(TRD_UNITS), (TRD_TRAIN_UTTS, TRD_LABELS),
                           generator=gen).tolist()
    with open(data / "text", "w") as text, \
            open(data / "utt2dur", "w") as dur:
        for key, toks in zip(keys, labels):
            text.write(f"{key} {' '.join(TRD_UNITS[i] for i in toks)}\n")
            dur.write(f"{key} {TRD_SECS:.2f}\n")
    conf = load_yaml(str(REPO / TRD_YAML))
    paths = {key: str(data / key) for key in ("text", "utt2dur")}
    paths["wav_scp"] = str(data / "wav.scp")
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = paths
    (data / "train.yaml").write_text(json.dumps(conf, indent=2))
    return data


def trd_batch(root: Path, data: Path):
    """The corpus's one batch as train_am's loader collates it at
    --batch-size TRD_BATCH_SIZE (the recipe's adapt_dur halves it)."""
    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.libs import aps_dataloader
    conf, vocab = load_am_conf(str(data / "train.yaml"), str(root / "dict"))
    data_conf = conf["data_conf"]
    batches = list(aps_dataloader(fmt=data_conf["fmt"], train=False,
                                  vocab_dict=vocab,
                                  max_batch_size=TRD_BATCH_SIZE,
                                  **data_conf["loader"],
                                  **data_conf["valid"]))
    if len(batches) != 1 or batches[0]["src_pad"].shape[0] != TRD_TRAIN_UTTS:
        fail(f"expected one batch of {TRD_TRAIN_UTTS} utterances, got "
             f"{[b['src_pad'].shape for b in batches]}")
    return batches[0]


def trd_train_phase(root: Path, data: Path, dev, card, label="1f",
                    launches_of=None):
    """train_am (run.sh stage 2): TRD_EPOCHS one-step epochs with the
    launch counts over the run; TRD_TIMED_STEPS timed steps on the same
    batch, each counted, with what they hand K1 and K3 recorded; one
    traced. label names the model in the lines printed, launches_of(passes,
    steps) its launch counts (trd_launches: 1f's). -> (checkpoint, the
    batch, launches of the run, numbers, the training operands)."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.ops import build
    launches_of = launches_of or trd_launches
    cpt = root / "exp"
    argv = ["--conf", str(data / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(TRD_BATCH_SIZE),
            "--epochs", str(TRD_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    model = trainer.task.nnet
    setup = (trainer.device.type, trainer.cur_step, trainer.matmul_precision,
             type(trainer.optimizer).__name__, type(model).__name__,
             type(trainer.task).__name__, model.asr_transform.feats,
             model.vocab_size)
    want_setup = ("cuda", TRD_EPOCHS, "bfloat16", "AdamW", "TransducerASR",
                  "TransducerTask", "perturb-fbank-log-cmvn-aug",
                  len(TRD_UNITS) + 2)
    if setup != want_setup:
        fail(f"train_am ({label}) is not as written: {setup}")
    # a validation pass before the first epoch and after each
    want = launches_of(passes=2 * TRD_EPOCHS + 1, steps=TRD_EPOCHS)
    if launches != want:
        fail(f"train_am ({label}) launches {launches}, expected {want}")
    egs = trd_batch(root, data)
    trainer.reporter.train()
    torch.cuda.reset_peak_memory_stats(dev)
    secs, flags = [], []
    hook = model.register_forward_pre_hook(
        lambda *_: flags.append(tf32_flags()))
    for step in range(TRD_TIMED_STEPS):
        build.reset_launches()
        with training_operands() as seen:
            done, sec = synced(lambda: trainer.train_one_step(egs))
        secs.append(sec)
        got = dict(build.LAUNCHES)
        if not done or got != launches_of(passes=1, steps=1):
            fail(f"{label} timed step {step}: done {done}, launches {got}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    device_ms, wall, host_launches, prof = profile(
        lambda: trainer.train_one_step(egs))
    hook.remove()
    if set(flags) != {(True, True)} or tf32_flags() != (False, False):
        fail(f"{label} steps at matmul_precision bfloat16: TF32 flags (cuBLAS, "
             f"cuDNN) {set(flags)} inside, {tf32_flags()} after")
    losses = _epoch_losses(cpt / "trainer.log", "train") + \
        [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite {label} loss: {losses}")
    _, T, _ = train_shapes(model, egs)
    U1 = int(egs["tgt_len"].max()) + 1
    V = model.vocab_size
    joint_gib = len(egs["src_len"]) * T * U1 * V * 4 / 2**30
    print(f"train_am {label}: {TRD_TRAIN_UTTS} x {TRD_SECS} s "
          f"(one batch; --batch-size {TRD_BATCH_SIZE}, halved by adapt_dur), "
          f"{TRD_LABELS} labels, V = {V} ({len(TRD_UNITS)} characters, "
          f"<unk>, the blank), the joint's logits N x T' x (U+1) x V = "
          f"{len(egs['src_len'])} x {T} x {U1} x {V} ({joint_gib:.2f} GiB "
          f"in float32); {TRD_EPOCHS} one-step epochs, launches {launches}; "
          f"{TRD_TIMED_STEPS + 1} more steps on the same batch, TF32 flags "
          f"(cuBLAS, cuDNN) {flags[0]} inside them; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
    print(f"{label} step: device {device_ms:.3f} ms (traced), host "
          f"{statistics.median(secs):.4f} s median of "
          f"{', '.join(f'{v:.4f}' for v in secs)} (traced {wall:.4f} s, "
          f"{host_launches} launches), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    print(f"{label} step, the kernels with the most device time (ms): "
          f"{top_kernels(prof)}", flush=True)
    return cpt, egs, launches, {
        "device_ms": device_ms, "peak_gib": peak, "launches": host_launches,
        "host_s": statistics.median(secs), "traced_s": wall,
        "shape": (len(egs["src_len"]), T, U1, V)}, seen


def trd_pass_check(root: Path, data: Path, egs, dev, gen, card, label="1f",
                   launches_of=None, grads=TRD_GRADS):
    """1f's training pass with every dropout off and the draws fed in (the
    identity branch of the speed perturbation, one seeded SpecAugment
    mask) on TRD_PASS_UTTS utterances, float32 on the card and on the CPU,
    held by the referee rule with a float64 pass on the CPU (K3 takes
    float32 only); label, launches_of as trd_train_phase's, grads the
    gradients held."""
    import torch

    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.flagship import init_weights
    from aps_tpu_torch.libs import aps_asr_nnet, aps_task, aps_transform
    from aps_tpu_torch.transform.augment import tf_mask
    conf, _ = load_am_conf(str(data / "train.yaml"), str(root / "dict"))
    model = aps_asr_nnet(conf["nnet"])(
        asr_transform=aps_transform("asr")(**conf["asr_transform"]),
        **conf["nnet_conf"])
    init_weights(no_dropout(model), gen)
    task = aps_task(conf["task"], model, **conf["task_conf"])
    tf = model.asr_transform
    tf.perturb.draw = lambda generator: tf.perturb.identity
    frames = int(tf._num_frames(torch.tensor(egs["src_pad"].shape[-1])))
    aug = tf.specaug
    mask = tf_mask(TRD_PASS_UTTS, (frames, tf.mel.shape[-1]), pm=aug.pm,
                   ps=aug.ps, max_bands=aug.freq_args[0],
                   max_frame=aug.time_args[0],
                   num_freq_masks=aug.freq_args[1],
                   num_time_masks=aug.time_args[1], generator=gen)
    tf.specaug.draw = lambda x, generator: (
        mask.to(x.device), torch.ones(x.shape[0], dtype=torch.bool,
                                      device=x.device))
    launched = {}
    loss_g, loss_c, errs = step_pass_check(
        task, egs, dev, grads, TRD_PASS_UTTS, referee=True,
        referee_on="cpu", launched=launched)
    if launched["card32"] != {k: v for k, v in (
            launches_of or trd_launches)(1, 1).items() if v}:
        fail(f"the {label} pass launched {launched['card32']}")
    print(f"{label} training pass at float32 (dropouts off, draws fed in, TF32 "
          f"flags read off inside) on {TRD_PASS_UTTS} utterances: loss card "
          f"{loss_g:.6f} vs CPU {loss_c:.6f}; the gradients' distance from "
          "the CPU's float64 pass relative to the largest entry (card, CPU) "
          + ", ".join(f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in errs.items())
          + f" ({card})", flush=True)
    return {"pass_loss": (loss_g, loss_c), "pass_grads": errs}


def trd_loss_check(egs, shape, dev, gen, card):
    """rnnt_loss at the step's shape (N x T' x (U+1) x V seeded logits, the
    batch's label lengths, frame lengths ragged below T'), card vs CPU: the
    loss and the gradient (finite, 0 past each utterance's frames and
    labels on the card); the card's forward and backward timed."""
    import torch

    from aps_tpu_torch.ops.rnnt import rnnt_loss
    N, T, U1, V = shape
    logits = 2 * torch.randn((N, T, U1, V), generator=gen)
    labels = torch.as_tensor(egs["tgt_pad"]).clamp(min=0)
    lab_len = torch.as_tensor(egs["tgt_len"])
    frames = torch.tensor([T - (n % 4) * 7 for n in range(N)])
    out = []
    for where, dtype in (("cpu", torch.float32), (dev, torch.float32),
                         ("cpu", torch.float64)):
        x = logits.to(where, dtype, copy=True).requires_grad_()
        loss = rnnt_loss(x, labels.to(where), frames.to(where),
                         lab_len.to(where), blank=V - 1, reduction="none")
        loss.sum().backward()
        out.append((loss.detach().cpu().double(), x.grad.cpu().double()))
        del x, loss
    (lc, gc), (lg, gg), (_, g64) = out
    loss_err = float(((lg - lc).abs() / lc.abs()).max())
    grad_err = float((gg - gc).abs().max() / gc.abs().max())
    grad64 = [float((g - g64).abs().max() / g64.abs().max())
              for g in (gg, gc)]
    past = [float(gg[n, frames[n]:].abs().max()) if frames[n] < T else 0.0
            for n in range(N)] + \
        [float(gg[n, :, lab_len[n] + 1:].abs().max())
         if lab_len[n] + 1 < U1 else 0.0 for n in range(N)]
    if not (torch.isfinite(gg).all() and max(past) == 0.0 and
            loss_err <= TOL_RNNT_LOSS and grad_err <= TOL_RNNT_GRAD):
        fail(f"rnnt_loss card vs CPU at {shape}: loss {loss_err}, gradient "
             f"{grad_err}, past the lengths {max(past)}")
    x = logits.to(dev, copy=True).requires_grad_()
    args = (labels.to(dev), frames.to(dev), lab_len.to(dev))

    def fwd_bwd():
        x.grad = None
        rnnt_loss(x, *args, blank=V - 1).backward()

    fwd_ms = time_ms(lambda: rnnt_loss(x.detach(), *args, blank=V - 1),
                     iters=5, warmup=1)
    both_ms = time_ms(fwd_bwd, iters=5, warmup=1)
    print(f"rnnt_loss at the step's shape {N} x {T} x {U1} x {V} (frames "
          f"{sorted(set(frames.tolist()))}): card vs CPU loss {loss_err:.3e} "
          f"relative, gradient {grad_err:.3e} of its largest entry (card "
          f"{grad64[0]:.3e}, CPU {grad64[1]:.3e} from float64), 0 past "
          f"every length; the card's forward {fwd_ms:.3f} ms, forward and "
          f"backward {both_ms:.3f} ms ({card})", flush=True)
    del x
    return {"loss_err": loss_err, "grad_err": grad_err,
            "grad_err_float64": grad64, "fwd_ms": fwd_ms,
            "fwd_bwd_ms": both_ms}


def write_trd_decodable(cpt: Path, root: Path) -> Path:
    """The trained checkpoint with its joint output layer x 8 (peaky: well
    separated candidates, so the CPU and card searches cannot part on
    near-ties) -> root/decode_am."""
    out = root / "decode_am"
    out.mkdir()
    with open(cpt / "last.ckpt", "rb") as fd:
        state = pickle.load(fd)
    params = state["params"]
    params = params.get("nnet", params)
    params["decoder"]["output"]["kernel"] = \
        params["decoder"]["output"]["kernel"] * 8.0
    with open(out / "best.ckpt", "wb") as fd:
        pickle.dump(state, fd)
    (out / "train.yaml").write_bytes((cpt / "train.yaml").read_bytes())
    return out


def trd_decode_phase(root: Path, am: Path, gen, dev, card, label="1f",
                     launches_of=None, with_lm=True):
    """run.sh stage 4: TRD_DECODE_UTTS utterances of TRD_SECS through
    decode_batch with TRD_STAGE4, launch counts read (K1 once a batch, K3's
    forward once a layer, nothing else), what the encoder hands K3
    recorded; one batch profiled (device ms, host launches a frame); the
    first TRD_CHECK_UTTS card vs CPU (nbest_error, len_norm true); one
    search fused with a seeded RNN LM of the AM's vocabulary (TRD_LM_YAML's
    structure), card vs CPU; an LM of the dictionary's raises (not
    without with_lm). label, launches_of as trd_train_phase's. ->
    (launches, the recorded K3 calls, numbers)."""
    import numpy as np
    import torch

    from aps_tpu_torch.asr.beam_search.lm import lm_adapter
    from aps_tpu_torch.asr.beam_search.transducer import (beam_search_batch,
                                                          check_lm)
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.cmd.decode_batch import quantize_dur
    from aps_tpu_torch.cmd.profile_decode import profile
    from aps_tpu_torch.conf import load_yaml
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.libs import aps_asr_nnet
    from aps_tpu_torch.ops import build
    launches_of = launches_of or trd_launches
    data = root / "test"
    data.mkdir()
    wavs = write_wavs(data, "tst", TRD_DECODE_UTTS, gen, TRD_SECS)
    best = root / "test.decode"
    argv = [str(data / "wav.scp"), str(best), "--am", str(am), "--dict",
            str(root / "dict")] + TRD_STAGE4
    build.reset_launches()
    with rel_calls() as seen:
        stats = decode_batch.main(argv)
    launches = dict(build.LAUNCHES)
    lines = best.read_text().splitlines()
    if sorted(ln.split("\t")[0] for ln in lines) != sorted(wavs) or \
            not all(map(math.isfinite, stats["scores"].values())):
        fail(f"{label} decode_batch: {len(lines)} lines, scores "
             f"{list(stats['scores'].values())}")
    batches = len(stats["batch_secs"])
    if launches != launches_of(passes=batches) or batches != 1:
        fail(f"{label} decode launches {launches} in {batches} batches")
    model = load_checkpoint(str(am))["nnet"].to(dev)
    S = quantize_dur(TRD_SECS * SR)
    keys = sorted(wavs)
    batch = [wavs[k] for k in keys]
    kw = dict(beam_size=16, nbest=8, len_norm=False)
    search = lambda: beam_search_batch(  # noqa: E731
        model.to(dev), batch, device=dev, pad_to=S, **kw)
    for key, hyps in zip(keys, search()):
        if abs(hyps[0]["score"] - stats["scores"][key]) > 1e-3:
            fail(f"{label} {key}: decode_batch score {stats['scores'][key]} != "
                 f"search score {hyps[0]['score']}")
    device_ms, wall, host_launches, _ = profile(search)
    x = torch.from_numpy(np.stack([np.pad(w, (0, S - len(w)))
                                   for w in batch])).to(dev)
    with torch.no_grad():
        enc, enc_len = model.decode_enc(x, torch.tensor(
            [len(w) for w in batch], device=dev))
    T = enc.shape[1]
    check = {"plain": (None, dict(kw, len_norm=True))}
    if with_lm:
        # the seeded RNN LM of the AM's vocabulary (it holds the blank id
        # its fusion starts from), TRD_LM_YAML's structure
        lm_conf = load_yaml(str(REPO / TRD_LM_YAML))
        lm = aps_asr_nnet(lm_conf["nnet"])(**dict(
            lm_conf["nnet_conf"], vocab_size=model.vocab_size))
        init_lm(lm, gen)
        lm.eval()
        small = aps_asr_nnet(lm_conf["nnet"])(**dict(
            lm_conf["nnet_conf"], vocab_size=model.vocab_size - 1))
        try:
            check_lm(model, lm_adapter(small), TRD_LM_WEIGHT)
            fail("an LM without the blank id did not raise")
        except ValueError as err:
            refused = str(err)
        check["lm"] = (lm, dict(kw, len_norm=True,
                                lm_weight=TRD_LM_WEIGHT))
    errs, outs = {}, {}
    for name, (lm_model, ckw) in check.items():
        for where in ("cpu", dev):
            adapter = None if lm_model is None else \
                lm_adapter(lm_model.to(where))
            outs[(name, str(where))] = beam_search_batch(
                model.to(where), batch[:TRD_CHECK_UTTS], lm=adapter,
                device=where, pad_to=S, **ckw)
        errs[name] = 0.0
        for key, hc, hg in zip(keys, outs[(name, "cpu")],
                               outs[(name, str(dev))]):
            err = nbest_error(hc, hg)
            if err is None:
                for side, hyps in (("CPU", hc), ("card", hg)):
                    print(f"{label} {name} {key} {side}: " + "; ".join(
                        f"{h['score']:.6f} ({len(h['trans'])})"
                        for h in hyps), flush=True)
                fail(f"{label} {name} search {key}: card and CPU n-best lists "
                     "differ")
            errs[name] = max(errs[name], err)
    plain = [h[0]["trans"] for h in outs[("plain", "cpu")]]
    model.to(dev)
    print(f"{label} decode_batch {' '.join(TRD_STAGE4)}: {TRD_DECODE_UTTS} x "
          f"{TRD_SECS} s padded to {S} samples (T' = {T}, "
          f"{int(enc_len.max())} valid), {stats['batch_secs'][0]:.4f} s (host "
          f"clock around the synchronised batch), launches {launches}; "
          f"profiled search: device {device_ms:.3f} ms in {wall:.4f} s wall, "
          f"{host_launches / T:.1f} host launches a frame ({card})",
          flush=True)
    fused = "" if not with_lm else (
        f"; fused with the RNN LM of vocabulary {model.vocab_size} at "
        f"{TRD_LM_WEIGHT}: {errs['lm']:.3e}, best hypotheses of "
        f"{[len(h[0]['trans']) - 2 for h in outs[('lm', 'cpu')]]} tokens; "
        f"an LM of {model.vocab_size - 1} ids refused: {refused[:80]}...")
    print(f"{label} search card vs CPU on {TRD_CHECK_UTTS} utterances (beam "
          f"16, len_norm true): n-best of {len(outs[('plain', 'cpu')][0])} "
          f"equal, largest score diff {errs['plain']:.3e}, best hypotheses of "
          f"{[len(t) - 2 for t in plain]} tokens{fused} ({card})",
          flush=True)
    return launches, seen, {"device_ms": device_ms, "wall": wall,
                            "batch_s": stats["batch_secs"][0], "frames": T,
                            "host_launches_a_frame": host_launches / T,
                            "score_err": errs, "decode_wav": x}


def transducer_phase(root: Path, gen, dev, card):
    """aishell_v1/1f: write_trd_recipe, trd_train_phase, trd_pass_check,
    trd_loss_check, trd_decode_phase; then K1 at the decode's and the
    training step's batches and K3's forward and backward kernels at the
    shapes the step and the decode handed them. -> (launches of training,
    of the decode, {kernel: rows}, numbers)."""
    from types import SimpleNamespace

    from aps_tpu_torch.conf import load_yaml
    from aps_tpu_torch.libs import aps_transform
    beg = time.perf_counter()
    root.mkdir()
    data = write_trd_recipe(root, gen)
    with phase("transducer / train_am"):
        cpt, egs, launches_train, numbers, seen = trd_train_phase(
            root, data, dev, card)
    with phase("transducer / pass and loss card vs CPU"):
        numbers.update(trd_pass_check(root, data, egs, dev, gen, card))
        numbers["loss"] = trd_loss_check(egs, numbers["shape"], dev, gen,
                                         card)
    with phase("transducer / decode"):
        launches_dec, calls, dec_numbers = trd_decode_phase(
            root, write_trd_decodable(cpt, root), gen, dev, card)
    numbers["decode"] = dec_numbers
    tf = aps_transform("asr")(**load_yaml(str(REPO / TRD_YAML))[
        "asr_transform"])
    rows = {"fused_logmel": check_fbank(
        dev, SimpleNamespace(asr_transform=tf),
        (("1f decode", dec_numbers.pop("decode_wav")),
         ("1f training", seen["wav"])))[0]}
    # K3: the decode's forward, and the training step's forward with lse
    # and backward kernels, at the (B, T, k_len) they were handed
    dec = {c[:7] for c in calls}
    trn = set(seen["rel"])
    if len(dec) != 1 or len(trn) != 1:
        fail(f"1f handed K3 {dec} in the decode, {trn} in training")
    (B_d, H, T_d, D, Hp_d, lens_d, causal_d), = dec
    (_, H_t, T_t, D_t, Hp_t, lens_t, causal_t), = trn
    if (H, D, H_t, D_t, causal_d, causal_t) != (4, 64, 4, 64, False, False):
        fail(f"1f's K3 calls: {dec}, {trn}")
    # each row with its queued time and the tensor cores' bound; no one
    # PyTorch call forms the relative term, so no library time
    fwd, fwd_more = check_rel_attention(
        dev, gen, H=H, cases=((T_d, Hp_d, False, list(lens_d), "path"),))
    rows["flash_attention_rel"] = [fwd[0] + ({
        "ms_queued": fwd_more["ms_queued"],
        "tensor_core_bound_ms": fwd_more["tensor_core_bound_ms"],
        "library_ms": None},)]
    bwd, bwd_more = check_rel_attention_bwd(dev, gen, H=H, cases=[
        (T_t, Hp_t, False, list(lens_t), "1f")])
    rows["flash_attention_rel"].append(bwd.pop("fwd")[0] + (dict(
        bwd_more["fwd_1f"], library_ms=None),))
    for kernel, (row,) in bwd.items():
        name = f"flash_attention_rel_{kernel}"
        rows[name] = [row + ({
            "ms_queued": bwd_more[name]["1f"]["ms_queued"],
            "tensor_core_bound_ms": bwd_more[name]["1f"][
                "tensor_core_bound_ms"], "library_ms": None},)]
    numbers["phase_s"] = time.perf_counter() - beg
    print(f"the transducer phase took {numbers['phase_s']:.1f} s ({card})",
          flush=True)
    return launches_train, launches_dec, rows, numbers


# the eight sse@ models that no other phase runs, at the depth of the CPU
# tests (tests/test_torch_sse_{time,cplx,zoo}.py): one training pass and
# one separation each, card vs CPU. The sepformers' attention is 32 wide
# with 2 heads, and once more at the tests' 16 (heads of 8, which K2 takes
# unpadded in the tiles of 16)
SSE8_ENH = dict(feats="spectrogram-log-cmvn", frame_len=64, frame_hop=32,
                window="sqrthann", center=True)
SSE8_ENH_CPLX = dict(feats="spectrogram", frame_len=128, frame_hop=64,
                     window="sqrthann", center=True)
SSE8_XFMR = dict(att_dim=32, nhead=2, feedforward_dim=48, att_dropout=0.0,
                 ffn_dropout=0.0)
SSE8_UNET = dict(K="5,3;3,3", S="2,1;2,1", C="4,6", P="1,1", O="0,1")
# the CPU tests' SepFormer width: 2 heads of 8, which K2 takes unpadded in
# the tiles of 16
SSE8_XFMR8 = dict(SSE8_XFMR, att_dim=16, feedforward_dim=24)
# name (a label after "#"): (model conf, enh transform, task, task conf,
# samples)
SSE8_MODELS = {
    "sse@time_sepformer": (dict(num_bins=8, kernel=8, stride=4,
                                num_blocks=1, num_layers=1, chunk_size=16,
                                arch_kwargs=SSE8_XFMR), None, "sse@sisnr",
                           {"num_spks": 2}, 1200),
    "sse@time_sepformer#heads_of_8": (
        dict(num_bins=8, kernel=8, stride=4, num_blocks=1, num_layers=1,
             chunk_size=16, arch_kwargs=SSE8_XFMR8), None, "sse@sisnr",
        {"num_spks": 2}, 1200),
    "sse@freq_sepformer": (dict(num_bins=33, num_blocks=1, num_layers=1,
                                chunk_size=8, arch_kwargs=SSE8_XFMR),
                           SSE8_ENH, "sse@freq_linear_sa", {"num_spks": 2},
                           1200),
    "sse@freq_dprnn": (dict(num_spks=2, num_bins=33, chunk_size=6,
                            num_layers=1, rnn_hidden=6,
                            bidirectional=False), SSE8_ENH,
                       "sse@freq_linear_sa",
                       {"num_spks": 2, "phase_sensitive": True,
                        "truncated": 1}, 1200),
    "sse@dccrn": (dict(SSE8_UNET, cplx=True, num_spks=2, rnn_hidden=8,
                       rnn_layers=2, rnn_resize=192, training_mode="freq"),
                  SSE8_ENH_CPLX, "sse@complex_masking", {"num_spks": 2},
                  1600),
    "sse@dense_unet": (dict(K="3,3;3,3;3,3", S="1,1;2,1;2,1",
                            P="0,1;0,1;0,1", O="0,0,0",
                            enc_channel="4,8,12", dec_channel="4,6,8",
                            num_dense_blocks=2, norm="BN", num_spks=2,
                            rnn_hidden=8, rnn_layers=1, rnn_resize=180,
                            training_mode="time"),
                       dict(SSE8_ENH_CPLX, feats="spectrogram-log-cmvn"),
                       "sse@snr", {"num_spks": 2}, 1600),
    "sse@phasen": (dict(channel_amp=4, channel_pha=3, num_tsbs=2,
                        num_bins=33, channel_r=2, conv1d_kernel=3,
                        lstm_hidden=6, linear_size=8), SSE8_ENH,
                   "sse@complex_mapping", {"num_spks": 1, "permute": False},
                   1216),
    "sse@dfsmn": (dict(dim=16, num_bins=33, num_branchs=2, num_layers=2,
                       project=8, lctx=2, rctx=1, complex_mask=True),
                  SSE8_ENH, "sse@complex_masking", {"num_spks": 2}, 1216),
    "sse@chimera++": (dict(input_size=33, num_bins=33, hidden=8,
                           num_layers=2, dropout=0.0, dpcl_embed_size=4,
                           bidirectional=True, mask_non_linear="relu"),
                      SSE8_ENH, "sse@freq_linear_sa",
                      {"num_spks": 2, "dpcl_weight": 0.3,
                       "phase_sensitive": True}, 1216),
}
SSE8_UTTS = 4
# SepFormer's chunk attention at a recipe's size (the SepFormer paper's:
# chunks of 250 frames, 8 heads of 32): 4 mixtures of 4 s at 8 kHz, kernel
# 16 and stride 8, give 32 chunks of 250 frames: the intra-chunk attention
# over 128 sequences of 250, the inter-chunk one over 1000 of 32
SSE8_K2_CASES = ((128, 8, 250, 32), (1000, 8, 32, 32))


@contextlib.contextmanager
def abs_calls():
    """Record (B, H, T, D, k_len) of every call that reaches
    flash_attention through the attention modules."""
    from aps_tpu_torch.asr.transformer import impl
    real = impl.flash_attention
    seen = []

    def record(q, k, v, bias=None, k_len=None, causal=False,
               softmax_scale=None):
        B, H, T, D = q.shape
        seen.append((B, H, T, D, None if k_len is None else
                     tuple(k_len.tolist()), causal))
        return real(q, k, v, bias=bias, k_len=k_len, causal=causal,
                    softmax_scale=softmax_scale)

    impl.flash_attention = record
    try:
        yield seen
    finally:
        impl.flash_attention = real


def sse8_mixtures(N: int, S: int, spks: int, gen):
    """`spks` modulated tones with noise and their sum, N x S each."""
    import torch
    t = torch.arange(S) / SEP_SR
    ref = []
    for spk in range(spks):
        f0 = (150 + 300 * torch.rand((N, 1), generator=gen)) * (1 + 2 * spk)
        ref.append(0.3 * torch.sin(2 * math.pi * f0 * t) *
                   (0.6 + 0.4 * torch.sin(2 * math.pi * 7 * t)) +
                   0.02 * torch.randn((N, S), generator=gen))
    return {"mix": sum(ref), "ref": ref if spks > 1 else ref[0]}


def check_k2_cases(dev, gen, cases):
    """K2's forward, dq and dk/dv at (B, H, T, D, k_len or None) each,
    against mha_reference and mha_backward_reference, timed beside the
    plain versions; each once more with launches queued, against the
    tensor cores' bound. Where every batch entry has a key (no bias), the
    library's scaled_dot_product_attention computes the same function
    (without a mask where every key is valid): its forward, and autograd
    through it for dq, dk and dv together, are held against the kernels
    and timed, the forward also queued. A head width the kernels are not
    built for (8: the CPU tests' SepFormer) is launched as flash_attention
    launches it, unpadded, in the tiles of the next of 16, 32 and 64, and
    its forward's time is printed over the library's, one call against
    one and queued against queued. -> {"fwd" |
    "dq" | "dkv": rows}, each row carrying those numbers in a dict after
    the bound."""
    import torch

    from aps_tpu_torch.ops.attention import (flash_attention,
                                             launch_backward_kernel,
                                             launch_forward,
                                             mha_backward_reference,
                                             mha_reference)
    rows = {"fwd": [], "dq": [], "dkv": []}
    for B, H, T, D, lens in cases:
        lens = list(lens) if lens else [T] * B
        q, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                       for _ in range(4))
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D**-0.5
        label = (f"B={B} H={H} D={D} T={T} k_len="
                 + (f"{lens[0]}" if len(set(lens)) == 1 else "ragged")
                 + ("" if D in (16, 32, 64, 128) else " unpadded"))
        got = flash_attention(q, k, v, k_len=klen)
        want = mha_reference(q, k, v, k_len=klen)
        out, lse = launch_forward(q, k, v, None, klen, scale, False, True)
        delta = torch.full_like(lse, float("nan"))
        run = lambda kernel: launch_backward_kernel(  # noqa: E731
            kernel, q, k, v, None, klen, do, lse, out, delta, scale, False)
        dq, (dk, dv) = run("dq"), run("dkv")
        ref = mha_backward_reference(q, k, v, do, k_len=klen)
        torch.cuda.synchronize()
        errs = {"fwd": (got - want).abs().max().item(),
                "dq": (dq - ref[0]).abs().max().item(),
                "dkv": max((dk - ref[1]).abs().max().item(),
                           (dv - ref[2]).abs().max().item())}
        for name, tol in (("fwd", TOL_ATT), ("dq", TOL_GRAD),
                          ("dkv", TOL_GRAD)):
            if not errs[name] <= tol:
                fail(f"flash_attention {name} [{label}]: max abs err "
                     f"{errs[name]} > {tol}")
        pairs = H * valid_pairs(T, lens, False)
        qsize = B * H * T * D
        reads = 4 * (4 * qsize + 2 * B * H * T + B)
        plain_bwd = time_ms(lambda: mha_backward_reference(
            q, k, v, do, k_len=klen), iters=5, warmup=1)
        fwd = lambda: flash_attention(q, k, v, k_len=klen)  # noqa: E731
        calls = {"fwd": fwd, "dq": lambda: run("dq"),
                 "dkv": lambda: run("dkv")}
        ops = {"fwd": 2 * 2 * D * pairs, "dq": 3 * 2 * D * pairs,
               "dkv": 4 * 2 * D * pairs}
        bounds = {"fwd": bound_ms(4 * (4 * qsize + B), ops["fwd"]),
                  "dq": bound_ms(reads + 4 * qsize, ops["dq"]),
                  "dkv": bound_ms(reads + 8 * qsize, ops["dkv"])}
        plain = {"fwd": time_ms(lambda: mha_reference(q, k, v, k_len=klen)),
                 "dq": plain_bwd, "dkv": plain_bwd}
        library = {"fwd": None, "dq": None, "dkv": None}
        library_queued = None
        if min(lens) >= 1:
            # every key valid: the call as a user would write it, no mask
            sdpa = torch.nn.functional.scaled_dot_product_attention \
                if min(lens) == T else \
                lambda *qkv: _sdpa(*qkv, klen)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*leaves)
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                lib_out, leaves, do, retain_graph=True)
            lib_errs = ((lib_out.detach() - got).abs().max().item(),
                        max((g - mine).abs().max().item() for g, mine in
                            zip(lib_bwd(), (dq, dk, dv))))
            if not (lib_errs[0] <= TOL_ATT and lib_errs[1] <= TOL_GRAD):
                fail(f"flash_attention [{label}]: forward {lib_errs[0]} and "
                     f"backward {lib_errs[1]} from the library's "
                     "scaled_dot_product_attention")
            with torch.no_grad():
                library["fwd"] = time_ms(lambda: sdpa(q, k, v))
                library_queued = time_ms(lambda: sdpa(q, k, v),
                                         calls=QUEUED_CALLS)
            library["dq"] = library["dkv"] = time_ms(lib_bwd)
        for kernel in rows:
            queued = time_ms(calls[kernel], calls=QUEUED_CALLS)
            tensor_ms = tensor_core_ms(ops[kernel])
            if not queued >= tensor_ms:
                fail(f"flash_attention {kernel} [{label}]: {queued} ms reads "
                     f"below the tensor cores' bound {tensor_ms}")
            ms = time_ms(calls[kernel])
            more = {"ms_queued": queued, "tensor_core_bound_ms": tensor_ms,
                    "library_ms": library[kernel]}
            if kernel == "fwd" and library_queued is not None:
                more.update(library_ms_queued=library_queued,
                            queued_over_library=queued / library_queued,
                            over_library=ms / library["fwd"])
            rows[kernel].append((label, errs[kernel], ms, plain[kernel])
                                + bounds[kernel] + (more,))
        fwd = rows["fwd"][-1][6]
        if D not in (16, 32, 64, 128) and "queued_over_library" in fwd:
            print(f"K2's forward at heads of {D} unpadded [{label}]: through "
                  f"flash_attention {rows['fwd'][-1][2]:.4f} ms, queued "
                  f"{fwd['ms_queued']:.4f}; the library's "
                  f"{library['fwd']:.4f} ms, queued {library_queued:.4f}: "
                  f"{fwd['over_library']:.3f}x one call against one, "
                  f"{fwd['queued_over_library']:.3f}x queued against queued",
                  flush=True)
    return rows


def sse8_phase(gen, dev, card):
    """For each of SSE8_MODELS: the model with seeded weights under its
    task, one training pass on SSE8_UTTS mixtures card vs CPU (every
    weight matrix's gradient held by the referee rule, float64 on the CPU:
    PHASEN's float32 passes drift from float64 more than the devices
    differ, and the rule holds the others as tightly as the plain one
    where they do not), and one mixture separated on both; the sepformers'
    K2 calls recorded, and on the card their separation must launch K2's
    forward (the heads of 8 of the CPU tests' SepFormer too, unpadded);
    then K2's forward, dq and dk/dv at those shapes and
    at SSE8_K2_CASES against their plain versions. -> ({model: launches of
    its pass}, K2's rows by kernel, numbers)."""
    import torch

    from aps_tpu_torch.flagship import init_weights
    from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_transform
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    beg = time.perf_counter()
    launched_of, numbers, shapes = {}, {}, set()
    from aps_tpu_torch.ops import build
    for name, (conf, enh, task_name, task_conf, S) in SSE8_MODELS.items():
        kwargs = dict(conf)
        if enh is not None:
            kwargs["enh_transform"] = aps_transform("enh")(**enh)
        net = aps_sse_nnet(name.split("#")[0])(**kwargs)
        init_weights(net, gen)
        task = aps_task(task_name, net, **task_conf)
        egs = sse8_mixtures(SSE8_UTTS, S, task_conf["num_spks"], gen)
        weights = [k for k, p in net.named_parameters()
                   if p.requires_grad and p.dim() >= 2]
        grads = tuple(weights[i] for i in sorted(
            {0, len(weights) // 2, len(weights) - 1}))
        launched = {}
        with abs_calls() as seen:
            loss_g, loss_c, errs = step_pass_check(
                task, egs, dev, grads, SSE8_UTTS, referee=True,
                referee_on="cpu", launched=launched)
        shapes |= {c[:5] for c in seen}
        k2 = {"flash_attention", "flash_attention_dq",
              "flash_attention_dkv"} if "sepformer" in name else set()
        if set(launched["card32"]) != k2:
            fail(f"{name}'s pass launched {launched['card32']}")
        net.eval()
        outs = {}
        for where in ("cpu", dev):
            build.reset_launches()
            with torch.no_grad(), matmul_precision(INFERENCE_PRECISION,
                                                   torch.device(where)):
                sep = net.to(where).infer(egs["mix"][0].to(where))
            sep = sep if isinstance(sep, (list, tuple)) else [sep]
            outs[str(where)] = [s.float().cpu() for s in sep]
            sep_launched = {k: v for k, v in build.LAUNCHES.items() if v}
            want = {"flash_attention"} if "sepformer" in name and \
                where == dev else set()
            if set(sep_launched) != want:
                fail(f"{name}'s separation on {where} launched "
                     f"{sep_launched}")
        scale = max(float(s.abs().max()) for s in outs["cpu"])
        sep_err = max(float((a - b).abs().max()) for a, b in
                      zip(outs["cpu"], outs[str(dev)]))
        if not (len(outs["cpu"]) == len(outs[str(dev)]) and
                all(torch.isfinite(s).all() for s in outs[str(dev)]) and
                sep_err <= TOL_SEP_REL * scale):
            fail(f"{name} separation card vs CPU: {sep_err} (largest sample "
                 f"{scale})")
        launched_of[name] = launched["card32"]
        numbers[name] = {"loss": (loss_g, loss_c), "grads": errs,
                         "sep_err": sep_err}
        print(f"{name} under {task_name} ({SSE8_UTTS} x {S} samples): "
              f"training pass loss card {loss_g:.6f} vs CPU {loss_c:.6f}, "
              "the gradients' distance (card, CPU) from the CPU's float64 "
              "pass relative to the largest entry " + ", ".join(
                  f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in errs.items())
              + f"; launches {launched['card32']}; one mixture separated "
              f"card vs CPU {sep_err:.3e} (largest sample {scale:.3f}) "
              f"({card})", flush=True)
    cases = sorted(shapes, key=str) + [c + (None,) for c in SSE8_K2_CASES]
    rows = check_k2_cases(dev, gen, cases)
    numbers["phase_s"] = time.perf_counter() - beg
    print(f"the eight sse@ models' phase took {numbers['phase_s']:.1f} s "
          f"({card})", flush=True)
    return launched_of, rows, numbers


# streaming: aishell_v1/1f's transform and nnet_conf as
# streaming_asr@transducer (and, with the same encoder, streaming_asr@ctc)
# with chunks of 4 encoder frames and 3 chunks of left context (the
# encoder sets its relative-position radii from them); rt_sse@dfsmn at its
# documented defaults (docs/instruction.md: dim 1024, project 512, 4 layers,
# lctx and rctx 3, 257 bins) and rt_sse@freq_xfmr at freq_xfmr_phase's
# widths (6 rel-pose layers of 512, 8 heads, 257 bins) with chunk 4 and
# lctx 3, both under wham 1a's transform, as one-branch enhancers (the
# first source the reference) trained in time mode under sse@snr (the
# SiSNR of a seeded model's output, near -20 dB, is a small difference of
# large sums: its float32 gradient lies some 1e-3 from float64). No
# attention kernel is on these paths: the streaming attention is dense
# (chunk-context mask offline, the per-layer caches in a step); K1 is the
# ASR path's front end
STREAM_ENC = {"chunk": 4, "lctx": 3}
STREAM_GRADS = ("encoder.pose_layer.embed.weight",
                "encoder.encoder.layer_0.self_attn.in_proj.weight",
                "decoder.decoder.OptimizedLSTMCell_0.weight_hh_l0",
                "decoder.enc_proj.weight", "decoder.output.weight")
# rt_ctc's chunk: 32 feature frames, one chunk of 4 frames after the
# conv2d projection's 8x subsampling
STREAM_CTC_FRAMES = 32
STREAM_CTC_BEAM = ["--beam-size", "4", "--batch-size", "8"]
RT_SSE_CONFS = {
    "rt_sse@dfsmn": dict(dim=1024, num_bins=257, num_layers=4, project=512,
                         lctx=3, rctx=3, training_mode="time"),
    "rt_sse@freq_xfmr": dict(num_bins=257, num_layers=6, chunk=4, lctx=3,
                             training_mode="time",
                             arch_kwargs=dict(att_dim=512, nhead=8,
                                              feedforward_dim=2048,
                                              att_dropout=0.0,
                                              ffn_dropout=0.0)),
}
RT_SSE_BATCH = 16
RT_SSE_SECS = 4
RT_ENH_SECS = 1  # the frame-by-frame loop of rt_enh, card vs CPU
# step vs the offline pass of the same model on the same device, and the
# exported program vs the module: float32 sums of the same terms in
# another order, relative to the largest mask entry
TOL_STREAM = 1e-4


def enh_transform_float64(parts=("stft", "features", "istft")):
    """Witness: the enh transform's STFT, features and iSTFT (those of
    `parts`) in float64 and rounded back to complex64 / float32, the
    network in float32; a teacher's transform too. Its `stft64` attribute
    says whether the STFT is among them."""
    import torch

    def witness(task) -> None:
        for nnet in (task.nnet, getattr(task, "teacher_nnet", None)):
            if nnet is None:
                continue
            tf = nnet.enh_transform.double()
            encode, features, decode = tf.encode, tf.forward, tf.decode
            if "stft" in parts:
                tf.encode = lambda wav, wav_len=None, encode=encode, tf=tf: (
                    encode(wav.double(), wav_len)[0].to(torch.complex64),
                    tf.num_frames(wav_len))
            if "features" in parts:
                tf.forward = lambda stft, training=False, features=features: \
                    features(stft.to(torch.complex128),
                             training=training).float()
            if "istft" in parts:
                tf.decode = lambda stfts, decode=decode: [
                    w.float() for w in decode(
                        [s.to(torch.complex128) for s in stfts])]
    witness.stft64 = "stft" in parts
    return witness


def rt_network_float64(task) -> None:
    """Witness: the rt_sse model's network (dfsmn or xfmr) in float64,
    the enh transform and the masking in float32."""
    nnet = task.nnet
    net = nnet.dfsmn if hasattr(nnet, "dfsmn") else nnet.xfmr
    net.double()
    forward = nnet._network
    nnet._network = lambda feats: forward(feats.double()).float()


RT_SSE_WITNESSES = {"transform64": enh_transform_float64(),
                    "stft64": enh_transform_float64(("stft",)),
                    "features64": enh_transform_float64(("features",)),
                    "istft64": enh_transform_float64(("istft",)),
                    "network64": rt_network_float64}


def stream_launches(passes: int = 0, steps: int = 0):
    """The launch counts of `passes` passes of a streaming ASR model: K1
    once each, nothing else (the streaming attention is dense, outside any
    kernel; the prediction net cuDNN's LSTM, the joint cuBLAS)."""
    from aps_tpu_torch.ops import build
    want = {kernel: 0 for kernel in build.LAUNCHES}
    want["fused_logmel"] = passes
    return want


def _streaming_conf(data: Path, nnet: str) -> dict:
    """data/train.yaml (TRD_YAML with the corpus) as `nnet`: the encoder
    chunked by STREAM_ENC; streaming_asr@ctc without the prediction net,
    under asr@ctc."""
    conf = json.loads((data / "train.yaml").read_text())
    conf["nnet"] = nnet
    conf["nnet_conf"]["enc_kwargs"].update(STREAM_ENC)
    if nnet == "streaming_asr@ctc":
        conf["nnet_conf"].pop("dec_kwargs")
        conf["task"], conf["task_conf"] = "asr@ctc", {}
    return conf


def streaming_ctc_check(root: Path, data: Path, dev, card):
    """streaming_asr@ctc with the transducer's encoder: train_am, one
    one-step epoch (K1 once a pass); decode_batch on the decode set through
    CtcApi (one utterance after another: K1 once each); ctc_logits card vs
    CPU on TRD_CHECK_UTTS of them; rt_ctc on one, chunk by chunk on the
    card, its step logits held against the same steps on the CPU. ->
    (launches of training, of the decode, numbers)."""
    import torch

    from aps_tpu_torch.cmd import decode_batch, rt_ctc, train_am
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.io import read_audio
    from aps_tpu_torch.libs import aps_transform
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    (data / "ctc.yaml").write_text(json.dumps(
        _streaming_conf(data, "streaming_asr@ctc"), indent=2))
    cpt = root / "ctc"
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main([
            "--conf", str(data / "ctc.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(TRD_BATCH_SIZE),
            "--epochs", "1", "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches_train = dict(build.LAUNCHES)
    losses = _epoch_losses(cpt / "trainer.log", "train")
    if launches_train != stream_launches(passes=3) or \
            type(trainer.task.nnet).__name__ != "CtcASR" or \
            not all(map(math.isfinite, losses)):
        fail(f"train_am (streaming_asr@ctc): launches {launches_train}, "
             f"losses {losses}")
    scp = root / "test" / "wav.scp"
    keys = [ln.split()[0] for ln in scp.read_text().splitlines()]
    best = root / "ctc.decode"
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = decode_batch.main([str(scp), str(best), "--am", str(cpt),
                                   "--am-tag", "last", "--dict",
                                   str(root / "dict")] + STREAM_CTC_BEAM)
    launches_dec = dict(build.LAUNCHES)
    lines = best.read_text().splitlines()
    if len(lines) != len(keys) or \
            launches_dec != stream_launches(passes=len(keys)) or \
            not all(map(math.isfinite, stats["scores"].values())):
        fail(f"decode_batch (streaming_asr@ctc): {len(lines)} lines, "
             f"launches {launches_dec}")
    wavs = {ln.split()[0]: read_audio(ln.split()[1])
            for ln in scp.read_text().splitlines()[:TRD_CHECK_UTTS]}
    models = {w: load_checkpoint(str(cpt), "last")["nnet"].to(w)
              for w in ("cpu", dev)}
    logits = {}
    for where, model in models.items():
        with torch.no_grad(), matmul_precision(INFERENCE_PRECISION,
                                               torch.device(where)):
            logits[str(where)] = [model.ctc_logits(torch.from_numpy(
                w)[None].to(where))[0][0].cpu() for w in wavs.values()]
    scale = max(float(x.abs().max()) for x in logits["cpu"])
    err = max(float((a - b).abs().max()) for a, b in
              zip(logits["cpu"], logits[str(dev)]))
    if not err <= TOL_ATT * max(scale, 1.0):
        fail(f"streaming_asr@ctc ctc_logits card vs CPU: {err} (largest "
             f"{scale})")
    # rt_ctc on the card, then the same chunks through step on the CPU
    key, wav = next(iter(wavs.items()))
    build.reset_launches()
    beg = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        hyp = rt_ctc.main([str(root / "test" / f"{key}.wav"), "--checkpoint",
                           str(cpt), "--tag", "last", "--chunk-frames",
                           str(STREAM_CTC_FRAMES)])
    rt_secs = time.perf_counter() - beg
    if build.LAUNCHES["fused_logmel"] != 1:
        fail(f"rt_ctc launched {dict(build.LAUNCHES)}")
    conf = json.loads((cpt / "train.yaml").read_text())
    steps = {}
    for where, model in models.items():
        tf = aps_transform("asr")(**conf["asr_transform"]).to(where).eval()
        with torch.no_grad(), matmul_precision(INFERENCE_PRECISION,
                                               torch.device(where)):
            feats, _ = tf(torch.from_numpy(wav)[None].to(where), None)
            state, outs = None, []
            for t in range(0, feats.shape[1], STREAM_CTC_FRAMES):
                out, state = model.step(feats[:, t:t + STREAM_CTC_FRAMES],
                                        state)
                outs.append(out[0].cpu())
        steps[str(where)] = torch.cat(outs)
    step_err = float((steps["cpu"] - steps[str(dev)]).abs().max())
    toks, prev = [], conf["nnet_conf"]["vocab_size"] - 1
    for tok in steps[str(dev)].argmax(-1).tolist():
        if tok != prev and tok != conf["nnet_conf"]["vocab_size"] - 1:
            toks.append(tok)
        prev = tok
    scale = float(steps["cpu"].abs().max())
    if not (step_err <= TOL_ATT * max(scale, 1.0) and toks == hyp):
        fail(f"rt_ctc: step logits card vs CPU {step_err} (largest {scale}),"
             f" tokens {hyp} vs the card's steps {toks}")
    dur = len(wav) / SR
    print(f"streaming_asr@ctc (the same chunked encoder, CTC output layer): "
          f"train_am one step, launches {launches_train}, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; decode_batch "
          f"{' '.join(STREAM_CTC_BEAM)} through CtcApi: {len(keys)} x "
          f"{TRD_SECS} s in {stats['decode_secs']:.4f} s, launches "
          f"{launches_dec}; ctc_logits card vs CPU on {len(wavs)} "
          f"utterances {err:.3e} (largest {scale:.3f}); rt_ctc on {dur:.1f} "
          f"s in chunks of {STREAM_CTC_FRAMES} frames: {len(hyp)} tokens, "
          f"{rt_secs:.3f} s with the checkpoint's loading, step logits card "
          f"vs CPU {step_err:.3e} ({card})", flush=True)
    return launches_train, launches_dec, {
        "logits_err": err, "step_err": step_err, "rt_ctc_s": rt_secs,
        "decode_s": stats["decode_secs"]}


def streaming_asr_phase(root: Path, gen, dev, card):
    """aishell_v1/1f as streaming_asr@transducer with the chunked conformer
    (STREAM_ENC): train_am and the timed steps (trd_train_phase: K1 once a
    pass, nothing else), the training pass card vs CPU (trd_pass_check),
    decode_batch with run.sh's stage 4 and the searches card vs CPU
    (trd_decode_phase, no LM); then streaming_asr@ctc on the same encoder
    (streaming_ctc_check); K1 at the decode's and the step's batches.
    -> (launches by path, K1's rows, numbers)."""
    from types import SimpleNamespace

    from aps_tpu_torch.libs import aps_transform
    beg = time.perf_counter()
    root.mkdir()
    data = write_trd_recipe(root, gen)
    conf = _streaming_conf(data, "streaming_asr@transducer")
    (data / "train.yaml").write_text(json.dumps(conf, indent=2))
    label = "streaming 1f"
    cpt, egs, launches_train, numbers, seen = trd_train_phase(
        root, data, dev, card, label=label, launches_of=stream_launches)
    numbers.update(trd_pass_check(root, data, egs, dev, gen, card,
                                  label=label, launches_of=stream_launches,
                                  grads=STREAM_GRADS))
    launches_dec, _, dec = trd_decode_phase(
        root, write_trd_decodable(cpt, root), gen, dev, card, label=label,
        launches_of=stream_launches, with_lm=False)
    numbers["decode"] = dec
    launches_ctc, launches_ctc_dec, numbers["ctc"] = streaming_ctc_check(
        root, data, dev, card)
    tf = aps_transform("asr")(**conf["asr_transform"])
    rows = {"fused_logmel": check_fbank(
        dev, SimpleNamespace(asr_transform=tf),
        (("streaming 1f decode", dec.pop("decode_wav")),
         ("streaming 1f training", seen["wav"])))[0]}
    numbers["phase_s"] = time.perf_counter() - beg
    print(f"the streaming ASR phase took {numbers['phase_s']:.1f} s "
          f"({card})", flush=True)
    launches = {"streaming_transducer_train_run": launches_train,
                "streaming_transducer_decode": launches_dec,
                "streaming_ctc_train_run": launches_ctc,
                "streaming_ctc_decode": launches_ctc_dec}
    return launches, rows, numbers


def rt_sse_phase(root: Path, name: str, gen, dev, card):
    """RT_SSE_CONFS[name] under wham 1a's transform, sse@snr with one
    source: train_ss on RT_SSE_BATCH seeded mixtures of RT_SSE_SECS s
    (_train_ss_run; no kernel launched), a training pass card vs CPU
    (referee rule, float64 on the card); separate on ZOO_SEP_UTTS
    mixtures, card vs CPU on ZOO_SEP_CHECK; step chunk by chunk on one
    mixture's features against the offline masks on the card and against
    the CPU's steps; export of mask_predict on the card, RtExported
    against RtModel on the card and RtModel on the CPU; rt_enh frame by
    frame on RT_ENH_SECS s card vs CPU. -> (launches of training, of
    separation, numbers). Every entry reads last.ckpt: best.ckpt is
    written only when a validation improves on the first."""
    import numpy as np
    import torch

    from aps_tpu_torch import deploy
    from aps_tpu_torch.cmd import export, rt_enh, separate
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    beg = time.perf_counter()
    root.mkdir()
    wham = load_ss_conf(str(REPO / FREQ_XFMR_YAML))
    names = ("mix", "s1")
    data = root / "data"
    data.mkdir()
    write_mixtures(data, RT_SSE_BATCH, gen, WHAM_SR, RT_SSE_SECS, names)
    scps = {"mix_scp": str(data / "mix.scp"),
            "ref_scp": str(data / "s1.scp")}
    conf = dict(nnet=name, nnet_conf=RT_SSE_CONFS[name],
                enh_transform=wham["enh_transform"], task="sse@snr",
                task_conf={"num_spks": 1, "permute": False},
                trainer_conf=wham["trainer_conf"],
                data_conf={"fmt": "se@chunk",
                           "loader": {"chunk_size": RT_SSE_SECS * WHAM_SR,
                                      "sr": WHAM_SR},
                           "train": scps, "valid": scps})
    _, cpt, egs, launches_train, losses, valid, step = _train_ss_run(
        root, conf, RT_SSE_BATCH, dev)
    if any(launches_train.values()):
        fail(f"train_ss ({name}) launched {launches_train}")
    task = _seeded_task(conf)
    weights = [k for k, p in task.nnet.named_parameters() if p.dim() >= 2]
    grads = tuple(weights[i] for i in sorted(
        {0, len(weights) // 2, len(weights) - 1}))
    loss_g, loss_c, errs = step_pass_check(task, egs, dev, grads,
                                           ZOO_CHECK_UTTS, referee=True,
                                           witnesses=RT_SSE_WITNESSES,
                                           stft_first=grads[0])
    tt = root / "tt"
    tt.mkdir()
    mixes = write_mixtures(tt, ZOO_SEP_UTTS, gen, WHAM_SR, RT_SSE_SECS,
                           names)
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = separate.main([str(tt / "mix.scp"), str(root / "sep"),
                               "--checkpoint", str(cpt), "--tag", "last",
                               "--sr", str(WHAM_SR)])
    torch.cuda.synchronize()
    launches_sep = dict(build.LAUNCHES)
    if any(launches_sep.values()):
        fail(f"separate ({name}) launched {launches_sep}")
    _sep_files(root / "sep", sorted(mixes), names, WHAM_SR,
               RT_SSE_SECS * WHAM_SR)
    sep_err, sep_scale = _card_vs_cpu_separation(cpt, mixes, dev, name,
                                                 tag="last")
    # the streaming entry: chunk by chunk against the offline masks
    models = {w: load_checkpoint(str(cpt), "last")["nnet"].to(w)
              for w in ("cpu", dev)}
    mix = mixes[sorted(mixes)[0]]
    chunk = 4
    steps, offline, step_ms = {}, None, []
    for where, model in models.items():
        with torch.no_grad(), matmul_precision(INFERENCE_PRECISION,
                                               torch.device(where)):
            stft, _ = model.enh_transform.encode(
                torch.from_numpy(mix)[None].to(where), None)
            feats = model.enh_transform(stft)
            T = feats.shape[1] - feats.shape[1] % chunk
            if name == "rt_sse@dfsmn":
                padded = model._context_pad(feats)
                ctx = model.lctx_total + model.rctx_total
                blocks = [padded[:, t:t + chunk + ctx]
                          for t in range(0, T, chunk)]
            else:
                blocks = [feats[:, t:t + chunk] for t in range(0, T, chunk)]
            state, outs = None, []
            for block in blocks:
                t0 = time.perf_counter()
                mask, state = model.step(block, state)
                if where != "cpu":
                    torch.cuda.synchronize()
                    step_ms.append(1e3 * (time.perf_counter() - t0))
                outs.append(mask.cpu())
            steps[str(where)] = torch.cat(outs, -1)
            if where != "cpu":
                offline = model._mask_post(model._network(
                    model._context_pad(feats)))[0][..., :T].cpu()
    scale = float(offline.abs().max())
    errs_step = (float((steps[str(dev)] - offline).abs().max()),
                 float((steps[str(dev)] - steps["cpu"]).abs().max()))
    if not max(errs_step) <= TOL_STREAM * max(scale, 1.0):
        fail(f"{name} step: card vs offline {errs_step[0]}, card vs CPU "
             f"{errs_step[1]} (largest mask entry {scale})")
    # mask_predict through torch.export on the card
    W = models["cpu"].lctx_total + 1 + models["cpu"].rctx_total \
        if name == "rt_sse@dfsmn" else 4 * chunk
    block = np.random.default_rng(SEED).standard_normal(
        (1, W, 257)).astype(np.float32)
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        export.main([str(cpt), str(root / "export"), "--tag", "last",
                     "--num-frames", str(W), "--num-bins", "257"])
        export_s = time.perf_counter() - t0
    outs = {"exported": deploy.RtExported(str(root / "export")),
            "card": deploy.RtModel(str(cpt), cpt_tag="last"),
            "cpu": deploy.RtModel(str(cpt), cpt_tag="last", device="cpu")}
    outs = {k: np.frombuffer(r.forward_bytes(block.tobytes(), W, 257)[0],
                             dtype=np.float32) for k, r in outs.items()}
    scale = float(np.abs(outs["cpu"]).max())
    export_errs = (float(np.abs(outs["exported"] - outs["card"]).max()),
                   float(np.abs(outs["card"] - outs["cpu"]).max()))
    if not max(export_errs) <= TOL_STREAM * max(scale, 1.0):
        fail(f"{name} export: exported vs RtModel {export_errs[0]}, card vs "
             f"CPU {export_errs[1]} (largest {scale})")
    # rt_enh, frame by frame, card vs CPU
    key = sorted(mixes)[1]
    short = tt / "short.wav"
    from aps_tpu_torch.io import write_audio
    write_audio(str(short), mixes[key][:RT_ENH_SECS * WHAM_SR], sr=WHAM_SR)
    enh, rt_s = {}, 0.0
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            enh[where] = rt_enh.main([str(short), str(root / f"{where}.wav"),
                                      "--checkpoint", str(cpt), "--tag",
                                      "last", "--device", where])
        if where == "cuda":
            rt_s = time.perf_counter() - t0
    scale = float(np.abs(enh["cpu"]).max())
    rt_err = float(np.abs(enh["cuda"] - enh["cpu"]).max())
    if not (np.isfinite(enh["cuda"]).all() and
            rt_err <= TOL_SEP_REL * max(scale, 1e-3)):
        fail(f"{name} rt_enh card vs CPU: {rt_err} (largest {scale})")
    rate = stats["audio_secs"] / stats["sep_secs"]
    numbers = dict(step, sep_rate=rate, step_ms=statistics.median(step_ms),
                   phase_s=time.perf_counter() - beg)
    hop = wham["enh_transform"]["frame_hop"]
    print(f"{name} under sse@snr (one source): train_ss on {RT_SSE_BATCH} "
          f"x {RT_SSE_SECS} s at {WHAM_SR} Hz, {ZOO_TRAIN_EPOCHS} one-step "
          f"epochs and {valid} validation passes then {ZOO_TIMED_STEPS} timed "
          f"steps, no kernel launched; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step: device "
          f"{step['device_ms']:.3f} ms (traced; {step['host_launches']} "
          f"launches), host {step['host_s']:.4f} s median, peak memory "
          f"{step['peak_gib']:.3f} GiB; the kernels with the most device "
          f"time (ms): {step['top']} ({card})", flush=True)
    print(f"{name} training pass card vs CPU on {ZOO_CHECK_UTTS} mixtures: "
          f"loss {loss_g:.6f} vs {loss_c:.6f}; gradients' distance (card, "
          "CPU, then the card's witnesses " + ", ".join(RT_SSE_WITNESSES)
          + ") from the card's float64 pass relative to the largest entry "
          + ", ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in e)
                      for k, e in errs.items())
          + f"; separate, batch 1: {ZOO_SEP_UTTS} mixtures at {rate:.2f} "
          f"audio-s/s, card vs CPU {sep_err:.3e} (largest sample "
          f"{sep_scale:.3f}) ({card})", flush=True)
    print(f"{name} step on one mixture in chunks of {chunk} frames "
          f"({1e3 * chunk * hop / WHAM_SR:.0f} ms of audio): card vs the "
          f"offline masks {errs_step[0]:.3e}, card vs CPU {errs_step[1]:.3e}; "
          f"a step {numbers['step_ms']:.3f} ms median on the card (host "
          f"clock, synchronised); export of mask_predict at 1 x {W} x 257 in "
          f"{export_s:.2f} s, RtExported vs RtModel {export_errs[0]:.3e}, "
          f"card vs CPU {export_errs[1]:.3e}; rt_enh on {RT_ENH_SECS} s "
          f"frame by frame: card vs CPU {rt_err:.3e} (largest sample "
          f"{scale:.3f}), {rt_s:.3f} s on the card with the checkpoint's "
          f"loading; the phase took {numbers['phase_s']:.1f} s ({card})",
          flush=True)
    return launches_train, launches_sep, numbers


# ---------------------------------------------------------------------------
# kaldi feature archives, the decoding options, sse@ts, chunked separation
# of multi-channel input, and K2 and K3 at heads of 96 and 128
# ---------------------------------------------------------------------------
KALDI_UTTS = 32  # the flagship's training batch, one step an epoch
KALDI_EPOCHS = 2
KALDI_DECODE_UTTS = 8
KALDI_CHECK_UTTS = 2  # of the decode, in the card-vs-CPU search
KALDI_PASS_UTTS = 4  # of the batch, in the card-vs-CPU training pass
KALDI_ARGS = ["--beam-size", "8", "--ctc-weight", "0.4", "--max-len", "40",
              "--allow-partial", "true"]
KALDI_SEARCH = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=8, nbest=1,
                    max_len=40, ctc_weight=0.4, allow_partial=True)
# bfloat16 decoding, card vs CPU: both round the same weights and the
# same encoder output to bfloat16 and compute in float32 from there, so
# they part only as float32 sums in another order do, and where an entry
# both round lies within that of a rounding boundary and goes to the next
# bfloat16 value on one side (some 1e-5 of a score). A float32-sized gate,
# a fifth of TOL_SCORE (tests/test_torch_decode_opts.py holds the port
# against aps_tpu by the same gate); the float32 search must fail it
# the float32 decode's gate, card vs CPU (§2 of PERF.md): a best score
# within TOL_SCORE
TOL_SCORE = 1e-3
TOL_BF16_SCORE = 2e-4
# (the commands take --cov-penalty and keep cov_method v1, as aps_tpu's;
# v2 is the search's keyword)
DECODE_OPTIONS = {"float32": [], "bfloat16": ["--dtype", "bfloat16"],
                  "cov_v1": ["--cov-penalty", "0.5"]}
TS_UTTS = 16  # FREQ_XFMR_BATCH mixtures of FREQ_XFMR_SECS, one step
TS_SEP_UTTS = 4
MC_SECS = 8  # the 5-channel mixture separated in chunks
MC_CHUNK, MC_HOP = 4 * SR, 3 * SR
MC_CONF = dict(input_size=1285, num_bins=257, num_spks=1, hidden=512,
               num_layers=3, dropout=0.0, bidirectional=True)
WIDE_HEADS = (96, 128)
# K3 at the flagship step's (B, H, T, k_len) with 128-wide heads (a 512-wide
# encoder of 4 heads) and at the one-key corner; K2 at the long-form step's
WIDE_REL_CASES = ((TRAIN_UTTS, 4, 231, [200] * TRAIN_UTTS, False, 1, "step"),
                  (8, 4, 640, [1, 1, 640, 2, 1, 1, 640, 2], True, 4,
                   "corner"))
WIDE_ABS_CASES = ((8, 4, 690, [600] * 8, False, "step"),
                  (8, 4, 640, [1, 1, 640, 2, 1, 1, 640, 2], True, "corner"))
# the 2-layer conformer of width 512 with 4 heads (head dim 128)
WIDE_CONF = dict(att_dim=512, nhead=4, feedforward_dim=2048)
WIDE_PASS_UTTS = 4


def _features_model(gen, peaky: bool):
    """The full-width flagship fed with 80-dim features (no asr_transform),
    seeded weights (output layers x 8 with peaky) -> (conf, model)."""
    import torch

    from aps_tpu_torch.flagship import flagship_train_conf, init_weights
    from aps_tpu_torch.libs import aps_asr_nnet
    conf = flagship_train_conf(VOCAB)
    del conf["asr_transform"]
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    model = aps_asr_nnet(conf["nnet"])(**nnet_conf)
    init_weights(model, gen)
    if peaky:
        with torch.no_grad():
            model.decoder.output.weight.mul_(8.0)
            model.ctc_head.weight.mul_(8.0)
    return conf, model


def kaldi_phase(root: Path, dict_path: Path, gen, dev, card):
    """am@kaldi and decode from a feats.scp at full width: the flagship's
    80-dim log-mel features (its front end without the cmvn, K1 on the
    card) of KALDI_UTTS seeded 8 s utterances through the port's
    ArchiveWriter, one archive plain and one compressed (CM), read back;
    train_am of the flagship fed with features from the compressed archive,
    KALDI_EPOCHS one-step epochs (K3's forward and backward counted
    exactly, no K1); one training pass card vs CPU on KALDI_PASS_UTTS
    (PERF.md section 2's bounds); cmd.decode of KALDI_DECODE_UTTS from the
    plain feats.scp with peaky seeded weights (K3's forward 12 times an
    utterance, K4 once a search step, no K1), and the search card vs CPU on
    KALDI_CHECK_UTTS. -> (launches of training, of the decode)."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import decode, train_am
    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.flagship import flagship_conf
    from aps_tpu_torch.libs import aps_dataloader, aps_task, aps_transform
    from aps_tpu_torch.loader.kaldi_io import ArchiveWriter, ScriptReader
    from aps_tpu_torch.ops import build
    beg = time.perf_counter()
    root.mkdir()
    wavs = write_wavs(root, "kal", KALDI_UTTS, gen)
    front = dict(flagship_conf(VOCAB, small=False)["asr_transform"],
                 feats="fbank-log")
    tf = aps_transform("asr")(**front).to(dev)
    build.reset_launches()
    feats = {}
    with torch.no_grad():
        for key in sorted(wavs):
            x = torch.from_numpy(wavs[key])[None].to(dev)
            feats[key] = tf(x)[0][0].cpu().numpy()
    if build.LAUNCHES["fused_logmel"] != KALDI_UTTS or any(
            f.shape[1] != 80 for f in feats.values()):
        fail(f"the features: {build.LAUNCHES}, shapes "
             f"{sorted({f.shape for f in feats.values()})}")
    for name, compress in (("feats", ""), ("feats_cm", "CM")):
        with ArchiveWriter(str(root / f"{name}.ark"),
                           str(root / f"{name}.scp"),
                           compress=compress) as writer:
            for key in sorted(feats):
                writer.write(key, feats[key])
    plain = ScriptReader(str(root / "feats.scp"))
    packed = ScriptReader(str(root / "feats_cm.scp"))
    cm_err = 0.0
    for key, mat in feats.items():
        if not np.array_equal(plain[key], mat):
            fail(f"{key}: the plain archive reads back other values")
        span = float(mat.max() - mat.min())
        cm_err = max(cm_err, float(np.abs(packed[key] - mat).max()) / span)
    if not cm_err <= 1.0 / 63:
        fail(f"the compressed archive reads back {cm_err} of a matrix's "
             "range off (its coarsest step is 1/63)")
    labels = torch.randint(1, VOCAB - 3, (KALDI_UTTS, TRAIN_LABELS),
                           generator=gen).tolist()
    with open(root / "text", "w") as text, \
            open(root / "utt2num_frames", "w") as dur:
        for key, toks in zip(sorted(feats), labels):
            text.write(f"{key} {' '.join(f't{i}' for i in toks)}\n")
            dur.write(f"{key} {feats[key].shape[0]}\n")
    conf, model = _features_model(gen, peaky=False)
    for key in ("vocab_size", "sos", "eos", "ctc"):
        conf["nnet_conf"].pop(key)
    data = {"feats_scp": str(root / "feats_cm.scp"),
            "text": str(root / "text"),
            "utt2num_frames": str(root / "utt2num_frames")}
    conf["data_conf"] = {"fmt": "am@kaldi",
                         "loader": {"adapt_dur": 5000, "tokenizer": "word"},
                         "train": data, "valid": data}
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main([
            "--conf", str(root / "train.yaml"), "--dict", str(dict_path),
            "--checkpoint", str(root / "exp"), "--batch-size",
            str(KALDI_UTTS), "--epochs", str(KALDI_EPOCHS), "--seed",
            str(SEED)])
    torch.cuda.synchronize()
    launches_train = dict(build.LAUNCHES)
    log = root / "exp" / "trainer.log"
    losses = _epoch_losses(log, "train") + _epoch_losses(log, "valid")
    passes = KALDI_EPOCHS + len(_epoch_losses(log, "valid"))
    want = {k: 0 for k in build.LAUNCHES}
    want["flash_attention_rel"] = ENC_LAYERS * passes
    want.update({f"flash_attention_rel_{k}": ENC_LAYERS * KALDI_EPOCHS
                 for k in BACKWARD})
    if trainer.device.type != "cuda" or trainer.cur_step != KALDI_EPOCHS \
            or launches_train != want or not all(map(math.isfinite, losses)):
        fail(f"train_am from am@kaldi: {trainer.cur_step} steps on "
             f"{trainer.device}, losses {losses}, launches "
             f"{launches_train}, expected {want}")
    del trainer
    _, vocab = load_am_conf(str(root / "train.yaml"), str(dict_path))
    egs = next(iter(aps_dataloader(
        fmt="am@kaldi", train=False, vocab_dict=vocab,
        max_batch_size=KALDI_UTTS, **conf["data_conf"]["loader"], **data)))
    task = aps_task(conf["task"], model, blank=VOCAB - 1,
                    **conf["task_conf"])
    loss_g, loss_c, errs = step_pass_check(
        task, egs, dev, STEP_GRADS["flagship"], KALDI_PASS_UTTS,
        referee=False)
    # the decode: peaky seeded weights, the plain archive
    conf, model = _features_model(gen, peaky=True)
    cpt = root / "cpt"
    cpt.mkdir()
    (cpt / "train.yaml").write_text(json.dumps(
        dict(conf, data_conf={}), indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]}},
                    fd)
    keys = sorted(feats)[:KALDI_DECODE_UTTS]
    lines = (root / "feats.scp").read_text().splitlines()
    (root / "decode.scp").write_text(
        "".join(ln + "\n" for ln in lines if ln.split()[0] in keys))
    build.reset_launches()
    with scorer_steps() as steps, \
            contextlib.redirect_stdout(sys.stderr):
        stats = decode.main([str(root / "decode.scp"),
                             str(root / "best.txt"), "--am", str(cpt),
                             "--dict", str(dict_path)] + KALDI_ARGS)
    launches_dec = dict(build.LAUNCHES)
    want = {k: 0 for k in build.LAUNCHES}
    want.update({"flash_attention_rel": ENC_LAYERS * KALDI_DECODE_UTTS,
                 "ctc_score_step": len(steps)})
    if stats["utts"] != KALDI_DECODE_UTTS or launches_dec != want or \
            not all(map(math.isfinite, stats["scores"].values())):
        fail(f"decode from feats.scp: {stats['utts']} utterances, scores "
             f"{stats['scores']}, launches {launches_dec}, expected {want}")
    nnet = load_checkpoint(str(cpt))["nnet"]
    from aps_tpu_torch.asr.beam_search.transformer import beam_search
    score_err = 0.0
    for key in keys[:KALDI_CHECK_UTTS]:
        hyps = {str(w): beam_search(nnet.to(w), feats[key], device=w,
                                    **KALDI_SEARCH) for w in ("cpu", dev)}
        err = nbest_error(hyps["cpu"], hyps[str(dev)], TOL_SCORE)
        if err is None or abs(hyps[str(dev)][0]["score"] -
                              stats["scores"][key]) > TOL_SCORE:
            fail(f"{key}: decode from feats.scp card vs CPU {hyps} (the "
                 f"command's score {stats['scores'][key]})")
        score_err = max(score_err, err)
    print(f"kaldi: {KALDI_UTTS} utterances of the flagship's 80-dim log-mel "
          f"features written as a plain and a compressed (CM) archive "
          f"(read back: plain equal, CM within {cm_err:.3e} of a matrix's "
          f"range); train_am from am@kaldi (the compressed archive), "
          f"{KALDI_EPOCHS} one-step epochs of {KALDI_UTTS} utterances, "
          f"launches {launches_train}, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; its pass card vs CPU "
          f"on {KALDI_PASS_UTTS}: loss {loss_g:.6f} vs {loss_c:.6f}, "
          "gradients relative to the largest entry "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; decode of {KALDI_DECODE_UTTS} from the feats.scp in "
          f"{stats['decode_secs']:.3f} s, launches {launches_dec}, card vs "
          f"CPU on {KALDI_CHECK_UTTS}: best scores within {score_err:.3e}; "
          f"the phase took {time.perf_counter() - beg:.1f} s ({card})",
          flush=True)
    return launches_train, launches_dec


def decode_options_phase(root: Path, cpt: Path, wavs, shapes, dev, card):
    """decode_batch (DECODE_ARGS) of the first 8 utterances with each of
    DECODE_OPTIONS: float32, --dtype bfloat16 (the decoder's weights and
    the encoder output rounded to bfloat16, the encoder and the CTC table
    float32), and --cov-penalty 0.5 (cov_method v1: the scores of float32,
    the transformer search's coverage never grows); launch counts exact
    (K1 and K3 as float32's: no kernel runs in bfloat16). The batched
    search on the card with cov_method v2 (every score -inf), and the
    bfloat16 search card vs CPU on 2 utterances within TOL_BF16_SCORE,
    where the card's float32 search must lie outside it. -> launches by
    option."""
    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    from aps_tpu_torch.ops import build
    S = shapes[0]
    keys = sorted(wavs)[:8]
    lines = (root / "wav.scp").read_text().splitlines()
    scp = root / "wav8.scp"
    scp.write_text("".join(ln + "\n" for ln in lines
                           if ln.split()[0] in keys))
    stats, launches = {}, {}
    for option, extra in DECODE_OPTIONS.items():
        build.reset_launches()
        with scorer_steps() as steps, \
                contextlib.redirect_stdout(sys.stderr):
            stats[option] = decode_batch.main(
                [str(scp), str(root / f"best.{option}"), "--am", str(cpt),
                 "--dict", str(root / "dict")] + DECODE_ARGS + extra)
        launches[option] = dict(build.LAUNCHES)
        want = decode_launches("flagship", 1, len(steps))
        if launches[option] != want:
            fail(f"decode_batch {option}: launches {launches[option]}, "
                 f"expected {want}")
    base = stats["float32"]["scores"]
    if any(abs(stats["cov_v1"]["scores"][k] - base[k]) > 1e-6
           for k in keys):
        fail(f"cov_penalty v1 moved the scores: {stats['cov_v1']['scores']}"
             f" against {base}")
    nnet = load_checkpoint(str(cpt))["nnet"]
    kw = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=8, nbest=1, max_len=40,
              ctc_weight=0.4, allow_partial=True, pad_to=S)
    v2 = beam_search_batch(nnet.to(dev), [wavs[k] for k in keys],
                           device=dev, cov_penalty=0.5, cov_method="v2",
                           **kw)
    if any(h["score"] != -math.inf for hyps in v2 for h in hyps):
        fail(f"cov_penalty v2: scores {[h['score'] for h in v2[0]]}, "
             "expected -inf on every hypothesis")
    batch = [wavs[k] for k in keys[:2]]
    hyps = {}
    for where in ("cpu", dev):
        model = nnet.to(where)
        for dtype in ("float32", "bfloat16"):
            hyps[(str(where), dtype)] = beam_search_batch(
                model, batch, dtype=dtype, device=where, **kw)
    moved, err, cmd_err = [], 0.0, 0.0
    for i, key in enumerate(keys[:2]):
        c16 = hyps[("cpu", "bfloat16")][i][0]
        g32 = hyps[(str(dev), "float32")][i][0]
        g16 = hyps[(str(dev), "bfloat16")][i][0]
        moved.append(abs(c16["score"] - g32["score"]))
        err = max(err, abs(g16["score"] - c16["score"]))
        cmd_err = max(cmd_err, abs(stats["bfloat16"]["scores"][key] -
                                   g16["score"]))
        if g16["trans"] != c16["trans"] or err > TOL_BF16_SCORE or \
                cmd_err > TOL_BF16_SCORE or moved[-1] <= TOL_BF16_SCORE:
            fail(f"{key}: bfloat16 search card {g16['score']} vs CPU "
                 f"{c16['score']} (the card's float32 {g32['score']}, gate "
                 f"{TOL_BF16_SCORE}; the command's "
                 f"{stats['bfloat16']['scores'][key]})")
    secs = {k: v["decode_secs"] for k, v in stats.items()}
    print(f"decode options on 8 x {UTT_SECS} s (decode_batch, "
          f"{' '.join(DECODE_ARGS)}): seconds {secs}; --cov-penalty (v1) = "
          "the float32 scores, v2 (the search) -inf on every hypothesis; "
          "the card's float32 best scores lie "
          + ", ".join(f"{m:.3e}" for m in moved) + " from the CPU's "
          f"bfloat16 search, the card's bfloat16 search {err:.3e} and the "
          f"command's {cmd_err:.3e} (gate {TOL_BF16_SCORE}); "
          f"launches {launches['bfloat16']} ({card})", flush=True)
    return launches


def _write_simu_inputs(data: Path, gen, count: int):
    """count pairs of seeded speakers (write_mixtures' sources), a seeded
    noise and a synthetic room response as wav files, and simu.cfg lines
    of loader/simu.py's options that mix them -> simu.cfg."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    write_mixtures(data, count, gen, WHAM_SR, FREQ_XFMR_SECS, WHAM_NAMES)
    S = FREQ_XFMR_SECS * WHAM_SR
    noise = 0.1 * torch.randn(S, generator=gen).numpy()
    taps = int(0.25 * WHAM_SR)
    rir = torch.randn(taps, generator=gen).numpy() * np.exp(
        -np.arange(taps) / (0.04 * WHAM_SR)) * 0.3
    rir[10] += 1.0
    for name, sig in (("noise", noise), ("rir", rir)):
        pcm = np.clip(np.round(sig * 32767), -32768, 32767).astype(np.int16)
        wavfile.write(str(data / f"{name}.wav"), WHAM_SR, pcm)
    with open(data / "simu.cfg", "w") as cfg:
        for n in range(count):
            s1, s2 = (data / f"{k}{n:02d}.wav" for k in WHAM_NAMES[1:])
            rir_path = data / "rir.wav"
            cfg.write(f"mix{n:02d} --sr {WHAM_SR} --src-spk {s1},{s2} "
                      f"--src-sdr {n % 5 - 2} --src-rir {rir_path},"
                      f"{rir_path} --point-noise {data / 'noise.wav'} "
                      f"--point-noise-snr {10 + n % 7}\n")
    return data / "simu.cfg"


def ts_phase(root: Path, teacher: Path, gen, dev, card):
    """sse@ts: a student sse@freq_xfmr (FREQ_XFMR_CONF) distilled from
    freq_xfmr_phase's checkpoint (last.ckpt, frozen, eval mode) through
    train_ss on se@simu_cmd mixtures of seeded speakers, a noise and a
    room response written as files, ZOO_TRAIN_EPOCHS one-step epochs of
    TS_UTTS: K3's forward once a layer for the teacher and once for the
    student a pass, its backward kernels once a layer a step, counted
    exactly; a training pass card vs CPU on 2 mixtures (the float64
    referee on the CPU, the first layer's gradient held to the float32
    STFT's derived hold, both STFTs, teacher's and student's, moved);
    separate --dtype bfloat16 of the student on TS_SEP_UTTS mixtures (K3's
    forward once a layer each), card vs CPU. -> (launches of training, of
    separation)."""
    import torch

    from aps_tpu_torch.cmd import separate, train_ss
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.libs import aps_dataloader, aps_sse_nnet, aps_task
    from aps_tpu_torch.libs import aps_transform
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    beg = time.perf_counter()
    root.mkdir()
    wham = load_ss_conf(str(REPO / FREQ_XFMR_YAML))
    data = root / "data"
    data.mkdir()
    cfg = _write_simu_inputs(data, gen, TS_UTTS)
    # permute false: at random weights the two permutations of PIT lie
    # close, and a rounding can flip the choice (and the gradient with it)
    task_conf = {"teacher": str(teacher), "teacher_tag": "last",
                 "objf_name": "L2", "permute": False}
    loader = {"sr": WHAM_SR, "chunk_size": FREQ_XFMR_SECS * WHAM_SR}
    conf = dict(nnet="sse@freq_xfmr", nnet_conf=FREQ_XFMR_CONF,
                enh_transform=wham["enh_transform"], task="sse@ts",
                task_conf=task_conf, trainer_conf=wham["trainer_conf"],
                data_conf={"fmt": "se@simu_cmd", "loader": loader,
                           "train": {"simu_cfg": str(cfg)},
                           "valid": {"simu_cfg": str(cfg)}})
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    cpt = root / "cpt"
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_ss.main([
            "--conf", str(root / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", str(TS_UTTS), "--epochs", str(ZOO_TRAIN_EPOCHS),
            "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches_train = dict(build.LAUNCHES)
    valid = len(_epoch_losses(cpt / "trainer.log", "valid"))
    losses = _epoch_losses(cpt / "trainer.log", "train")
    layers = FREQ_XFMR_CONF["num_layers"]
    want = {k: 0 for k in build.LAUNCHES}
    want["flash_attention_rel"] = 2 * layers * (ZOO_TRAIN_EPOCHS + valid)
    want.update({f"flash_attention_rel_{k}": layers * ZOO_TRAIN_EPOCHS
                 for k in BACKWARD})
    if trainer.device.type != "cuda" or \
            trainer.cur_step != ZOO_TRAIN_EPOCHS or \
            launches_train != want or not all(map(math.isfinite, losses)):
        fail(f"train_ss (sse@ts): {trainer.cur_step} steps on "
             f"{trainer.device}, losses {losses}, launches {launches_train},"
             f" expected {want}")
    if any(p.requires_grad for p in trainer.task.teacher_nnet.parameters()):
        fail("sse@ts: the teacher takes gradients")
    del trainer
    egs = next(iter(aps_dataloader(fmt="se@simu_cmd", train=False,
                                   max_batch_size=TS_UTTS, simu_cfg=str(cfg),
                                   num_workers=0, **loader)))
    torch.manual_seed(SEED)
    student = aps_sse_nnet("sse@freq_xfmr")(
        enh_transform=aps_transform("enh")(**wham["enh_transform"]),
        **FREQ_XFMR_CONF)
    task = aps_task("sse@ts", student, **task_conf)
    weights = [k for k, p in student.named_parameters() if p.dim() >= 2]
    grads = tuple(weights[i] for i in sorted(
        {0, len(weights) // 2, len(weights) - 1}))
    loss_g, loss_c, errs = step_pass_check(task, egs, dev, grads, 2,
                                           referee=True, referee_on="cpu",
                                           witnesses={"stft64":
                                                      enh_transform_float64(
                                                          ("stft",))},
                                           stft_first=grads[0])
    tt = root / "tt"
    tt.mkdir()
    mixes = write_mixtures(tt, TS_SEP_UTTS, gen, WHAM_SR, FREQ_XFMR_SECS,
                           WHAM_NAMES)
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        stats = separate.main([str(tt / "mix.scp"), str(root / "sep"),
                               "--checkpoint", str(cpt), "--tag", "last",
                               "--sr", str(WHAM_SR), "--dtype", "bfloat16"])
    launches_sep = dict(build.LAUNCHES)
    want = {k: 0 for k in build.LAUNCHES}
    want["flash_attention_rel"] = layers * TS_SEP_UTTS
    if stats["utts"] != TS_SEP_UTTS or launches_sep != want:
        fail(f"separate --dtype bfloat16 (sse@ts student): "
             f"{stats['utts']} mixtures, launches {launches_sep}, expected "
             f"{want}")
    import numpy as np
    seps = {w: separate.Separator(str(cpt), cpt_tag="last", device=w,
                                  dtype="bfloat16") for w in ("cpu", "cuda")}
    f32 = separate.Separator(str(cpt), cpt_tag="last", device="cuda")
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: [s.run(mixes[k]) for k in sorted(mixes)]
                for w, s in seps.items()}
        plain = [f32.run(mixes[k]) for k in sorted(mixes)]
    got = np.concatenate([np.ravel(a) for a in _flat(outs["cuda"])])
    ref = np.concatenate([np.ravel(a) for a in _flat(outs["cpu"])])
    full = np.concatenate([np.ravel(a) for a in _flat(plain)])
    scale, err = float(np.abs(ref).max()), float(np.abs(got - ref).max())
    moved = float(np.abs(got - full).max())
    if not (scale > 0 and np.isfinite(got).all() and
            err <= TOL_SEP_REL * scale and moved > err):
        fail(f"sse@ts student, separate --dtype bfloat16 card vs CPU: max "
             f"abs err {err} (largest sample {scale}; bfloat16 against "
             f"float32 on the card {moved})")
    print(f"sse@ts: a student sse@freq_xfmr distilled from the freq_xfmr "
          f"phase's checkpoint on {TS_UTTS} se@simu_cmd mixtures of "
          f"{FREQ_XFMR_SECS} s (two speakers through a room response, a "
          f"point noise), {ZOO_TRAIN_EPOCHS} one-step epochs, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, launches "
          f"{launches_train}; its pass card vs CPU on 2 mixtures: loss "
          f"{loss_g:.6f} vs {loss_c:.6f}, gradients' distance (card, CPU, "
          "the card with the STFT in float64) from the CPU's float64 pass "
          "relative to the largest entry "
          + ", ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in e)
                      for k, e in errs.items())
          + f"; separate --dtype bfloat16 on {TS_SEP_UTTS}: launches "
          f"{launches_sep}, card vs CPU {err:.3e} (largest sample "
          f"{scale:.3f}), bfloat16 against float32 {moved:.3e}; the phase "
          f"took {time.perf_counter() - beg:.1f} s ({card})", flush=True)
    return launches_train, launches_sep


def mc_chunk_phase(root: Path, gen, dev, card):
    """Chunked separation of multi-channel input: sse@base_rnn (MC_CONF)
    behind chime4_ml 1a's enh transform (the log spectrogram and the
    cos-IPD of 4 pairs of its 5 channels), seeded weights; one 5-channel
    mixture of MC_SECS through `separate --chunk-len MC_CHUNK --chunk-hop
    MC_HOP` on the card (chunks of C x MC_CHUNK samples stitched on the
    sample axis), and Separator.run card vs CPU within TOL_SEP_REL of the
    largest sample. No kernel is on this path. -> launches."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import separate
    from aps_tpu_torch.conf import load_ss_conf
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.io import read_audio
    from aps_tpu_torch.libs import aps_sse_nnet, aps_transform
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision
    root.mkdir()
    enh = load_ss_conf(str(REPO / CHIME4_ML_YAML))["enh_transform"]
    torch.manual_seed(SEED)
    model = aps_sse_nnet("sse@base_rnn")(
        enh_transform=aps_transform("enh")(**enh), **MC_CONF)
    cpt = root / "cpt"
    cpt.mkdir()
    (cpt / "train.yaml").write_text(json.dumps(dict(
        nnet="sse@base_rnn", nnet_conf=MC_CONF, enh_transform=enh,
        task="sse@sisnr", task_conf={}, data_conf={}, trainer_conf={}),
        indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]}}, fd)
    mixes = write_multichannel(root, "mc", 1, gen, MC_SECS)
    key, mix = next(iter(mixes.items()))
    build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        separate.main([str(root / "wav.scp"), str(root / "sep"),
                       "--checkpoint", str(cpt), "--sr", str(SR),
                       "--chunk-len", str(MC_CHUNK), "--chunk-hop",
                       str(MC_HOP)])
    launches = dict(build.LAUNCHES)
    written = read_audio(str(root / "sep" / f"{key}.wav"), sr=SR)
    if any(launches.values()) or written.shape != (MC_SECS * SR,):
        fail(f"chunked separate of {mix.shape}: launches {launches}, wrote "
             f"{written.shape}")
    seps = {w: separate.Separator(str(cpt), device=w) for w in ("cpu", "cuda")}
    with matmul_precision(INFERENCE_PRECISION, dev):
        outs = {w: s.run(mix, chunk_len=MC_CHUNK, chunk_hop=MC_HOP)
                for w, s in seps.items()}
    scale = float(np.abs(outs["cpu"]).max())
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    if not (scale > 0 and np.isfinite(outs["cuda"]).all() and
            err <= TOL_SEP_REL * scale):
        fail(f"chunked separation card vs CPU: max abs err {err} (largest "
             f"sample {scale})")
    print(f"chunked separation of a {mix.shape[0]}-channel mixture of "
          f"{MC_SECS} s (sse@base_rnn, {MC_CONF['num_layers']} x "
          f"{MC_CONF['hidden']} BLSTM behind chime4_ml's IPD features): "
          f"chunks of {MC_CHUNK} samples every {MC_HOP}, card vs CPU "
          f"{err:.3e} (largest sample {scale:.3f}), no kernel launched "
          f"({card})", flush=True)
    return launches


def _wide_row(name, label, got, want, launch, plain_ms, bound, ops,
              **more):
    """A check row, failing past the kernel tolerance (TOL_ATT for the
    forward, TOL_GRAD (+ TOL_DPOSE_REL of the largest entry for dpose)
    for the gradients); launch() is timed alone and QUEUED_CALLS queued,
    and the queued time fails below the tensor cores' bound of the `ops`
    of its products (TF32/3), as the other K2 and K3 rows do. `more`
    joins the row's numbers."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    tol = TOL_ATT if name in ("flash_attention", "flash_attention_rel") \
        else TOL_GRAD + (TOL_DPOSE_REL * want[0].abs().max().item()
                         if name.endswith("dpose") else 0.0)
    if not err <= tol:
        fail(f"{name} [{label}]: max abs err {err} > {tol}")
    queued = time_ms(launch, calls=QUEUED_CALLS)
    tensor_ms = tensor_core_ms(ops)
    if not queued >= tensor_ms:
        fail(f"{name} [{label}]: {queued} ms queued reads below the tensor "
             f"cores' bound {tensor_ms}")
    return (label, err, time_ms(launch), plain_ms) + bound + (
        {"ms_queued": queued, "tensor_core_bound_ms": tensor_ms, **more},)


def wrapper_ms(fn, args, do, **kw) -> dict:
    """The wrapper fn (flash_attention or flash_attention_rel) timed as the
    model calls it (at a head of 96 K3's pads and slices included; K2
    launches such a head unpadded): the forward alone ("wrapper_ms") and
    the forward with the backward of every input ("wrapper_train_ms")."""
    import torch
    leaves = [a.clone().requires_grad_() for a in args]

    def train():
        torch.autograd.grad(fn(*leaves, **kw), leaves, do)
    with torch.no_grad():
        forward = time_ms(lambda: fn(*args, **kw))
    return {"wrapper_ms": forward,
            "wrapper_train_ms": time_ms(train, iters=10, warmup=2)}


def _padded(tensors, width=128):
    """The tensors zero-padded on their last (head) axis to width, as
    flash_attention_rel pads a head its kernels are not built for."""
    import torch
    return [torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def wide_head_phase(dev, gen, card, egs):
    """K2's and K3's kernels at heads of 96 (K2 unpadded in its ragged
    tiles of 96, K3 zero-padded to 128 by its wrapper) and 128: at the steps'
    shapes (WIDE_REL_CASES, WIDE_ABS_CASES) and the one-key corner, forward
    and every backward kernel through the autograd Functions twice for
    bit-equal results and against the plain versions; each kernel also
    launched alone on what its wrapper launches (K3 at 96: the operands
    padded to 128) and timed, alone and queued, beside its plain version at
    the true width, its bound and the tensor cores' bound (_wide_row); each
    forward also through its wrapper, alone and with the backward (K3's
    pads and slices included at 96), K2's at 96 beside its launch at 128;
    K2's forward at 128 beside the library's call, and the library's
    forward with the backward of q, k and v (K2's dbias at every width:
    check_dbias). Then one training pass of the flagship cut to 2
    conformer layers of width 512 with 4 heads (head dim 128) card vs CPU
    on WIDE_PASS_UTTS of the training batch, K3 at 128 counted. -> (rows by kernel, launches of the
    pass on the card, numbers)."""
    import torch

    from aps_tpu_torch.flagship import (build_flagship, flagship_train_conf,
                                        init_weights)
    from aps_tpu_torch.libs import aps_task
    from aps_tpu_torch.ops import attention as k2
    from aps_tpu_torch.ops import rel_attention as k3
    beg = time.perf_counter()
    rows = {name: [] for name in KERNELS if name.startswith(
        "flash_attention")}
    more = {}
    k2_step = {}  # D -> K2's forward row at the step's shape
    for D in WIDE_HEADS:
        scale = D**-0.5
        for B, H, T, lens, causal, Hp, role in WIDE_REL_CASES:
            args = [torch.randn((B, H, T, D), generator=gen).to(dev)
                    for _ in range(4)]
            args.append((0.3 * torch.randn((Hp, 2 * T - 1, D),
                                           generator=gen)).to(dev))
            klen = torch.tensor(lens, dtype=torch.int32, device=dev)
            do = torch.randn((B, H, T, D), generator=gen).to(dev)
            label = (f"B={B} H={H} D={D} T={T} Hp={Hp} causal={causal} "
                     f"k_len={lens[0] if role == 'step' else '1, 2 and T'}"
                     + ("" if D == 128 else " zero-padded to 128"))
            runs = []
            for _ in range(2):
                leaves = [a.clone().requires_grad_() for a in args]
                out = k3.flash_attention_rel(*leaves, k_len=klen,
                                             causal=causal)
                runs.append([out.detach()] + list(
                    torch.autograd.grad(out, leaves, do)))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"flash_attention_rel [{label}]: two runs differ")
            want_out = k3.rel_mha_reference(*args, k_len=klen, causal=causal)
            want = k3.rel_mha_backward_reference(*args, do, k_len=klen,
                                                 causal=causal)
            padded = _padded(args)
            out_p, lse = k3.launch_forward(*padded, klen, causal, True,
                                           scale)
            bwd = (*padded, klen, *_padded([do]), lse, out_p,
                   torch.empty_like(lse), causal, scale)
            k3.launch_backward_kernel("dq", *bwd)  # forms delta
            plain_ms = time_ms(lambda: k3.rel_mha_reference(
                *args, k_len=klen, causal=causal))
            bwd_plain = time_ms(lambda: k3.rel_mha_backward_reference(
                *args, do, k_len=klen, causal=causal), iters=5, warmup=1)
            flops = 2 * D * H * valid_pairs(T, lens, causal)
            size, table = B * H * T * D, Hp * (2 * T - 1) * D
            rows["flash_attention_rel"].append(_wide_row(
                "flash_attention_rel", label + " with lse", runs[0][:1],
                [want_out], lambda: k3.launch_forward(
                    *padded, klen, causal, True, scale), plain_ms,
                bound_ms(4 * (5 * size + B * H * T + table + B), 3 * flops),
                3 * flops, **wrapper_ms(k3.flash_attention_rel, args, do,
                                        k_len=klen, causal=causal)))
            reads = 4 * (5 * size + table + 2 * B * H * T + B)
            for kernel, idx, ops, written in (
                    ("dq", (0, 1), 5 * flops, 8 * size),
                    ("dkv", (2, 3), 5 * flops, 8 * size),
                    ("dpose", (4,), 4 * flops, 4 * table)):
                rows[f"flash_attention_rel_{kernel}"].append(_wide_row(
                    f"flash_attention_rel_{kernel}", label,
                    [runs[0][1 + i] for i in idx], [want[i] for i in idx],
                    lambda: k3.launch_backward_kernel(kernel, *bwd),
                    bwd_plain, bound_ms(reads + written, ops), ops))
        for B, H, T, lens, causal, role in WIDE_ABS_CASES:
            q, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                           for _ in range(4))
            klen = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = (f"B={B} H={H} D={D} T={T} causal={causal} "
                     f"k_len={lens[0] if role == 'step' else '1, 2 and T'}"
                     + ("" if D == 128 else " unpadded"))
            runs = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out = k2.flash_attention(*leaves, k_len=klen, causal=causal)
                runs.append([out.detach()] + list(
                    torch.autograd.grad(out, leaves, do)))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"flash_attention [{label}]: two runs differ")
            want_out = k2.mha_reference(q, k, v, k_len=klen, causal=causal)
            want = k2.mha_backward_reference(q, k, v, do, k_len=klen,
                                             causal=causal)
            out_w, lse = k2.launch_forward(q, k, v, None, klen, scale,
                                           causal, True)
            bwd = (q, k, v, None, klen, do, lse, out_w,
                   torch.empty_like(lse), scale, causal)
            k2.launch_backward_kernel("dq", *bwd)  # forms delta
            plain_ms = time_ms(lambda: k2.mha_reference(
                q, k, v, k_len=klen, causal=causal))
            bwd_plain = time_ms(lambda: k2.mha_backward_reference(
                q, k, v, do, k_len=klen, causal=causal), iters=5, warmup=1)
            if D == 128 and role == "step":
                more["library_ms_D128"] = time_ms(
                    lambda: _sdpa(q, k, v, klen))
                more["library_train_ms_D128"] = _sdpa_train_ms(q, k, v,
                                                               klen, do)
            flops = 2 * D * H * valid_pairs(T, lens, causal)
            size = B * H * T * D
            rows["flash_attention"].append(_wide_row(
                "flash_attention", label, runs[0][:1], [want_out],
                lambda: k2.launch_forward(q, k, v, None, klen, scale,
                                          causal, False),
                plain_ms, bound_ms(4 * (4 * size + B), 2 * flops),
                2 * flops, **wrapper_ms(k2.flash_attention, (q, k, v), do,
                                        k_len=klen, causal=causal)))
            if role == "step":
                k2_step[D] = rows["flash_attention"][-1]
            for kernel, idx, ops in (("dq", (0,), 3 * flops),
                                     ("dkv", (1, 2), 4 * flops)):
                rows[f"flash_attention_{kernel}"].append(_wide_row(
                    f"flash_attention_{kernel}", label,
                    [runs[0][1 + i] for i in idx], [want[i] for i in idx],
                    lambda: k2.launch_backward_kernel(kernel, *bwd),
                    bwd_plain,
                    bound_ms(4 * (4 * size + 2 * B * H * T + B) +
                             4 * len(idx) * size, ops), ops))
    # K2's forward at 96 through the wrapper (unpadded) against its launch
    # at 128, the same B and T
    w96, l128 = k2_step[96][6]["wrapper_ms"], k2_step[128][2]
    k2_step[96][6]["wrapper_over_D128_launch"] = w96 / l128
    more["k2_wrapper_96_over_128"] = w96 / l128
    print(f"K2's forward at D = 96 unpadded through flash_attention "
          f"[{k2_step[96][0]}]: {w96:.4f} ms, {w96 / l128:.3f}x the launch "
          f"at D = 128 ({l128:.4f} ms) ({card})", flush=True)
    # the training pass of a 512-wide conformer of 4 heads
    conf = flagship_train_conf(VOCAB)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["num_layers"] = 2
    nnet_conf["enc_kwargs"]["arch_kwargs"].update(WIDE_CONF, ffn_dropout=0.0)
    nnet_conf["dec_kwargs"]["num_layers"] = 1
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(WIDE_CONF, att_dropout=0.0,
                                                  ffn_dropout=0.0)
    model = build_flagship(conf)
    init_weights(model, gen)
    task = aps_task(conf["task"], model, blank=VOCAB - 1,
                    **conf["task_conf"])
    launched = {}
    loss_g, loss_c, errs = step_pass_check(
        task, egs, dev, STEP_GRADS["flagship"], WIDE_PASS_UTTS,
        referee=False, launched=launched)
    want = {"fused_logmel": 1, "flash_attention_rel": 2,
            **{f"flash_attention_rel_{k}": 2 for k in BACKWARD}}
    if launched["card32"] != want:
        fail(f"the 512-wide conformer's pass launched {launched['card32']},"
             f" expected {want}")
    more["pass"] = {"loss": (loss_g, loss_c), "errs": errs}
    print(f"wide heads: K2 and K3 at D = {WIDE_HEADS} (96: K2 unpadded in "
          "its ragged tiles of 96, K3 zero-padded to 128) at the steps' "
          "shapes and the one-key corner, twice each "
          "for bit-equal results; a training pass of the flagship cut to 2 "
          f"conformer layers of width 512 with 4 heads card vs CPU on "
          f"{WIDE_PASS_UTTS} utterances: loss {loss_g:.6f} vs {loss_c:.6f}, "
          "gradients relative to the largest entry "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f", launches {launched['card32']}; the library's forward at "
          f"D = 128: {more['library_ms_D128']:.4f} ms, its forward and the "
          f"backward of q, k, v: {more['library_train_ms_D128']:.4f} ms; "
          f"the phase took {time.perf_counter() - beg:.1f} s ({card})",
          flush=True)
    return rows, launched["card32"], more


# the last of the JAX package: CTC forced alignment (cmd.align on asr@ctc
# with the flagship's encoder), the feature grammar (compute_gmvn, a global
# CMVN, mfcc with splice, a learnable filterbank), the trainer's options
# (weight noise, profile, tensorboard) and K2 / K3 at heads over 128 (the
# wide kernels of csrc/wide_attention.cu)
ALIGN_UTTS = 8
ALIGN_LABELS = 24  # tokens a transcript of 8 s
# card vs CPU: the log-probabilities of an alignment's lattice (the
# encoder's float32 output through log-softmax); a score sums T of them
TOL_ALIGN_LOGP = 1e-3
TOL_GMVN = 1e-4  # relative, card vs CPU statistics
FEATURE_PASS_UTTS = 4  # of the training batch, in each card-vs-CPU pass
FEATURE_PASSES = {
    # name -> (asr_transform changes, nnet input size, the learnable
    # filterbank's gradient held by filterbank_check, float64 referee on
    # the CPU). The mfcc pass's first layers lay 1.4e-3 to 1.5e-3 of their
    # largest entry from the CPU's on one batch (an NVIDIA H100 80GB HBM3
    # against its host; PERF.md section 6), near TOL_STEP_GRAD: the float64
    # pass tells the float32 rounding of both devices apart, as for the
    # long-form model's pass
    "gcmvn": (dict(feats="fbank-log-cmvn"), 80, None, False),
    "mfcc": (dict(feats="perturb-mfcc-cmvn-splice", subsampling_factor=1),
             39, None, True),
    "learnable fbank": (dict(feats="fbank-log-cmvn", requires_grad=True,
                             center=True), 80,
                        "asr_transform.layers_4.filters", False),
}
OPTS_UTTS = 10  # the trainer options' corpus: one batch of 10 x 8 s (the
# loader's floor)
OPTS_EPOCHS = 4  # one step each
OPTS_NOISE = dict(weight_noise_std=0.01, weight_noise_cfg=[1, 2, -1])
OPTS_PROFILE_STEPS = [1, 3]
K3_KERNEL_NAMES = ("rel_attn_fwd_kernel", "rel_attn_dq_kernel",
                   "rel_attn_dkv_kernel", "rel_attn_dpose_kernel")
# heads over 128 (the wide kernels): 160 and 256 at the steps' shapes and
# the one-key corner, 1100 (five passes of 256 columns) at a smaller one
WIDE_OVER = (160, 256, 1100)
WIDE_OVER_SMALL = ((4, 2, 129, [129, 70, 1, 0], False, 2, "ragged"),)
WIDE_OVER_ABS_SMALL = ((4, 2, 129, [129, 70, 1, 0], True, "ragged"),)
TOL_WIDE = 1e-3  # of the largest entry of the plain version's result


def align_conf() -> dict:
    """asr@ctc with the flagship's encoder at full width (conv2d
    subsampling, 12 conformer layers of 256 with 4 heads, rel pose) and
    its fbank-log-cmvn transform."""
    from aps_tpu_torch.flagship import flagship_conf
    conf = flagship_conf(VOCAB, small=False)
    nnet_conf = {k: conf["nnet_conf"][k] for k in (
        "input_size", "vocab_size", "enc_type", "enc_kwargs")}
    return {"nnet": "asr@ctc", "nnet_conf": nnet_conf,
            "asr_transform": conf["asr_transform"], "task": "asr@ctc",
            "task_conf": {"blank": VOCAB - 1}, "data_conf": {},
            "trainer_conf": {}}


def viterbi_margins(logits, seq, blank: int):
    """For CtcApi.viterbi_align's path over T x V logits: the gap between
    the chosen and the next candidate at each cell of the path (and at the
    choice of the final state), in float64 as the alignment sums; and the
    log-probabilities of the path's lattice (the blank and the labels),
    T x (U + 1)."""
    import numpy as np
    import torch
    logp = torch.log_softmax(torch.as_tensor(logits).float(), -1).numpy()
    ext = [blank]
    for s in seq:
        ext += [s, blank]
    T, L = logp.shape[0], len(ext)
    score = np.full((T, L), -np.inf)
    gap = np.full((T, L), np.inf)
    back = np.zeros((T, L), dtype=np.int64)
    score[0, 0] = logp[0, ext[0]]
    if L > 1:
        score[0, 1] = logp[0, ext[1]]
    for t in range(1, T):
        for l in range(L):
            cands = [score[t - 1, l]]
            if l > 0:
                cands.append(score[t - 1, l - 1])
            if l > 1 and ext[l] != blank and ext[l] != ext[l - 2]:
                cands.append(score[t - 1, l - 2])
            order = np.argsort(cands)[::-1]
            best = int(np.argmax(cands))
            score[t, l] = cands[best] + logp[t, ext[l]]
            back[t, l] = l - best
            if len(cands) > 1 and np.isfinite(cands[order[1]]):
                gap[t, l] = cands[order[0]] - cands[order[1]]
    ends = [L - 1, L - 2] if L > 1 else [0]
    end = max(ends, key=lambda l: score[T - 1, l])
    gaps = [abs(score[T - 1, L - 1] - score[T - 1, L - 2])] if L > 1 else []
    l = end
    for t in range(T - 1, -1, -1):
        gaps.append(gap[t, l])
        l = back[t, l]
    return gaps, logp[:, sorted(set(ext))].astype(np.float64)


def kernel_names(prof):
    """The device kernels a profiler trace names (by its events and by its
    averages: a kernel launched through ctypes has no PyTorch operator
    around it)."""
    import torch

    from aps_tpu_torch.cmd.profile_decode import on_device
    return {evt.name for evt in prof.events() if on_device(evt)} | {
        evt.key for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA}


def traced_kernel_names(fn):
    """The device kernels a trace of one call of fn() names."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_names(prof)


def align_phase(root: Path, gen, dev, card):
    """cmd.align on the card over ALIGN_UTTS utterances of 8 s and their
    transcripts with asr@ctc at the flagship encoder's full width (seeded
    weights, the output layer scaled up): K1 and K3's forward launched (by
    the counts and by name in a trace of the run), held against their
    plain versions at the path's operands. Card vs CPU (cmd.align --device
    cpu), each utterance: the log-probabilities of the path's lattice
    within TOL_ALIGN_LOGP (delta, their largest difference); the score, a
    sum over the T frames, within T * delta (no path's sum moves more);
    the alignment equal, but where a choice on either device's path lies
    within 2 T delta of the next candidate (viterbi_margins), so that the
    devices' logits may order it either way: such utterances are counted
    and printed, never passed silently. -> (launches of the run, rows by
    kernel)."""
    import torch

    from aps_tpu_torch.cmd import align
    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.flagship import build_flagship, init_weights
    from aps_tpu_torch.loader.utils import quantize_len
    from aps_tpu_torch.ops import build
    beg = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    conf = align_conf()
    model = build_flagship(conf)
    init_weights(model, gen)
    with torch.no_grad():
        model.encoder.outp.weight.mul_(8.0)
    cpt = root / "cpt"
    cpt.mkdir()
    (cpt / "train.yaml").write_text(json.dumps(conf, indent=2))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "epoch": 0}, fd)
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, VOCAB - 1):
            fd.write(f"t{i} {i}\n")
    wavs = write_wavs(root, "ali", ALIGN_UTTS, gen)
    labels = torch.randint(1, VOCAB - 1, (ALIGN_UTTS, ALIGN_LABELS),
                           generator=gen).tolist()
    with open(root / "text", "w") as fd:
        for key, toks in zip(sorted(wavs), labels):
            fd.write(f"{key} {' '.join(f't{i}' for i in toks)}\n")
    logits = {"cpu": [], "cuda": []}

    class Recorded(align.CtcApi):
        def viterbi_align(self, ctc_enc, dec_seq):
            logits[side].append((ctc_enc.float().cpu(), list(dec_seq)))
            return super(Recorded, self).viterbi_align(ctc_enc, dec_seq)

    def run(side: str, out: str):
        # the command prints its arguments: to stderr, so that every "{"
        # line of this script's stdout is one of its own
        with contextlib.redirect_stdout(sys.stderr):
            return align.main([str(root / "wav.scp"), str(root / "text"),
                               str(root / out), "--am", str(cpt), "--dict",
                               str(root / "dict"), "--device", side])

    outs = {}
    real = align.CtcApi
    align.CtcApi = Recorded
    try:
        side = "cpu"
        outs[side] = run(side, "ali.cpu")
        side = "cuda"
        build.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs[side] = run(side, "ali.cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        launches = dict(build.LAUNCHES)
    finally:
        align.CtcApi = real
    want = {k: 0 for k in build.LAUNCHES}
    want.update(fused_logmel=ALIGN_UTTS,
                flash_attention_rel=ENC_LAYERS * ALIGN_UTTS)
    if launches != want:
        fail(f"align launched {launches}, expected {want}")
    lines = (root / "ali.cuda").read_text().splitlines()
    if len(lines) != ALIGN_UTTS or sorted(ln.split()[0] for ln in lines) \
            != sorted(wavs):
        fail(f"align wrote {len(lines)} lines for {ALIGN_UTTS} utterances")
    ties, checked = [], []
    for n, key in enumerate(sorted(wavs)):
        cpu, gpu = outs["cpu"][key], outs["cuda"][key]
        T_utt = len(cpu["align"])
        if not (math.isfinite(gpu["score"]) and len(gpu["align"]) == T_utt):
            fail(f"align {key}: card {gpu['score']}, "
                 f"{len(gpu['align'])} frames vs CPU {T_utt}")
        gaps_c, logp_c = viterbi_margins(*logits["cpu"][n], VOCAB - 1)
        gaps_g, logp_g = viterbi_margins(*logits["cuda"][n], VOCAB - 1)
        delta = float(abs(logp_g - logp_c).max())
        if not delta <= TOL_ALIGN_LOGP:
            fail(f"align {key}: the card's log-probabilities of the path's "
                 f"lattice lie {delta} from the CPU's, over "
                 f"{TOL_ALIGN_LOGP}")
        err = abs(gpu["score"] - cpu["score"])
        if not err <= T_utt * delta + 1e-9 * abs(cpu["score"]):
            fail(f"align {key}: score {gpu['score']} vs {cpu['score']}, "
                 f"more apart than {T_utt} frames x {delta}")
        checked.append((err, delta, T_utt))
        if gpu["align"] != cpu["align"]:
            near = sum(g <= 2 * T_utt * delta for g in gaps_c + gaps_g)
            if not near:
                fail(f"align {key}: the card's alignment differs from the "
                     f"CPU's with no choice on either path within "
                     f"{2 * T_utt * delta} of the next candidate")
            ties.append((key, near, min(gaps_c + gaps_g)))
    # the path's operands: one utterance padded onto the length grid, its
    # encoder frames
    S = quantize_len(UTT_SECS * SR, floor=16000)
    frames = model.asr_transform._num_frames(
        torch.tensor([S, UTT_SECS * SR]))
    T, k_len = model.encoder.num_frames(frames).tolist()
    key0 = sorted(wavs)[0]
    wav = torch.zeros((1, S))
    wav[0, :len(wavs[key0])] = torch.from_numpy(wavs[key0])
    rows = {"fused_logmel": check_fbank(dev, model, (("align", wav),))[0],
            "flash_attention_rel": check_rel_attention(
                dev, gen, cases=((T, 1, False, [k_len], "align"),))[0]}
    # by name: a trace of one more run on the card
    seen = traced_kernel_names(lambda: run("cuda", "ali.trace"))
    for kernel in ("fbank_fft_kernel", "rel_attn_fwd_kernel"):
        if not any(kernel in s for s in seen):
            fail(f"align: the trace shows no {kernel} among its "
                 f"{len(seen)} device kernels: {sorted(n[:40] for n in seen)}")
    print(f"align: asr@ctc at the flagship encoder's width, {ALIGN_UTTS} x "
          f"{UTT_SECS} s (S = {S} padded, T = {T}, {k_len} valid) with "
          f"transcripts of {ALIGN_LABELS} tokens through cmd.align on the "
          f"card in {secs:.3f} s, launches {launches}; card vs CPU: "
          f"lattice log-probabilities within "
          f"{max(d for _, d, _ in checked):.3e}, scores within "
          f"{max(e for e, _, _ in checked):.3e} (bound T x delta, T = "
          f"{checked[0][2]}), {ALIGN_UTTS - len(ties)} alignments equal, "
          f"{len(ties)} apart at near-ties (key, choices within 2 T delta, "
          f"the closest gap) {ties}; the trace names fbank_fft_kernel and "
          f"rel_attn_fwd_kernel; the phase took "
          f"{time.perf_counter() - beg:.1f} s ({card})", flush=True)
    return launches, rows


def perturb_float64(task) -> None:
    """A witness: the speed perturbation's resampling (a conv1d on the
    card's cuDNN) in float64, the rest of the pass as it was."""
    layer = task.nnet.asr_transform.perturb
    real = layer.forward
    layer.forward = lambda wav, choice: real(wav.double(), choice).float()


def filterbank_check(task, egs, dev, leaf: str, utts: int):
    """The learnable filterbank's gradient, sum over the frames of
    dL/dlog-mel / mel times the magnitude spectrum: a frame whose bin the
    window and pre-emphasis nearly cancel has a mel energy that float32
    rounding of the STFT moves by a large share, and 1 / mel carries it
    into the sum. Both float32 devices round the frames' elementwise steps
    alike, so they agree with each other and lie 0.2 of the largest entry
    from a float64 pass (an NVIDIA H100 80GB HBM3 and its host; PERF.md
    section 6). Held as a first layer on an enh transform's STFT is held
    (stft32_of): the card's float32 pass within TOL_STEP_GRAD of a float64
    pass that reads the card's own float32 spectrum (each frame within
    Higham's bound on the float64 one, stft_rounding), both on the card
    with the attention dense for the float64 copy (the kernels take
    float32). -> (that distance, the plain float64 pass's distance, the
    frames' largest share of the bound)."""
    import torch

    from aps_tpu_torch.trainer.dp import to_device
    tensors = {k: v[:utts] for k, v in egs.items() if not k.startswith("#")}
    ratios = []

    def stft32(side) -> None:
        tf = side.nnet.asr_transform
        layer = tf._layers[tf.spectra_index]
        real = layer.forward

        def forward(wav):
            x64 = real(wav)
            x32 = real(wav.float()).to(x64.dtype)
            ratios.append(stft_rounding(x32, x64))
            return x32
        layer.forward = forward

    grads = {}
    for name, dtype, patch in (("card32", torch.float32, None),
                               ("card64", torch.float64, None),
                               ("stft32_64", torch.float64, stft32)):
        side = copy.deepcopy(task).to(dev, dtype).train()
        if dtype == torch.float64:
            dense_attention(side)
        if patch is not None:
            patch(side)
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in to_device(tensors, dev).items()}
        side(batch)["loss"].backward()
        grads[name] = dict(side.nnet.named_parameters())[leaf].grad.double()
    scale = grads["stft32_64"].abs().max().item()
    err = (grads["card32"] - grads["stft32_64"]).abs().max().item() / scale
    share = (grads["card32"] - grads["card64"]).abs().max().item() / \
        grads["card64"].abs().max().item()
    if not (scale > 0 and err <= TOL_STEP_GRAD):
        fail(f"gradient of {leaf}: the card's float32 pass is {err} of the "
             "largest entry from the float64 pass on its own float32 "
             f"spectrum, over {TOL_STEP_GRAD}")
    return err, share, max(ratios)


def feature_conf(change: dict, input_size: int, gcmvn: str = "") -> dict:
    """The flagship's training config at full width with every dropout
    off, its asr_transform changed and the encoder's input size set."""
    from aps_tpu_torch.flagship import flagship_train_conf
    conf = flagship_train_conf(VOCAB)
    conf["asr_transform"] = dict(conf["asr_transform"], **change)
    if gcmvn:
        conf["asr_transform"]["gcmvn"] = gcmvn
    nnet_conf = conf["nnet_conf"]
    nnet_conf["input_size"] = input_size
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    return conf


def features_phase(root: Path, train: Path, egs, gen, dev, card):
    """compute_gmvn over the training corpus (fbank-log, K1 once an
    utterance) on the card and on the CPU, the statistics within TOL_GMVN
    relative; then one training pass of the flagship at full width card vs
    CPU (step_pass_check, the training bounds of PERF.md section 2) on
    FEATURE_PASS_UTTS utterances for each of FEATURE_PASSES: gcmvn from
    that file, perturb-mfcc-cmvn-splice (the speed perturbation's branch
    fixed to 0.9 on both sides; a witness with the resampling in float64)
    by the float64 referee's rule, and a learnable, centred filterbank
    (its own gradient held by filterbank_check). -> (launches of
    compute_gmvn on the card, of each pass on the card)."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import compute_gmvn
    from aps_tpu_torch.flagship import build_flagship, init_weights
    from aps_tpu_torch.libs import aps_task
    from aps_tpu_torch.ops import build
    beg = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    stats = {}
    for side in ("cpu", "cuda"):
        argv = [str(train / "wav.scp"), str(root / f"gmvn.{side}.npy"),
                "--conf", str(train / "train.yaml"), "--device", side]
        build.reset_launches()
        start = time.perf_counter()
        stats[side] = compute_gmvn.main(argv)
        took = time.perf_counter() - start
        if side == "cuda":
            gmvn_launches, gmvn_secs = dict(build.LAUNCHES), took
    utts = len((train / "wav.scp").read_text().splitlines())
    if gmvn_launches["fused_logmel"] != utts or \
            sum(gmvn_launches.values()) != utts:
        fail(f"compute_gmvn launched {gmvn_launches} over {utts} utterances")
    cpu, gpu = stats["cpu"], stats["cuda"]
    gmvn_err = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if not (gpu.shape == (2, 80) and np.isfinite(gpu).all()
            and gmvn_err <= TOL_GMVN):
        fail(f"compute_gmvn: the card's statistics are {gmvn_err} of the "
             f"largest entry from the CPU's, over {TOL_GMVN}")
    passes = {}
    for name, (change, input_size, extra, referee) in \
            FEATURE_PASSES.items():
        conf = feature_conf(change, input_size,
                            str(root / "gmvn.cuda.npy")
                            if name == "gcmvn" else "")
        model = build_flagship(conf)
        # seeded weights, the filterbank kept where it is learnable
        front = {k: p.detach().clone()
                 for k, p in model.asr_transform.named_parameters()}
        init_weights(model, gen)
        tf = model.asr_transform
        with torch.no_grad():
            for k, p in tf.named_parameters():
                p.copy_(front[k])
        if tf.perturb is not None:
            tf.perturb.draw = lambda generator: 0
        task = aps_task(conf["task"], model, blank=VOCAB - 1,
                        **conf["task_conf"])
        grads = STEP_GRADS["flagship"]
        launched = {}
        loss_g, loss_c, errs = step_pass_check(
            task, egs, dev, grads, FEATURE_PASS_UTTS, referee=referee,
            referee_on="cpu", launched=launched,
            witnesses={"perturb64": perturb_float64}
            if tf.perturb is not None else None)
        fused = tf.fused is not None
        want = {"fused_logmel": int(fused),
                "flash_attention_rel": ENC_LAYERS,
                **{f"flash_attention_rel_{k}": ENC_LAYERS for k in BACKWARD}}
        if launched["card32"] != {k: v for k, v in want.items() if v}:
            fail(f"the {name} pass launched {launched['card32']}, expected "
                 f"{want}")
        passes[name] = launched["card32"]
        held = ""
        if extra:
            err, share, ratio = filterbank_check(task, egs, dev, extra,
                                                 FEATURE_PASS_UTTS)
            held = (f"; {extra}: the card's float32 pass {err:.3e} of the "
                    "largest entry from the float64 pass on its own float32 "
                    f"spectrum (frames at {ratio:.3e} of Higham's bound), "
                    f"{share:.3e} from the plain float64 pass")
        print(f"features [{name}]: {conf['asr_transform']['feats']} "
              f"({'K1' if fused else 'layered, no K1'}), feats dim "
              f"{tf.dim()}; training pass card vs CPU on {FEATURE_PASS_UTTS} "
              f"utterances: loss {loss_g:.6f} vs {loss_c:.6f}, gradients "
              "relative to the largest entry "
              + ("(card, CPU" + (", the card with the perturbation in "
                                  "float64" if tf.perturb is not None else "")
                 + " from the CPU's float64 pass) " if referee
                 else "") + ", ".join(
                  f"{k} " + (", ".join(f"{e:.3e}" for e in v) if referee
                             else f"{v:.3e}") for k, v in errs.items())
              + f", launches {launched['card32']}{held}", flush=True)
    print(f"features: compute_gmvn over {utts} x {UTT_SECS} s on the card "
          f"in {gmvn_secs:.3f} s (K1 {gmvn_launches['fused_logmel']} "
          f"launches), card vs CPU {gmvn_err:.3e} of the largest entry; the "
          f"phase took {time.perf_counter() - beg:.1f} s ({card})",
          flush=True)
    return gmvn_launches, passes


def trainer_opts_phase(root: Path, gen, dev, card):
    """A train_am run of OPTS_EPOCHS one-step epochs of the flagship at full
    width on OPTS_UTTS utterances with weight noise (OPTS_NOISE), profile
    over steps OPTS_PROFILE_STEPS and tensorboard on: the noise lands on
    the schedule's steps, its draws (recorded on the card) have mean 0 and
    standard deviation 1 by their statistics, read on the card; the one
    Chrome trace names K3's four kernels; tensorboard wrote its events
    file, or warned where the package is missing. -> launches of the
    run."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    beg = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    train = write_corpus(root, gen, utts=OPTS_UTTS)
    conf = json.loads((train / "train.yaml").read_text())
    prof = root / "profile"
    conf["trainer_conf"].update(OPTS_NOISE, tensorboard=True,
                                profile=str(prof),
                                profile_steps=OPTS_PROFILE_STEPS)
    (train / "train.yaml").write_text(json.dumps(conf, indent=2))
    noised = []
    real = DataParallelTrainer.draw_weight_noise

    def recorded(self):
        draws = real(self)
        flat = torch.cat([d.reshape(-1) for d in draws])
        noised.append((self.cur_step, flat.device.type, flat.numel(),
                       flat.mean().item(), flat.std().item()))
        return draws

    cpt = root / "cpt"
    argv = ["--conf", str(train / "train.yaml"), "--dict",
            str(root / "dict"), "--checkpoint", str(cpt), "--batch-size",
            str(OPTS_UTTS), "--epochs", str(OPTS_EPOCHS), "--seed",
            str(SEED)]
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, VOCAB - 3):
            fd.write(f"t{i} {i}\n")
        fd.write(f"<sos> {VOCAB - 3}\n<eos> {VOCAB - 2}\n")
    DataParallelTrainer.draw_weight_noise = recorded
    build.reset_launches()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(sys.stderr):
            warnings.simplefilter("always")
            trainer = train_am.main(argv)
        torch.cuda.synchronize()
    finally:
        DataParallelTrainer.draw_weight_noise = real
    launches = dict(build.LAUNCHES)
    want = step_launches("flagship", 2 * OPTS_EPOCHS + 1, OPTS_EPOCHS)
    if trainer.device.type != "cuda" or launches != want:
        fail(f"train_am with the options launched {launches} on "
             f"{trainer.device}, expected {want}")
    beg_n, every, end_n = OPTS_NOISE["weight_noise_cfg"]
    steps = [s for s in range(OPTS_EPOCHS) if s >= beg_n and
             (end_n <= 0 or s <= end_n) and (s - beg_n) % every == 0]
    if [n[0] for n in noised] != steps:
        fail(f"weight noise on steps {[n[0] for n in noised]}, expected "
             f"{steps}")
    for step, where, n, mean, std in noised:
        if where != "cuda" or not (abs(mean) < 5 / n**0.5 and
                                   abs(std - 1) < 5 / (2 * n)**0.5):
            fail(f"weight noise of step {step} on {where}: {n} draws of "
                 f"mean {mean} and standard deviation {std}")
    traces = sorted(prof.glob("trace.*.json"))
    if [p.name for p in traces] != ["trace.{}-{}.json".format(
            *OPTS_PROFILE_STEPS)]:
        fail(f"profile wrote {[p.name for p in traces]}")
    names = {evt.get("name", "") for evt in json.loads(
        traces[0].read_text())["traceEvents"]
        if evt.get("cat") == "kernel"}
    missing = [k for k in K3_KERNEL_NAMES if not any(k in n for n in names)]
    if missing:
        fail(f"the profile's trace names no {missing} among its "
             f"{len(names)} kernels")
    log = (cpt / "trainer.log").read_text()
    if f"Profiler: tracing steps [{OPTS_PROFILE_STEPS[0]}, " \
            f"{OPTS_PROFILE_STEPS[1]})" not in log or \
            "Profiler: trace saved to" not in log:
        fail("trainer.log lacks the profiler's two lines")
    events = sorted(cpt.glob("events.out.tfevents.*"))
    board = [str(w.message) for w in caught
             if "tensorboard not installed" in str(w.message)]
    if not events and not board:
        fail("tensorboard: true wrote no events file and gave no warning")
    print(f"trainer options: train_am of the flagship, {OPTS_EPOCHS} "
          f"one-step epochs of {OPTS_UTTS} x {UTT_SECS} s, launches "
          f"{launches}; weight noise {OPTS_NOISE}: steps "
          f"{[n[0] for n in noised]}, draws (count, mean, std on the card) "
          + ", ".join(f"{n} {m:.3e} {s:.6f}" for _, _, n, m, s in noised)
          + f"; profile: {traces[0].name} names {list(K3_KERNEL_NAMES)} "
          f"among {len(names)} kernels; tensorboard: "
          + (f"{len(events)} events file(s)" if events else
             "the package is missing (warned, disabled)")
          + f"; the phase took {time.perf_counter() - beg:.1f} s ({card})",
          flush=True)
    return launches


def _over_row(name, label, got, want, launch, plain_ms, bound, ops,
              **more):
    """A check row of a wide kernel: within TOL_WIDE of the largest entry
    of the plain version's result; launch() timed alone and QUEUED_CALLS
    queued (5 samples each: these kernels take milliseconds), the queued
    time not below the tensor cores' bound of its products."""
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not err <= TOL_WIDE * scale:
        fail(f"{name} [{label}]: max abs err {err} > {TOL_WIDE} of the "
             f"largest entry {scale}")
    queued = time_ms(launch, iters=5, warmup=1, calls=QUEUED_CALLS)
    tensor_ms = tensor_core_ms(ops)
    if not queued >= tensor_ms:
        fail(f"{name} [{label}]: {queued} ms queued reads below the tensor "
             f"cores' bound {tensor_ms}")
    return (label, err, time_ms(launch, iters=5, warmup=1), plain_ms) + \
        bound + ({"ms_queued": queued, "tensor_core_bound_ms": tensor_ms,
                  "rel_err": err / scale,
                  "source": "aps_tpu_torch/csrc/wide_attention.cu",
                  **more},)


def _k2_over_library(rows, label, card):
    """K2's newest forward, dq and dk/dv rows of wide_heads_phase (one
    shape, `label`): each kernel's time over its tensor cores' bound
    (queued) and over the library's call (one launch), the three together
    over the library's forward with the backward of q, k and v; the ratios
    go into the rows and a line is printed."""
    names = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
    fwd, dq, dkv = (rows[name][-1][6] for name in names)
    ms = [rows[name][-1][2] for name in names]
    for more in (fwd, dq, dkv):
        more["over_tensor_core_bound"] = more["ms_queued"] / more[
            "tensor_core_bound_ms"]
    fwd["over_library"] = ms[0] / fwd["library_ms"]
    train = sum(ms)
    for more in (dq, dkv):
        more["train_ms"] = train
        more["train_over_library"] = train / more["library_train_ms"]
    print(f"K2 on the wide tiles [{label}]: forward {ms[0]:.4f} ms, dq "
          f"{ms[1]:.4f}, dk/dv {ms[2]:.4f} (queued over the TF32/3 bound "
          + ", ".join(f"{m['over_tensor_core_bound']:.2f}x"
                      for m in (fwd, dq, dkv))
          + f"); the forward {fwd['over_library']:.3f}x the library's "
          f"{fwd['library_ms']:.4f} ms; forward + dq + dk/dv {train:.4f} ms, "
          f"{dq['train_over_library']:.3f}x the library's forward and "
          f"backward {dq['library_train_ms']:.4f} ms ({card})", flush=True)


# K3's wide kernels as first ported, a warp a row on the CUDA cores (one
# launch, ms; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): forward
# with lse, dq, dk/dv, dpose at the step's shape (D = 160, 256) and at
# WIDE_OVER_SMALL (1100)
K3_WIDE_CUDA_CORE_MS = {160: (3.8217, 4.5153, 4.6353, 3.2521),
                        256: (5.1100, 4.1278, 4.3764, 3.6730),
                        1100: (3.4672, 2.5721, 2.6454, 3.6335)}


def _k3_over(rows, D, label, card):
    """K3's newest forward, dq, dk/dv and dpose rows of wide_heads_phase
    (one shape, `label`): each kernel's queued time over its tensor cores'
    bound and the CUDA-core kernels' reading at that width over its
    one-launch time (K3_WIDE_CUDA_CORE_MS). The first ratio, of this
    run's numbers alone, goes into the rows; both are printed."""
    names = {"flash_attention_rel": "forward", "flash_attention_rel_dq":
             "dq", "flash_attention_rel_dkv": "dk/dv",
             "flash_attention_rel_dpose": "dpose"}
    parts = []
    for (name, short), before in zip(names.items(),
                                      K3_WIDE_CUDA_CORE_MS[D]):
        row = rows[name][-1]
        more = row[6]
        more["over_tensor_core_bound"] = more["ms_queued"] / more[
            "tensor_core_bound_ms"]
        faster = before / row[2]
        parts.append(f"{short} {row[2]:.4f} ms (queued "
                     f"{more['ms_queued']:.4f}, "
                     f"{more['over_tensor_core_bound']:.2f}x the TF32/3 "
                     f"bound {more['tensor_core_bound_ms']:.5f}; "
                     f"{faster:.2f}x faster than the "
                     f"CUDA-core kernels' {before:.4f})")
    print(f"K3 on the wide tiles [{label}]: " + ", ".join(parts)
          + f" ({card})", flush=True)


def wide_heads_phase(dev, gen, card):
    """K2's and K3's wide kernels (csrc/wide_attention.cu) at heads of
    WIDE_OVER: 160 and 256 at the steps' shapes (WIDE_REL_CASES,
    WIDE_ABS_CASES: K3 B = 32, H = 4, T = 231; K2 B = 8, H = 4, T = 690)
    and the one-key corner, 1100 at WIDE_OVER_SMALL; forward and every
    backward kernel through the autograd Functions twice for bit-equal
    results, each within TOL_WIDE of the largest entry of the plain
    versions' results; each kernel launched alone and timed, alone and
    queued, beside the plain version, its bound, the tensor cores' bound
    and, for K2 at the step's shape, the library's call (forward, and the
    backward of its three inputs) with each K2 kernel's time over both
    (_k2_over_library), for K3 at the step's shape (1100: the small one)
    each kernel's queued time over its tensor cores' bound and the
    CUDA-core kernels' time over its own (_k3_over); K2's dbias at these
    widths is check_dbias's. No model has such a head: no path launches them. -> rows by kernel."""
    import torch

    from aps_tpu_torch.ops import attention as k2
    from aps_tpu_torch.ops import rel_attention as k3
    beg = time.perf_counter()
    rows = {name: [] for name in KERNELS if name.startswith(
        "flash_attention")}
    for D in WIDE_OVER:
        scale = D**-0.5
        rel_cases = WIDE_REL_CASES if D <= 256 else WIDE_OVER_SMALL
        abs_cases = WIDE_ABS_CASES if D <= 256 else WIDE_OVER_ABS_SMALL
        for B, H, T, lens, causal, Hp, role in rel_cases:
            args = [torch.randn((B, H, T, D), generator=gen).to(dev)
                    for _ in range(4)]
            args.append((0.3 * torch.randn((Hp, 2 * T - 1, D),
                                           generator=gen)).to(dev))
            klen = torch.tensor(lens, dtype=torch.int32, device=dev)
            do = torch.randn((B, H, T, D), generator=gen).to(dev)
            label = (f"B={B} H={H} D={D} T={T} Hp={Hp} causal={causal} "
                     f"k_len {role}")
            runs = []
            for _ in range(2):
                leaves = [a.clone().requires_grad_() for a in args]
                out = k3.flash_attention_rel(*leaves, k_len=klen,
                                             causal=causal)
                runs.append([out.detach()] + list(
                    torch.autograd.grad(out, leaves, do)))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"flash_attention_rel [{label}]: two runs differ")
            want_out = k3.rel_mha_reference(*args, k_len=klen, causal=causal)
            want = k3.rel_mha_backward_reference(*args, do, k_len=klen,
                                                 causal=causal)
            out_w, lse = k3.launch_forward(*args, klen, causal, True, scale)
            lse_err = (lse - k3.rel_lse_reference(
                *args[:3], args[4], k_len=klen, causal=causal)).abs()
            if not lse_err[lse < 1e29].max().item() <= TOL_ATT:
                fail(f"flash_attention_rel [{label}]: lse off by "
                     f"{lse_err.max().item()}")
            bwd = (*args, klen, do, lse, out_w, torch.empty_like(lse),
                   causal, scale)
            k3.launch_backward_kernel("dq", *bwd)  # forms delta
            plain_ms = time_ms(lambda: k3.rel_mha_reference(
                *args, k_len=klen, causal=causal), iters=5, warmup=1)
            bwd_plain = time_ms(lambda: k3.rel_mha_backward_reference(
                *args, do, k_len=klen, causal=causal), iters=3, warmup=1)
            flops = 2 * D * H * valid_pairs(T, lens, causal)
            size, table = B * H * T * D, Hp * (2 * T - 1) * D
            rows["flash_attention_rel"].append(_over_row(
                "flash_attention_rel", label + " with lse", runs[0][:1],
                [want_out], lambda: k3.launch_forward(
                    *args, klen, causal, True, scale), plain_ms,
                bound_ms(4 * (5 * size + B * H * T + table + B), 3 * flops),
                3 * flops))
            reads = 4 * (5 * size + table + 2 * B * H * T + B)
            for kernel, idx, ops, written in (
                    ("dq", (0, 1), 5 * flops, 8 * size),
                    ("dkv", (2, 3), 5 * flops, 8 * size),
                    ("dpose", (4,), 4 * flops, 4 * table)):
                rows[f"flash_attention_rel_{kernel}"].append(_over_row(
                    f"flash_attention_rel_{kernel}", label,
                    [runs[0][1 + i] for i in idx], [want[i] for i in idx],
                    lambda: k3.launch_backward_kernel(kernel, *bwd),
                    bwd_plain, bound_ms(reads + written, ops), ops))
            if role != "corner":
                _k3_over(rows, D, label, card)
        for B, H, T, lens, causal, role in abs_cases:
            q, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                           for _ in range(4))
            klen = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = f"B={B} H={H} D={D} T={T} causal={causal} k_len {role}"
            runs = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out = k2.flash_attention(*leaves, k_len=klen, causal=causal)
                runs.append([out.detach()] + list(
                    torch.autograd.grad(out, leaves, do)))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"flash_attention [{label}]: two runs differ")
            want_out = k2.mha_reference(q, k, v, k_len=klen, causal=causal)
            want = k2.mha_backward_reference(q, k, v, do, k_len=klen,
                                             causal=causal)
            out_w, lse = k2.launch_forward(q, k, v, None, klen, scale,
                                           causal, True)
            bwd = (q, k, v, None, klen, do, lse, out_w,
                   torch.empty_like(lse), scale, causal)
            k2.launch_backward_kernel("dq", *bwd)  # forms delta
            plain_ms = time_ms(lambda: k2.mha_reference(
                q, k, v, k_len=klen, causal=causal), iters=5, warmup=1)
            bwd_plain = time_ms(lambda: k2.mha_backward_reference(
                q, k, v, do, k_len=klen, causal=causal), iters=3, warmup=1)
            lib = {}
            if role == "step" and not causal:
                lib = {"library_ms": time_ms(lambda: _sdpa(q, k, v, klen),
                                             iters=5, warmup=1)}
                lib_bwd = {"library_train_ms": _sdpa_train_ms(
                    q, k, v, klen, do, iters=5, warmup=1)}
            flops = 2 * D * H * valid_pairs(T, lens, causal)
            size = B * H * T * D
            rows["flash_attention"].append(_over_row(
                "flash_attention", label, runs[0][:1], [want_out],
                lambda: k2.launch_forward(q, k, v, None, klen, scale,
                                          causal, False),
                plain_ms, bound_ms(4 * (4 * size + B), 2 * flops),
                2 * flops, **lib))
            for kernel, idx, ops in (("dq", (0,), 3 * flops),
                                     ("dkv", (1, 2), 4 * flops)):
                rows[f"flash_attention_{kernel}"].append(_over_row(
                    f"flash_attention_{kernel}", label,
                    [runs[0][1 + i] for i in idx], [want[i] for i in idx],
                    lambda: k2.launch_backward_kernel(kernel, *bwd),
                    bwd_plain,
                    bound_ms(4 * (4 * size + 2 * B * H * T + B) +
                             4 * len(idx) * size, ops), ops,
                    **(lib_bwd if lib else {})))
            if lib:
                _k2_over_library(rows, label, card)
    for kernel, info in k2.wide_occupancy().items():
        print(f"wide kernel occupancy, {kernel}: " + ", ".join(
            f"{key} {value}" for key, value in info.items()), flush=True)
    print(f"wide heads over 128: K2 and K3 at D = {WIDE_OVER} on the wide "
          "kernels (csrc/wide_attention.cu: K2's forward, dq and dk/dv on "
          "the tensor cores, each block's head split between two warpgroups; "
          "K3's forward, dq, dk/dv and dpose on the tensor cores, each "
          "block's head split in quarters between four warps a row group; "
          "1100 in five passes of 256 columns), forward and every backward "
          "kernel twice each for "
          f"bit-equal results, within {TOL_WIDE} of the largest entry of "
          f"the plain versions; the phase took "
          f"{time.perf_counter() - beg:.1f} s ({card})", flush=True)
    return rows


# data parallelism: train_am on the flagship's training corpus (32 x 8 s,
# one global batch) as one process, as two gloo ranks sharing the card, as
# one NCCL rank (two, one a card, where the machine has two cards) and as
# two gloo ranks with tensor_parallel 2 and sequence_parallel (one data
# index, two model ranks: the attention and feed-forward projections
# sharded, K1 on half of each batch's frames a rank), and decode_batch
# --data-parallel on two gloo ranks. The ranks are processes
# of their own (dp_train_run / dp_decode_run through `python -c`), each
# with a seed of its own for nothing: dropouts are off, so every run
# computes the same function of the same global batch
DP_WORLD = 2
DP_EPOCHS = 2  # one step each: the corpus is one batch
DP_TIMEOUT = 300  # seconds a run of the phase may take
# Adam's eps above the gradients' float32 rounding (as the CPU tests set
# it): with 1e-8 an entry whose gradient is rounding noise moves by +-lr,
# whichever way the noise fell in each run
DP_EPS = 1e-3
# a leaf's distance is taken relative to its largest entry, or to this
# share of the model's largest entry where that is more: a bias in front
# of a batch norm has a gradient of 0, whose float32 values are noise
DP_FLOOR = 1e-2
# pipeline_depth on the card: the corpus in batches of DP_PIPE_BATCH, one
# epoch, the DP_PIPE_POISON-th step non-finite (an inf sample in its first
# waveform: K1 keeps the plain version's NaN, so the loss is NaN), so that
# it is in flight behind its successor at depth DP_PIPE_DEPTH
DP_PIPE_BATCH = 8
DP_PIPE_POISON = 3
DP_PIPE_DEPTH = 2
# tensor and sequence parallelism on the card: two gloo ranks (one data
# index, two model ranks) in the data-parallel phase's runs
DP_TP = {"tensor_parallel": 2, "sequence_parallel": True}


def dp_conf(train: Path, root: Path) -> Path:
    """root/train.yaml: the training path's train.yaml with every dropout
    off and Adam's eps DP_EPS."""
    conf = json.loads((train / "train.yaml").read_text())
    arch = conf["nnet_conf"]
    arch["enc_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                             ffn_dropout=0.0)
    arch["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                             ffn_dropout=0.0)
    conf["trainer_conf"]["optimizer_kwargs"]["eps"] = DP_EPS
    (root / "train.yaml").write_text(json.dumps(conf, indent=2))
    return root / "train.yaml"


def dp_train_argv(conf: Path, root: Path, cpt: Path):
    return ["--conf", str(conf), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(TRAIN_UTTS),
            "--epochs", str(DP_EPOCHS), "--eval-interval", str(DP_EPOCHS),
            "--seed", str(SEED)]


def dp_train_run(spec_path: str) -> None:
    """One process of a dp_phase training run: train_am.main(argv) with
    the first step's loss and gradients (all-reduced: the global batch's;
    under tensor parallelism the sharded ones gathered whole), each step's
    time on the card's clock (CUDA events around the step; the first one
    traced by torch.profiler, whose kernel names are kept), the launch
    counts and the parameters at the end (whole) saved to spec's "out"
    (torch.save). With spec's "poison" that step's first waveform gets an
    inf sample; with "count_undo" the launches of one pipelined step's
    snapshot and undo at the end's train state are counted (a trace)."""
    import numpy as np
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.ops import build
    from aps_tpu_torch.parallel import tp
    from aps_tpu_torch.trainer.dp import DataParallelTrainer, _Snapshot
    spec = json.loads(Path(spec_path).read_text())
    record = {"loss": None, "grads": None, "step_ms": [], "names": [],
              "losses": [], "results": [], "steps_end": None}
    forward_backward = DataParallelTrainer._forward_backward
    dispatch = DataParallelTrainer.dispatch_step
    breaker, drain = DataParallelTrainer._breaker, DataParallelTrainer._drain

    def first_grads(self, dev):
        stats = forward_backward(self, dev)
        if record["grads"] is None and stats is not None:
            names = [k for k, p in self.task.nnet.named_parameters()
                     if p.requires_grad]
            record["grads"] = {k: self._full(i, p.grad.detach()).clone()
                               for i, (k, p) in enumerate(zip(
                                   names, self.params))}
            record["loss"] = stats["loss"].detach().clone()
        if stats is not None:
            record["losses"].append(stats["loss"].detach().clone())
        return stats

    def results(self, succ):
        record["results"].append(succ)
        return breaker(self, succ)

    def drained(self):
        drain(self)
        if record["step_ms"] and record["steps_end"] is None:
            torch.cuda.synchronize()
            record["steps_end"] = time.perf_counter()

    def timed(self, egs):
        if spec.get("host_clock"):
            # no trace and no wait for the card: the steps' wall time runs
            # from the first dispatch to the first drain (drained)
            record.setdefault("steps_beg", time.perf_counter())
            if len(record["step_ms"]) == 1:
                # from the second dispatch on: past the first step, which
                # runs blocking at every depth and makes Adam's state
                record["steps_beg2"] = time.perf_counter()
            poisoned = spec.get("poison") == len(record["step_ms"]) + 1
            if poisoned:
                egs = dict(egs, src_pad=np.array(egs["src_pad"]))
                egs["src_pad"][0, 1000] = np.inf
                record["before"] = _train_state(self)
            beg = time.perf_counter()
            out = dispatch(self, egs)
            record["step_ms"].append((time.perf_counter() - beg) * 1e3)
            if poisoned:
                record["after"] = _train_state(self)
            return out
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) if not \
                record["step_ms"] else contextlib.nullcontext() as prof:
            beg, end = (torch.cuda.Event(enable_timing=True) for _ in "be")
            beg.record()
            out = dispatch(self, egs)
            end.record()
            torch.cuda.synchronize()
        if prof is not None:
            record["names"] = sorted(kernel_names(prof))
        record["step_ms"].append(beg.elapsed_time(end))
        return out

    DataParallelTrainer._forward_backward = first_grads
    DataParallelTrainer.dispatch_step = timed
    DataParallelTrainer._breaker = results
    DataParallelTrainer._drain = drained
    try:
        build.reset_launches()
        with contextlib.redirect_stdout(sys.stderr):
            trainer = train_am.main(spec["argv"])
    finally:
        DataParallelTrainer._forward_backward = forward_backward
        DataParallelTrainer.dispatch_step = dispatch
        DataParallelTrainer._breaker = breaker
        DataParallelTrainer._drain = drain
    launches = dict(build.LAUNCHES)
    if spec.get("count_undo"):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        keep = torch.ones((), dtype=torch.bool, device=trainer.device)
        with torch.profiler.profile(activities=acts) as prof:
            snapshot = trainer._snapshot()
            saved = _Snapshot(list(trainer.task.buffers()))
            trainer._undo(snapshot, saved, keep)
            torch.cuda.synchronize()
        record["undo_launches"] = sum(
            1 for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA)
        record["undo_tensors"] = sum(
            len(g) for snap in (snapshot, saved)
            for g in snap.groups.values())
    names = [k for k, _ in trainer.task.nnet.named_parameters()]
    whole = tp.full_state_dict(trainer.task.nnet) if trainer.tp_plan \
        else dict(trainer.task.nnet.named_parameters())
    record.update(
        launches=launches, rank=trainer.rank,
        world=trainer.world, device=str(trainer.device),
        steps=trainer.cur_step, loss=float(record["loss"]),
        grads={k: v.cpu() for k, v in record["grads"].items()},
        losses=[float(v) for v in record["losses"]],
        undone=[torch.equal(a, b) for a, b in zip(
            record.pop("before", []), record.pop("after", []))],
        params={k: whole[k].detach().cpu() for k in names},
        sharded=len(trainer.tp_plan),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(record, spec["out"])


def _train_state(trainer) -> list:
    """Copies (on their device, no wait) of what a step may change: the
    trainable parameters, the buffers (batch-norm statistics) and every
    tensor of the optimizer's state (Adam's moments and step counts)."""
    import torch
    state = [v for p in trainer.params
             for v in trainer.optimizer.state[p].values()
             if isinstance(v, torch.Tensor)]
    return [t.detach().clone() for t in
            list(trainer.params) + list(trainer.task.buffers()) + state]


def dp_decode_run(spec_path: str) -> None:
    """One process of dp_phase's decode: decode_batch.main(argv) with the
    n-best list of each utterance (of each bucket's sharded_map, on a
    data-parallel rank the gathered lists of every rank) saved to spec's
    "out" (pickle), and the launch counts."""
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.ops import build
    spec = json.loads(Path(spec_path).read_text())
    lists = []
    sharded_map = decode_batch.sharded_map

    def kept(*args, **kwargs):
        hyps = sharded_map(*args, **kwargs)
        lists.append([[{"trans": list(map(int, h["trans"])),
                        "score": float(h["score"])} for h in nbest]
                      for nbest in hyps])
        return hyps

    decode_batch.sharded_map = kept
    try:
        build.reset_launches()
        stats = decode_batch.main(spec["argv"])
    finally:
        decode_batch.sharded_map = sharded_map
    Path(spec["out"]).write_bytes(pickle.dumps({
        "lists": lists, "scores": stats["scores"],
        "decode_secs": stats["decode_secs"],
        "launches": dict(build.LAUNCHES)}))


def dp_spawn(root: Path, entry: str, argvs):
    """Start one process a rank: `entry` of this script on a spec file
    holding that rank's argv -> (the processes, their output files)."""
    procs, outs = [], []
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for i, argv in enumerate(argvs):
        spec = root / f"{entry}.{i}.json"
        out = root / f"{entry}.{i}.out"
        spec.write_text(json.dumps({"argv": argv, "out": str(out)}))
        with open(root / f"{entry}.{i}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"import sys, chip_smoke; chip_smoke.{entry}(sys.argv[1])",
                 str(spec)], cwd=str(REPO), env=env,
                stdout=subprocess.DEVNULL, stderr=err))
        procs[-1].err_path = root / f"{entry}.{i}.err"
        outs.append(out)
    return procs, outs


def dp_wait(procs, what: str) -> None:
    """Wait for every process of a run; fail (after stopping them all)
    when one fails or the run outlasts DP_TIMEOUT."""
    deadline = time.monotonic() + DP_TIMEOUT
    for proc in procs:
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            break
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            fail(f"{what}: rank {rank} exited with {proc.returncode}: "
                 f"{proc.err_path.read_text()[-3000:]}")


def dp_rel(got, want) -> float:
    """The largest distance of a leaf of got from want's, relative to that
    leaf's largest entry or DP_FLOOR of the largest entry of all of want's
    leaves, whichever is more."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].double() - w.double()).abs().max()) /
               max(float(w.abs().max()), DP_FLOOR * top)
               for k, w in want.items())


def dp_check(label: str, got: dict, plain: dict, want_launches) -> dict:
    """A data-parallel run's rank against the one-process run: its first
    loss within TOL_STEP_LOSS, its first gradients and its final
    parameters within TOL_STEP_GRAD (dp_rel), its launch counts, and
    K1's and K3's kernels named by its trace. -> its numbers."""
    from aps_tpu_torch.ops import build
    names = ("fbank_fft_kernel",) + K3_KERNEL_NAMES
    loss_err = abs(got["loss"] - plain["loss"]) / abs(plain["loss"])
    grad_err = dp_rel(got["grads"], plain["grads"])
    param_err = dp_rel(got["params"], plain["params"])
    if not loss_err <= TOL_STEP_LOSS:
        fail(f"{label}: first loss {got['loss']} vs one process "
             f"{plain['loss']}, {loss_err:.3e} relative")
    if not (grad_err <= TOL_STEP_GRAD and param_err <= TOL_STEP_GRAD):
        fail(f"{label}: gradients {grad_err:.3e}, parameters after step "
             f"{DP_EPOCHS} {param_err:.3e} from one process (relative), "
             f"over {TOL_STEP_GRAD}")
    if got["launches"] != want_launches or got["steps"] != DP_EPOCHS:
        fail(f"{label}: launches {got['launches']} in {got['steps']} "
             f"steps, expected {want_launches}")
    missing = [k for k in names if not any(k in n for n in got["names"])]
    if missing:
        fail(f"{label}: the trace of its first step names no {missing}")
    if not all(got["launches"][k] > 0 for k in build.LAUNCHES
               if k == "fused_logmel" or k.startswith(
                   "flash_attention_rel")):
        fail(f"{label}: K1 or K3 not launched: {got['launches']}")
    return {"loss_rel": loss_err, "grad_rel": grad_err,
            "param_rel": param_err, "step_ms": got["step_ms"],
            "peak_gib": got["peak_gib"]}


def dp_pipeline_check(root: Path, conf: Path, card) -> dict:
    """train_am in this process at pipeline_depth DP_PIPE_DEPTH against
    blocking steps (depth 1) on the same batches, one of them non-finite:
    the same results in the same order for the error breaker, the train
    state bit for bit across the non-finite step at both depths, the same
    losses within TOL_STEP_LOSS, the parameters within TOL_STEP_GRAD
    (dp_rel), the same launches; the steps' wall time
    on the host's clock (from the first dispatch to the drain before
    validation, the card waited for) of each. -> numbers."""
    import torch
    runs = {}
    for depth in (1, DP_PIPE_DEPTH):
        conf_d = json.loads(conf.read_text())
        conf_d["trainer_conf"]["pipeline_depth"] = depth
        path = root / f"pipe{depth}.yaml"
        path.write_text(json.dumps(conf_d, indent=2))
        spec = root / f"pipe{depth}.json"
        argv = dp_train_argv(path, root, root / f"pipe{depth}")
        argv[argv.index("--batch-size") + 1] = str(DP_PIPE_BATCH)
        argv[argv.index("--epochs") + 1] = "1"
        argv[argv.index("--eval-interval") + 1] = "-1"
        spec.write_text(json.dumps({
            "argv": argv, "out": str(root / f"pipe{depth}.out"),
            "poison": DP_PIPE_POISON, "host_clock": True,
            "count_undo": depth > 1}))
        dp_train_run(str(spec))
        runs[depth] = torch.load(root / f"pipe{depth}.out",
                                 weights_only=False)
    block, piped = runs[1], runs[DP_PIPE_DEPTH]
    steps = len(block["results"])
    want = [i + 1 != DP_PIPE_POISON for i in range(steps)]
    if steps <= DP_PIPE_POISON or block["results"] != want or \
            piped["results"] != want:
        fail(f"dp pipeline: the breaker saw {piped['results']} at depth "
             f"{DP_PIPE_DEPTH}, {block['results']} blocking, expected "
             f"{want}")
    # the non-finite step leaves parameters, buffers and the optimizer's
    # state bit for bit as they were (at depth 2 undone by torch.where on
    # the card); the runs' backward is not deterministic (atomics), so
    # across the two runs Adam's moments of a leaf whose gradient is
    # rounding noise differ by some 1e-3 of their largest entry, and the
    # runs are held by their losses and parameters
    for depth, run in runs.items():
        if not (run["undone"] and all(run["undone"])):
            fail(f"dp pipeline: at depth {depth} the non-finite step "
                 f"changed {run['undone'].count(False)} of "
                 f"{len(run['undone'])} tensors of the train state")
    # the inf sample's step: a NaN loss at both depths (K1 keeps the NaN);
    # the other steps finite
    poisoned = [run["losses"].pop(DP_PIPE_POISON - 1)
                for run in (block, piped)]
    if any(math.isfinite(v) for v in poisoned):
        fail(f"dp pipeline: the step with an inf sample gave the losses "
             f"{poisoned} (blocking, depth {DP_PIPE_DEPTH}), not NaN")
    finite = all(map(math.isfinite, block["losses"] + piped["losses"]))
    loss_err = max(abs(a - b) / abs(a)
                   for a, b in zip(block["losses"], piped["losses"]))
    param_err = dp_rel(piped["params"], block["params"])
    if not (finite and loss_err <= TOL_STEP_LOSS and
            param_err <= TOL_STEP_GRAD):
        fail(f"dp pipeline: losses {piped['losses']} vs blocking "
             f"{block['losses']} ({loss_err:.3e}), parameters "
             f"{param_err:.3e} (relative)")
    if piped["launches"] != block["launches"]:
        fail(f"dp pipeline: depth {DP_PIPE_DEPTH} launched "
             f"{piped['launches']}, blocking {block['launches']}")
    wall = {d: (r["steps_end"] - r["steps_beg"]) * 1e3
            for d, r in runs.items()}
    wall2 = {d: (r["steps_end"] - r["steps_beg2"]) * 1e3
             for d, r in runs.items()}
    print(f"dp pipeline_depth {DP_PIPE_DEPTH} vs blocking (one process, "
          f"{steps} steps of {DP_PIPE_BATCH} utterances, step "
          f"{DP_PIPE_POISON} with an inf sample, its loss {poisoned[1]}): "
          f"breaker {piped['results']} as "
          f"blocking; the non-finite step left {len(piped['undone'])} "
          "tensors of the train state bit for bit at both depths; losses "
          f"within {loss_err:.3e}, parameters {param_err:.3e} (relative); "
          "the steps' wall ms on the host's clock, first dispatch to the "
          f"drain (from the second dispatch: blocking {wall2[1]:.2f}, depth "
          f"{DP_PIPE_DEPTH} {wall2[DP_PIPE_DEPTH]:.2f}), "
          f"blocking {wall[1]:.2f} (each dispatch "
          + ", ".join(f"{v:.2f}" for v in block["step_ms"])
          + f"), depth {DP_PIPE_DEPTH} {wall[DP_PIPE_DEPTH]:.2f} (each "
          + ", ".join(f"{v:.2f}" for v in piped["step_ms"]) + "); a "
          f"pipelined step's snapshot and undo: {piped['undo_launches']} "
          f"launches for {piped['undo_tensors']} tensors ({card})",
          flush=True)
    return {"pipe_loss_rel": loss_err, "pipe_param_rel": param_err,
            "pipe_undo_launches": piped["undo_launches"],
            "pipe_wall_ms": wall, "pipe_wall_ms_from_step2": wall2,
            "pipe_step_ms": {1: block["step_ms"],
                             DP_PIPE_DEPTH: piped["step_ms"]}}


def dp_train(root: Path, conf: Path, label: str, world: int, backend: str,
             one_card: bool):
    """train_am as `world` processes under `backend` (the trainer options
    of conf) -> each rank's record."""
    port = free_port()
    cpt = root / label
    argvs = []
    for rank in range(world):
        argv = dp_train_argv(conf, root, cpt) + [
            "--distributed", backend, "--coordinator-address",
            f"localhost:{port}", "--num-processes", str(world),
            "--process-id", str(rank)]
        argvs.append(argv + (["--device-id", "0"] if one_card else []))
    procs, outs = dp_spawn(root, "dp_train_run", argvs)
    dp_wait(procs, label)
    import torch
    return cpt, [torch.load(out, weights_only=False) for out in outs]


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_phase(root: Path, train: Path, cpt: Path, card):
    """Data, tensor and sequence parallelism on the card (module comment
    above DP_WORLD): the one-process run in this process, then each
    parallel run held against it (dp_check), checkpoints from rank 0 alone
    and a log a rank,
    then decode_batch --data-parallel against the plain decode_batch,
    utterance by utterance through nbest_error. -> (launch counts of each
    rank of each run, numbers)."""
    import torch
    root.mkdir()
    (root / "dict").write_text((train.parent / "dict").read_text())
    conf = dp_conf(train, root)
    spec = root / "plain.json"
    spec.write_text(json.dumps({
        "argv": dp_train_argv(conf, root, root / "plain"),
        "out": str(root / "plain.out")}))
    beg = time.perf_counter()
    dp_train_run(str(spec))
    secs = {"plain": time.perf_counter() - beg}
    plain = torch.load(root / "plain.out", weights_only=False)
    passes = 2 + DP_EPOCHS  # the validations before and after, the steps
    want = step_launches("flagship", passes, DP_EPOCHS)
    if plain["launches"] != want:
        fail(f"dp: the one-process run launched {plain['launches']}, "
             f"expected {want}")
    # tensor_parallel 2 with sequence_parallel: the train.yaml with DP_TP
    tp_conf = json.loads(conf.read_text())
    tp_conf["trainer_conf"].update(DP_TP)
    (root / "tp.yaml").write_text(json.dumps(tp_conf, indent=2))
    runs = [("gloo2", DP_WORLD, "gloo", True), ("nccl1", 1, "nccl", False),
            ("tp2sp", DP_WORLD, "gloo", True)]
    count = torch.cuda.device_count()
    if count >= 2:
        runs.append(("nccl2", DP_WORLD, "nccl", False))
    numbers = {"plain_step_ms": plain["step_ms"], "device_count": count,
               "runs": [r[0] for r in runs], "secs": secs}
    launches = {}
    for label, world, backend, one_card in runs:
        beg = time.perf_counter()
        cpt_dir, records = dp_train(
            root, root / "tp.yaml" if label == "tp2sp" else conf, label,
            world, backend, one_card)
        secs[label] = time.perf_counter() - beg
        for rec in records:
            if rec["world"] != world or not rec["device"].startswith("cuda"):
                fail(f"dp {label}: rank {rec['rank']} ran as one of "
                     f"{rec['world']} on {rec['device']}")
            name = f"{label}_rank{rec['rank']}"
            numbers[name] = dp_check(f"dp {name}", rec, plain, want)
            launches[name] = rec["launches"]
            if (rec["sharded"] > 0) != (label == "tp2sp"):
                fail(f"dp {name}: {rec['sharded']} weights sharded")
        ranks = [numbers[f"{label}_rank{r}"] for r in range(world)]
        files = sorted(p.name for p in cpt_dir.iterdir())
        logs = [f"trainer.rank.{r}.log" for r in range(world)] \
            if world > 1 else ["trainer.log"]
        if not set(logs + ["best.ckpt", "last.ckpt", "train.yaml",
                           "dict"]) <= set(files) or \
                (world > 1 and "trainer.log" in files):
            fail(f"dp {label}: the checkpoint directory holds {files}")
        print(f"dp {label} ({world} process(es), {backend}"
              f"{', one card' if one_card else ''}): first loss, gradients "
              "and parameters after step 2 from one process (relative) "
              + "; ".join(
                  f"rank {r} " + ", ".join(f"{ranks[r][k]:.3e}" for k in (
                      "loss_rel", "grad_rel", "param_rel"))
                  for r in range(world))
              + "; step ms on the card's clock (the first traced) "
              + "; ".join(f"rank {r} " + ", ".join(
                  f"{v:.2f}" for v in ranks[r]["step_ms"])
                  for r in range(world))
              + (f"; {records[0]['sharded']} weights sharded a rank, the "
                 "front end's frames split, launches a rank "
                 + "; ".join(f"rank {r} {records[r]['launches']}"
                             for r in range(world))
                 if label == "tp2sp" else "")
              + f"; files {files}; {secs[label]:.1f} s ({card})", flush=True)
    print(f"dp one process ({secs['plain']:.1f} s): step ms on the card's "
          "clock (the first traced) "
          + ", ".join(f"{v:.2f}" for v in plain["step_ms"])
          + f"; {count} card(s) seen; a gloo all-reduce between two "
          "processes on one card goes through the host and is no speed "
          f"number for NCCL ({card})", flush=True)

    beg = time.perf_counter()
    numbers.update(dp_pipeline_check(root, conf, card))
    secs["pipeline"] = time.perf_counter() - beg

    # decode_batch --data-parallel on two gloo ranks against the plain one
    wav_scp = cpt.parent / "wav.scp"
    argv = [str(wav_scp), str(root / "best.txt"), "--am", str(cpt),
            "--dict", str(cpt.parent / "dict")] + DECODE_ARGS
    spec = root / "decode_plain.json"
    spec.write_text(json.dumps({"argv": argv,
                                "out": str(root / "decode_plain.out")}))
    beg = time.perf_counter()
    dp_decode_run(str(spec))
    plain_dec = pickle.loads((root / "decode_plain.out").read_bytes())
    port = free_port()
    procs, outs = dp_spawn(root, "dp_decode_run", [
        [str(wav_scp), str(root / f"best_dp{r}.txt"), "--am", str(cpt),
         "--dict", str(cpt.parent / "dict")] + DECODE_ARGS + [
            "--data-parallel", "--distributed", "gloo",
            "--coordinator-address", f"localhost:{port}", "--num-processes",
            str(DP_WORLD), "--process-id", str(r), "--device-id", "0"]
        for r in range(DP_WORLD)])
    dp_wait(procs, "dp decode")
    secs["decode"] = time.perf_counter() - beg
    errs = []
    for r, out in enumerate(outs):
        got = pickle.loads(out.read_bytes())
        want_lists = [nb for batch in plain_dec["lists"] for nb in batch]
        got_lists = [nb for batch in got["lists"] for nb in batch]
        if len(got_lists) != len(want_lists):
            fail(f"dp decode rank {r}: {len(got_lists)} n-best lists, the "
                 f"plain decode {len(want_lists)}")
        for i, (a, b) in enumerate(zip(want_lists, got_lists)):
            err = nbest_error(a, b)
            if err is None:
                fail(f"dp decode rank {r}, utterance {i}: {b} vs the plain "
                     f"decode's {a}")
            errs.append(err)
        if not any(got["launches"].values()):
            fail(f"dp decode rank {r} launched no kernel")
        launches[f"decode_gloo2_rank{r}"] = got["launches"]
    lines = (root / "best_dp0.txt").read_text().splitlines()
    if sorted(lines) != sorted((root / "best.txt").read_text().splitlines()) \
            or (root / "best_dp1.txt").exists() and \
            (root / "best_dp1.txt").read_text():
        fail("dp decode: rank 0's transcripts differ from the plain "
             "decode's, or rank 1 wrote some")
    numbers["decode_score_err"] = max(errs)
    print(f"dp decode_batch --data-parallel (2 gloo ranks, one card): "
          f"{len(lines)} utterances, n-best lists as the plain decode's, "
          f"scores within {max(errs):.3e}; {secs['decode']:.1f} s with the "
          "plain decode; launches "
          f"{launches['decode_gloo2_rank0']}, "
          f"{launches['decode_gloo2_rank1']} ({card})", flush=True)
    return launches, numbers


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(SEED)

    run_beg = time.perf_counter()
    with phase("build"):
        for name, secs in build.build_all().items():
            print(f"built {name}.cu in {secs:.1f} s", flush=True)
    print(f"all kernels built in {time.perf_counter() - run_beg:.1f} s (one "
          "nvcc per source, started together)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # the RNN attention slice first: WSJ 1a (with its char RNN LM) and
        # TIMIT 1a through train_am and decode_batch, K1 and K4 at their
        # shapes. Their traces name K1's and K4's kernels; late in this
        # process the profiler has listed none of the ctypes-launched
        # kernels in such a trace (PERF.md section 6), where a trace early
        # in a process names them
        att_launches_of, att_rows = {}, {}
        for recipe in ATT_RECIPES:
            with phase(recipe):
                launches_trn_att, launches_dec_att, rows_att, _ = att_phase(
                    root / recipe, recipe, gen, dev, card)
            att_launches_of[recipe] = (launches_trn_att, launches_dec_att)
            for name, rows in rows_att.items():
                att_rows.setdefault(name, {})[recipe] = rows
                print_rows(name, rows, card)
        # the transducer slice, early too: its step and decode batch are
        # traced for their device time. It and sse8_phase draw from
        # generators of their own, so the phases after them see the inputs
        # they saw before these two phases were added
        with phase("transducer"):
            trd_train, trd_dec, trd_rows, _ = transducer_phase(
                root / "transducer", torch.Generator().manual_seed(SEED + 1),
                dev, card)
        for name, rows in trd_rows.items():
            print_rows(name, rows, card)
        # this slice's paths early too, each from a generator of its own:
        # their traces name K1's and K3's kernels (align) and K3's four
        # (the trainer's profile)
        with phase("align"):
            launches_align, align_rows = align_phase(
                root / "align", torch.Generator().manual_seed(SEED + 9), dev,
                card)
        for name, rows in align_rows.items():
            print_rows(name, rows, card)
        with phase("trainer options"):
            launches_opts = trainer_opts_phase(
                root / "trainer_opts",
                torch.Generator().manual_seed(SEED + 10), dev, card)
        cpt, wavs, model = write_checkpoint(root, gen)
        shapes = S, T, k_len = path_shapes(model)
        print(f"decode path: batches of 8 x {S} samples, encoder T = {T} "
              f"with {k_len} valid frames", flush=True)
        train = write_corpus(root, gen)
        egs = first_batch(root, train)
        shapes_trn = S_trn, T_trn, k_trn = train_shapes(model, egs)
        print(f"training path: one batch of {TRAIN_UTTS} x {S_trn} samples, "
              f"encoder T = {T_trn} with {sorted(set(k_trn))} valid frames",
              flush=True)
        # the long-form path: its checkpoint, utterances, corpus and shapes
        long_root = root / "long"
        long_root.mkdir()
        cpt_long, wavs_long, model_long = write_checkpoint(
            long_root, gen, "xfmr_abs", LONG_UTTS, LONG_SECS)
        shapes_long = S_long, T_long, k_long = path_shapes(model_long,
                                                           LONG_SECS)
        print(f"long-form decode path: batches of {LONG_BATCH} x {S_long} "
              f"samples, encoder T = {T_long} with {k_long} valid frames",
              flush=True)
        train_long = write_corpus(long_root, gen, "xfmr_abs",
                                  LONG_TRAIN_UTTS * LONG_TRAIN_BATCHES,
                                  LONG_SECS)
        egs_long = first_batch(long_root, train_long, LONG_TRAIN_UTTS,
                               LONG_TRAIN_BATCHES)
        shapes_ltr = S_ltr, T_ltr, k_ltr = train_shapes(model_long, egs_long)
        print(f"long-form training path: batches of {LONG_TRAIN_UTTS} x "
              f"{S_ltr} samples, encoder T = {T_ltr} with "
              f"{sorted(set(k_ltr))} valid frames", flush=True)
        kernel_checks = time.perf_counter()
        fbank_rows, more_fbank = check_fbank(dev, model, (
            ("decode", decode_batch_of(wavs, 8, S)),
            ("training", egs["src_pad"]),
            ("long-form decode",
             decode_batch_of(wavs_long, LONG_BATCH, S_long)),
            ("long-form training", egs_long["src_pad"])))
        checks = {"fused_logmel": fbank_rows}
        checks["flash_attention_rel"], more_fwd = check_rel_attention(
            dev, gen, T, k_len)
        ctc_rows, ctc_queued, ctc_wrapper = check_ctc(dev, gen, T)
        long_rows, long_queued, long_wrapper = check_ctc(
            dev, gen, T_long, batches=(LONG_BATCH,))
        checks["ctc_score_step"] = ctc_rows + long_rows
        bwd, more_rel = check_rel_attention_bwd(dev, gen, T_trn, k_trn)
        checks["flash_attention_rel"] += bwd.pop("fwd")
        for kernel, rows in bwd.items():
            checks[f"flash_attention_rel_{kernel}"] = rows
        att, library, backends, more = check_attention(
            dev, gen, (LONG_BATCH, T_long, k_long), (T_ltr, k_ltr))
        checks["flash_attention"] = att.pop("fwd")
        for kernel, rows in att.items():
            checks[f"flash_attention_{kernel}"] = rows
        print(f"the library's kernels (scaled_dot_product_attention, "
              f"float32, TF32 off), longest first: {backends}", flush=True)
        # K2's dbias at every head width, beside the library's training
        # call with a bias
        dbias_rows, library["flash_attention_dbias"], dbias_more = \
            check_dbias(dev, torch.Generator().manual_seed(SEED + 13),
                        T_ltr, k_ltr, card)
        checks["flash_attention_dbias"] += dbias_rows
        phase_ended("kernel checks", kernel_checks)
        del model, model_long
        for name, rows in checks.items():
            print_rows(name, rows, card)
        print("the plain time beside a backward kernel is that of the whole "
              "plain backward, which gives all of its gradients", flush=True)
        # K2 and K3 at heads of 96 and 128, and a 512-wide conformer's pass
        with phase("heads of 96 and 128"):
            wide_rows, launches_wide, wide_more = wide_head_phase(
                dev, torch.Generator().manual_seed(SEED + 6), card, egs)
        for name, rows in wide_rows.items():
            print_rows(name, rows, card)
        # heads over 128 on the wide kernels, and the feature grammar
        with phase("heads over 128"):
            over_rows = wide_heads_phase(
                dev, torch.Generator().manual_seed(SEED + 11), card)
        for name, rows in over_rows.items():
            print_rows(name, rows, card)
            wide_rows[name] += rows
        with phase("features"):
            launches_gmvn, launches_feat = features_phase(
                root / "features", train, egs,
                torch.Generator().manual_seed(SEED + 12), dev, card)

        best = root / "best.txt"
        argv = [str(root / "wav.scp"), str(best), "--am", str(cpt),
                "--dict", str(root / "dict")] + DECODE_ARGS
        decode_clock = time.perf_counter()
        build.reset_launches()
        with scorer_steps() as steps:
            stats = decode_batch.main(argv)
        launches = dict(build.LAUNCHES)
        lines = best.read_text().splitlines()
        if len(lines) != NUM_UTTS or sorted(
                ln.split("\t")[0] for ln in lines) != sorted(wavs):
            fail(f"expected {NUM_UTTS} transcript lines, got {len(lines)}")
        scores = list(stats["scores"].values())
        if len(scores) != NUM_UTTS or not all(map(math.isfinite, scores)):
            fail(f"non-finite or missing scores: {scores}")
        for name in DECODE_KERNELS:
            if launches[name] <= 0:
                fail(f"kernel {name} did not launch during the decode")
        want = decode_launches("flagship", len(stats["batch_secs"]),
                               len(steps))
        if launches != want or len(stats["batch_secs"]) != NUM_UTTS // 8:
            fail(f"decode launches {launches} in "
                 f"{len(stats['batch_secs'])} batches and {len(steps)} "
                 f"search steps, expected {want}")
        print(f"decode: {len(steps)} search steps, each one K4 launch over "
              f"{steps[0][0]} lanes reading {steps[0][1]} parent columns "
              "(no repeat of the gammas or the score)", flush=True)
        secs = stats["decode_secs"]
        batches = ", ".join(f"{b:.4f}" for b in stats["batch_secs"])
        print(f"decode: {NUM_UTTS} utterances x {UTT_SECS} s through "
              f"decode_batch in {secs:.4f} s (batches of 8: {batches} s) = "
              f"{stats['audio_secs'] / secs:.2f} audio-s/s, launches "
              f"{launches} ({card})", flush=True)
        enc_err, score_err = reference_check(cpt, wavs, dev, stats, shapes)
        print(f"card vs CPU on 2 utterances: encoder max abs err "
              f"{enc_err:.3e}, best-score diff {score_err:.3e}", flush=True)
        phase_ended("flagship decode", decode_clock)
        # the decoding options on the same checkpoint, then kaldi feature
        # archives (am@kaldi, decode from a feats.scp); a generator of its
        # own, so the phases after it see the inputs they saw before
        with phase("decoding options"):
            launches_opt = decode_options_phase(root, cpt, wavs, shapes, dev,
                                                card)
        with phase("kaldi"):
            launches_kal, launches_kal_dec = kaldi_phase(
                root / "kaldi", root / "dict",
                torch.Generator().manual_seed(SEED + 5), dev, card)

        # the LM slice: run.sh stage 4 with the RNN LM and stage 5, the
        # Transformer LM in the single-utterance search, lm_rescore on its
        # nbest, and stage 3, train_lm
        with phase("LM"):
            lm_dir, _ = write_lm(root, RNN_LM_YAML, gen, "rnn_lm")
            xfmr_dir, _ = write_lm(root, XFMR_LM_YAML, gen, "xfmr_lm")
            launches_lm, _ = lm_decode_phase(root, cpt, lm_dir, wavs, shapes,
                                             dev, card)
            launches_xlm, xlm_nbest, _ = xfmr_lm_phase(root, cpt, xfmr_dir,
                                                       wavs, card)
            lm_rescore_phase(root, xlm_nbest, lm_dir, card)
            launches_tlm, _, _ = train_lm_phase(
                root, write_lm_corpus(root, gen), dev, card)

        with phase("flagship training"):
            dropout_step(egs, dev, gen, card)
            launches_trn, per_step, flagship_secs = train_phase(
                root, train, egs, dev, card)
            loss_g, loss_c, errs = step_check(egs, dev, gen, shapes_trn)
        print(f"training pass card vs CPU, dropouts off: loss {loss_g:.6f} "
              f"vs {loss_c:.6f}; gradient errors relative to the largest "
              "entry " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)

        # the recipe as written: train_am, then its pass card vs CPU and
        # TF32 vs float32
        with phase("recipe"):
            egs_rcp, launches_rcp, per_step_rcp, timed, trainer, seen = \
                recipe_phase(root, train, dev, card)
            recipe_rows = check_recipe_kernels(dev, gen, trainer.task.nnet,
                                               seen)
            del trainer, seen
            for name, rows in recipe_rows.items():
                checks[name] += rows
                print_rows(name, rows, card)
            losses, (loss_err, errs), (tf32_loss_err, tf32_errs) = \
                recipe_check(root, egs_rcp, dev, gen)
        print(f"recipe pass, dropouts off, draws fed in: loss CPU "
              f"{losses[0]:.6f}, card float32 {losses[1]:.6f}, card TF32 "
              f"{losses[2]:.6f}; card vs CPU: loss {loss_err:.3e}, "
              "gradients " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in errs.items()) +
              f"; TF32 vs float32 on the card: loss {tf32_loss_err:.3e}, "
              "gradients " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in tf32_errs.items()),
              flush=True)
        print(f"three steps: recipe mini-step ({RECIPE_BATCH} x {UTT_SECS} "
              f"s) at float32 {timed['float32'][0]:.4f} s, at its bfloat16 "
              f"(TF32) {timed['bfloat16'][0]:.4f} s; flagship step "
              f"({TRAIN_UTTS} x {UTT_SECS} s) {flagship_secs:.4f} s (host "
              f"clock around a synchronised step, medians) ({card})",
              flush=True)

        # the long-form path: decode, card vs CPU, training, card vs CPU
        long_clock = time.perf_counter()
        stats_long, launches_long = long_decode_phase(long_root, cpt_long,
                                                      wavs_long, card)
        enc_err, score_err = reference_check(cpt_long, wavs_long, dev,
                                             stats_long, shapes_long)
        print(f"long-form card vs CPU on {LONG_CHECK_UTTS} utterances: "
              f"encoder max abs err {enc_err:.3e}, best-score diff "
              f"{score_err:.3e}", flush=True)
        launches_ltr, per_step_long, _ = train_phase(
            long_root, train_long, egs_long, dev, card, "xfmr_abs",
            LONG_TRAIN_UTTS, LONG_SECS, LONG_TIMED_STEPS,
            LONG_TRAIN_BATCHES)
        for seed, (loss_g, loss_c, errs) in referee_step_check(
                egs_long, dev, shapes_ltr, "xfmr_abs",
                LONG_STEP_SEEDS).items():
            print(f"long-form training pass, dropouts off, weights of seed "
                  f"{seed}: loss card {loss_g:.6f} vs CPU {loss_c:.6f}; "
                  "gradient errors relative to the largest entry (card vs "
                  "CPU, card vs float64, CPU vs float64) "
                  + ", ".join(f"{k} " + ", ".join(f"{e:.3e}" for e in v)
                              for k, v in errs.items()), flush=True)
        phase_ended("long-form", long_clock)

        # the separation path: its kernel, the separate command, the
        # train_ss command
        sep_clock = time.perf_counter()
        sep_root = root / "separation"
        sep_root.mkdir()
        shapes_sep = S_sep, T_sep = sep_shapes()
        print(f"separation path: batches of {SEP_BATCH} x {S_sep} samples, "
              f"{TCN_BLOCKS} TCN blocks at T = {T_sep} frames x "
              f"{TCN_CONF['B']} channels", flush=True)
        checks["tcn_block_fused"], tcn_dilations = check_tcn(dev, gen, T_sep)
        print_rows("tcn_block_fused", checks["tcn_block_fused"], card)
        tcn_cpt = write_tcn_checkpoint(sep_root, gen)
        mixes = write_mixtures(sep_root, SEP_UTTS, gen)
        launches_sep = separate_phase(sep_root, tcn_cpt, mixes, shapes_sep,
                                      card)
        separation_check(tcn_cpt, mixes, dev, shapes_sep, card)
        precision_phase(root, cpt, sep_root, tcn_cpt, card)
        train_ss = write_sep_corpus(sep_root, gen)
        egs_ss, launches_ss = train_ss_phase(train_ss, dev, card)
        loss_g, loss_c, errs = sep_step_check(egs_ss, dev)
        print(f"sse@sisnr training pass card vs CPU on {SEP_CHECK_UTTS} "
              f"mixtures: loss {loss_g:.6f} vs {loss_c:.6f}; distance of "
              "the float32 gradients (card, CPU) from the card's float64 "
              "gradient, relative to the largest entry: "
              + ", ".join(f"{k} {a:.3e}, {b:.3e}"
                          for k, (a, b) in errs.items()), flush=True)
        phase_ended("separation", sep_clock)

        # the frequency-domain slice: wham/run.sh stages 2 to 4 with
        # recipe 1b as written, then sse@freq_tcn
        with phase("wham"):
            launches_wham, launches_wsep, launches_ftcn, _ = wham_phase(
                root / "wham", gen, dev, card)

        # the multi-channel slice: chime4 1b (train_am, decode_batch with
        # the LM, compute_wer) and chime4_ml 1a (train_ss, separate); K3's
        # forward and K4 at the chime4 decode's shapes
        chime4_clock = time.perf_counter()
        (launches_c4, launches_c4dec, launches_ml, launches_mlsep,
         (T_c4, k_c4), pass_c4, _) = chime4_phase(root / "chime4", gen, dev,
                                                  card)
        chime4_rows = {
            "flash_attention_rel": check_rel_attention(
                dev, gen, cases=((T_c4, 1, False, [k_c4] * CHIME4_DECODE_UTTS,
                                  "path"),))[0],
            "ctc_score_step": check_ctc(dev, gen, T_c4,
                                        batches=(CHIME4_DECODE_UTTS,),
                                        beam=16)[0]}
        # K3's forward with lse and its backward kernels at the training
        # pass's (B, T, k_len), held twice each
        heads = {H for _, H, _, _, _, _, _ in pass_c4}
        if len(heads) != 1 or {D for _, _, _, D, _, _, _ in pass_c4} != {64}:
            fail(f"the chime4 pass handed K3 {pass_c4}")
        bwd = check_rel_attention_bwd(
            dev, gen, H=heads.pop(),
            cases=[(T, Hp, causal, list(lens), "chime4")
                   for _, _, T, _, Hp, lens, causal in pass_c4])[0]
        chime4_rows["flash_attention_rel"] += bwd.pop("fwd")
        for kernel, rows in bwd.items():
            chime4_rows[f"flash_attention_rel_{kernel}"] = rows
        for name, rows in chime4_rows.items():
            checks[name] += rows
            print_rows(name, rows, card)
        phase_ended("chime4", chime4_clock)
        # chunked separation of a 5-channel mixture
        with phase("multi-channel chunks"):
            launches_mc = mc_chunk_phase(
                root / "mc_chunk", torch.Generator().manual_seed(SEED + 7),
                dev, card)

        # the rest of the SSE zoo: wsj0_2mix/1b, dns_is2020/1a and
        # export_dcunet/1a through train_ss and separate (no kernel on
        # their path), then sse@freq_xfmr through K3's four kernels
        zoo_root = root / "zoo"
        zoo_root.mkdir()
        zoo_launches = {}
        for recipe in ZOO_RECIPES:
            with phase(recipe):
                zoo_launches[recipe] = zoo_recipe_phase(
                    zoo_root / recipe.replace("/", "_"), recipe, gen, dev,
                    card)[:2]
        with phase("freq_xfmr"):
            launches_fx, launches_fxsep, fx_rows, _ = freq_xfmr_phase(
                zoo_root / "freq_xfmr", gen, dev, card)
        for name, rows in fx_rows.items():
            checks[name] += rows
            print_rows(name, rows, card)
        # sse@ts: a student distilled from that checkpoint on se@simu_cmd
        # mixtures, and its separation in bfloat16
        with phase("ts"):
            launches_ts, launches_tssep = ts_phase(
                zoo_root / "ts", zoo_root / "freq_xfmr" / "cpt",
                torch.Generator().manual_seed(SEED + 8), dev, card)

        # the eight sse@ models that no phase above runs, and K2 at
        # SepFormer's chunk shapes
        with phase("sse8"):
            sse8_launched, sse8_rows, _ = sse8_phase(
                torch.Generator().manual_seed(SEED + 2), dev, card)
        sse8_rows = {f"flash_attention{'' if k == 'fwd' else '_' + k}": r
                     for k, r in sse8_rows.items()}
        for name, rows in sse8_rows.items():
            checks[name] += rows
            print_rows(name, rows, card)
        # the streaming slice: streaming_asr@transducer and @ctc at 1f's
        # width, rt_sse@dfsmn and rt_sse@freq_xfmr; K1 at the ASR path's
        # shapes
        with phase("streaming ASR"):
            stream_launches_of, stream_rows, _ = streaming_asr_phase(
                root / "streaming", torch.Generator().manual_seed(SEED + 3),
                dev, card)
        for name, rows in stream_rows.items():
            checks[name] += rows
            print_rows(name, rows, card)
        for rt_name in RT_SSE_CONFS:
            with phase(rt_name):
                trn, sep, _ = rt_sse_phase(
                    root / rt_name.split("@")[1], rt_name,
                    torch.Generator().manual_seed(SEED + 4), dev, card)
            label = rt_name.replace("@", "_")
            stream_launches_of[f"{label}_train_run"] = trn
            stream_launches_of[f"{label}_separate"] = sep
        # data parallelism last: a phase before the others would move the
        # draws of every phase after it
        with phase("data parallel"):
            dp_launches, _ = dp_phase(root / "dp", train, cpt, card)
        # the transducer slice's rows of K1 and K3, the alignment's
        for name, rows in trd_rows.items():
            checks[name] += rows
        for name, rows in align_rows.items():
            checks[name] += rows

        # the RNN attention slice's rows of K1 and K4
        for name, per_recipe in att_rows.items():
            for rows in per_recipe.values():
                checks[name] += rows

    kernels = []
    for name, rows in checks.items():
        source, replaces = KERNELS[name]
        _, _, ms, plain_ms, bound, bound_by = rows[0]
        extra = {}
        if name in TRAIN_ROW:
            row = rows[TRAIN_ROW[name]]
            extra = {"train_shape": row[0], "train_ms": row[2],
                     "train_plain_ms": row[3], "train_bound_ms": row[4]}
        if name in LONG_ROWS:
            extra["long_form_rows"] = [
                {"shape": rows[i][0], "ms": rows[i][2],
                 "plain_ms": rows[i][3], "bound_ms": rows[i][4]}
                for i in LONG_ROWS[name]]
        if name in DECODE_KERNELS:
            path_launches = launches[name]
        elif name == "flash_attention":
            path_launches = launches_long[name]
            extra["train_library_ms"] = library[
                "flash_attention (training shape)"]
            extra["tensor_core_bound_note"] = TF32_NOTE
            extra.update(more[name])
        elif name.startswith("flash_attention_d"):
            path_launches = launches_ltr[name]
            if name == "flash_attention_dbias":
                extra["why_no_launches"] = (
                    "no model passes a bias (nor does any caller in "
                    "aps_tpu): the kernel is held against its plain "
                    "versions only")
                extra["library_ms_covers"] = (
                    "the forward and the backward of q, k, v and the bias "
                    "(scaled_dot_product_attention with a bias that "
                    "requires a gradient, every key visible, D = 64)")
                extra["tensor_core_bound_note"] = TF32_NOTE
                extra.update(dbias_more)
            else:
                extra["library_ms_covers"] = (
                    "dq, dk and dv together (one backward through the "
                    "library call)")
                extra.update(more[name])
        elif name == "tcn_block_fused":
            path_launches = launches_sep[name]
            # one forward runs each of the first X rows' dilations R times
            # (the next X rows: the same in bfloat16)
            X, R = TCN_CONF["X"], TCN_CONF["R"]
            extra = {"forward_ms": R * sum(r[2] for r in rows[:X]),
                     "forward_plain_ms": R * sum(r[3] for r in rows[:X]),
                     "forward_ms_bfloat16": R * sum(
                         r[2] for r in rows[X:2 * X]),
                     "launches_per_batch": TCN_BLOCKS,
                     "max_abs_err_bfloat16": max(
                         r[1] for r in rows if "bfloat16" in r[0]),
                     "tensor_core_bound_note": TF32_NOTE + " (float32); "
                     "bfloat16: operations over the dense bf16 peak",
                     "per_dilation": tcn_dilations}
        else:
            path_launches = launches_trn[name]
        if name == "fused_logmel":
            extra.update(more_fbank)
        if name in recipe_rows:
            extra["recipe_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4]}
                for r in recipe_rows[name]]
        if name in chime4_rows:
            extra["chime4_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5]}
                for r in chime4_rows[name]]
        if name in fx_rows:
            extra["freq_xfmr_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5]}
                for r in fx_rows[name]]
        for recipe, (trn, sep) in zoo_launches.items():
            extra[f"launches_{recipe}_train_run"] = trn[name]
            extra[f"launches_{recipe}_separate"] = sep[name]
        for recipe, rows in att_rows.get(name, {}).items():
            extra[f"{recipe}_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5]}
                for r in rows]
        for recipe, (trn, dec) in att_launches_of.items():
            extra[f"launches_{recipe}_train_run"] = trn[name]
            extra[f"launches_{recipe}_decode"] = dec[name]
        for key, table in (("transducer_rows", trd_rows),
                           ("sepformer_rows", sse8_rows),
                           ("streaming_rows", stream_rows)):
            if name in table:
                extra[key] = [
                    {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                     "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5],
                     **(r[6] if len(r) > 6 else {})}
                    for r in table[name]]
        for option, counts in launches_opt.items():
            extra[f"launches_decode_{option}"] = counts[name]
        extra.update(launches_kaldi_train_run=launches_kal[name],
                     launches_kaldi_decode=launches_kal_dec[name],
                     launches_ts_train_run=launches_ts[name],
                     launches_ts_separate_bfloat16=launches_tssep[name],
                     launches_chunked_separate_multichannel=launches_mc[
                         name],
                     launches_wide_head_pass=launches_wide.get(name, 0))
        extra.update(
            launches_align=launches_align[name],
            launches_train_options_run=launches_opts[name],
            launches_compute_gmvn=launches_gmvn[name],
            **{f"launches_features_{k.replace(' ', '_')}_pass":
               counts.get(name, 0) for k, counts in launches_feat.items()})
        if name in align_rows:
            extra["align_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5]}
                for r in align_rows[name]]
        if name.startswith("flash_attention"):
            # heads over 128: the rows of wide_head_rows whose "source"
            # says so
            extra["wide_source"] = "aps_tpu_torch/csrc/wide_attention.cu"
        if name in wide_rows:
            extra["wide_head_rows"] = [
                {"shape": r[0], "max_abs_err": r[1], "ms": r[2],
                 "plain_ms": r[3], "bound_ms": r[4], "bound_by": r[5],
                 **r[6]} for r in wide_rows[name]]
        if name == "flash_attention":
            extra["library_ms_D128"] = wide_more["library_ms_D128"]
        if name in ("flash_attention", "flash_attention_dq",
                    "flash_attention_dkv"):
            extra["library_train_ms_D128"] = wide_more[
                "library_train_ms_D128"]
        extra["launches_transducer_train_run"] = trd_train[name]
        extra["launches_transducer_decode"] = trd_dec[name]
        for path, counts in stream_launches_of.items():
            extra[f"launches_{path}"] = counts[name]
        for run, counts in dp_launches.items():
            extra[f"launches_dp_{run}"] = counts[name]
        for model_name, counts in sse8_launched.items():
            extra[f"launches_{model_name}_pass"] = counts.get(name, 0)
        if name == "ctc_score_step":
            extra.update(ms_queued=ctc_queued,
                         long_form_ms_queued=long_queued,
                         wrapper_ms_queued=ctc_wrapper,
                         long_form_wrapper_ms_queued=long_wrapper)
        if name == "flash_attention_rel":
            extra.update(more_fwd,
                         train_ms_queued=more_rel["fwd_train_ms_queued"],
                         train_tensor_core_bound_ms=more_rel[
                             "fwd_train_tensor_core_bound_ms"],
                         tensor_core_bound_note=TF32_NOTE)
        elif name.startswith("flash_attention_rel_"):
            extra.update(more_rel[name], tensor_core_bound_note=TF32_NOTE)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # of the path whose shape the first row was checked at; every
            # path's counts follow
            "launches": path_launches,
            "launches_decode": launches[name],
            "launches_train_run": launches_trn[name],
            "launches_train_step": per_step[name],
            "launches_separate": launches_sep[name],
            "launches_train_ss": launches_ss[name],
            "launches_decode_long": launches_long[name],
            "launches_train_long_run": launches_ltr[name],
            "launches_train_long_step": per_step_long[name],
            "launches_recipe_run": launches_rcp[name],
            "launches_recipe_step": per_step_rcp[name],
            "launches_decode_lm": launches_lm[name],
            "launches_decode_xfmr_lm": launches_xlm[name],
            "launches_train_lm": launches_tlm[name],
            "launches_train_ss_wham": launches_wham[name],
            "launches_separate_wham": launches_wsep[name],
            "launches_freq_tcn": launches_ftcn[name],
            "launches_chime4_train_run": launches_c4[name],
            "launches_chime4_decode": launches_c4dec[name],
            "launches_chime4_ml_train": launches_ml[name],
            "launches_chime4_ml_separate": launches_mlsep[name],
            "launches_freq_xfmr_train_run": launches_fx[name],
            "launches_freq_xfmr_separate": launches_fxsep[name],
            "max_abs_err": max(r[1] for r in rows
                               if "bfloat16" not in r[0]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            # one PyTorch call, scaled_dot_product_attention, computes the
            # scaled-dot-product attention's forward without a bias, and
            # autograd through it dq, dk and dv together, and with a bias
            # that requires a gradient also dbias: timed in check_attention
            # and check_dbias and used nowhere in the port. No single call
            # computes any other of these functions: the relative term is
            # formed inside the rel attention kernels, the front end is a
            # chain of calls, the scorer a loop over frames, the TCN block
            # two products around a stencil
            "library_ms": library.get(name),
            **extra,
        })
    print("phase seconds: " + ", ".join(
        f"{name} {secs:.1f}" for name, secs in PHASE_SECS.items())
          + f"; the whole run {time.perf_counter() - run_beg:.1f} s ({card})",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
