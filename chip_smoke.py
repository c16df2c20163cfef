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
   200 are valid; a few other shapes widen the check. The log-mel kernel is
   also held at the training batch (32 x the loader's padded length), whose
   grid and frame count differ from the decode's. The three backward
   kernels of the rel-pose attention are held against the explicit plain
   backward and against autograd through the plain forward at the training
   step's shape (B = 32, T and k_len as the loader pads the batch) and at
   shapes that widen it. Each kernel's time stands beside its bound: the
   larger of its bytes over the card's memory rate and its operations over
   the card's float32 rate.
5. Decodes them through `aps_tpu_torch.cmd.decode_batch` (batch 8, beam 8,
   ctc weight 0.4, max_len 40), with every kernel's launch count reset just
   before and read just after; each kernel must have launched.
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
   kernel's time may read below its bound.
13. Trains one step of the flagship with att_dropout 0.1 in the encoder on
   the card: the dense attention path, a finite loss, no attention kernel
   launched.
14. The long-form path at full width: the abs-pose transformer model (12
   post-norm layers of width 256, 4 heads, feed-forward 2048, the
   flagship's decoder and CTC head) written as an aps_tpu checkpoint; 8
   utterances of 24 s through `aps_tpu_torch.cmd.decode_batch` in batches
   of 4 (per batch K1 once, K2's forward 12 times, K4 once per search step,
   the rel-pose kernels never); two utterances card vs CPU; then training
   through `aps_tpu_torch.cmd.train_am` in batches of 8 x 24 s (a corpus
   of 16, since the loader wants ten utterances; per step K2's forward,
   dq and dk/dv 12 times each, dbias never: the model passes no bias), the
   loss must fall; one training pass with dropouts off card vs CPU.
   (Steps 12 to 14 run where their data is at hand: 12 with the other
   kernel checks, 13 before step 7, 14 after step 8.)

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed."""

import contextlib
import copy
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
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
# of all kernels compare (all but K2's dq and dk/dv compute on the CUDA
# cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# dense bfloat16 in the tensor cores: the bound of a bfloat16 product,
# whatever unit the kernel itself uses
PEAK_BF16_PER_S = 989e12
# dense TF32 in the tensor cores. K2's dq and dk/dv do each float32
# product as three TF32 products, so their second bound is their operations
# over a third of this rate
PEAK_TF32_PER_S = 495e12
TF32_PASSES = 3
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
    "flash_attention_dbias": ("aps_tpu_torch/csrc/attention_bwd.cu",
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
TRAIN_ROW = {"fused_logmel": 1, "flash_attention_rel": 4,
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
    for label, err, ms, plain_ms, bound, bound_by in rows:
        print(f"{name} [{label}]: max abs err {err:.3e}, kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms by "
              f"{bound_by} ({card})", flush=True)
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
    the long-form path's two."""
    import torch

    from aps_tpu_torch.ops.fbank import fused_logmel, fused_logmel_plain
    tf = model.asr_transform
    kw = dict(mel=tf.mel, pre_emphasis=tf.pre_emphasis,
              normalized=tf.stft_normalized, use_power=tf.use_power,
              log_lower_bound=tf.log_lower_bound, log_eps=tf.eps)
    rows = []
    for path, wav in batches:
        wav = torch.as_tensor(wav)
        args = (wav.to(dev), tf.window, tf.fft_size, tf.frame_hop)
        N, S = wav.shape
        label = f"N={N} S={S} M={tf.feats_dim} ({path})"
        got = fused_logmel(*args, **kw)
        want = fused_logmel_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"fused_logmel {label}: non-finite output")
        err = (got - want).abs().max().item()
        if not err <= TOL_LOGMEL:
            fail(f"fused_logmel {label}: max abs err {err} > {TOL_LOGMEL}")
        ms = time_ms(lambda: fused_logmel(*args, **kw))
        plain_ms = time_ms(lambda: fused_logmel_plain(*args, **kw))
        # the least the function needs: it reads the waveform, the window
        # and the mel matrix and writes the features; per frame a fast
        # Fourier transform of fft_size points (5 n log2 n operations),
        # pre-emphasis and window (3 per sample), the power of each bin (3)
        # and the mel product. The kernel itself runs a dense DFT, 4 * F *
        # fft_size operations per frame: over twenty times that transform.
        T, M = got.shape[1:]
        n_fft, F = tf.fft_size, tf.fft_size // 2 + 1
        per_frame = 5 * n_fft * math.log2(n_fft) + 3 * tf.frame_len + \
            3 * F + 2 * F * M
        bound = bound_ms(4 * (N * S + len(tf.window) + F * M + N * T * M),
                         N * T * per_frame)
        rows.append((label, err, ms, plain_ms) + bound)
    return rows


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


def check_rel_attention(dev, gen, T_path, k_path):
    """K3 first as the encoder calls it (q_c = q_p, one shared pose table,
    every utterance k_path of T_path frames valid), then with ragged k_len,
    causal masks, per-head tables and several key tiles."""
    import torch

    from aps_tpu_torch.ops.rel_attention import (flash_attention_rel,
                                                 rel_mha_reference)
    B, H, D = 8, 4, 64
    rows = []
    for T, Hp, causal, ragged in ((T_path, 1, False, False),
                                  (T_path, 1, True, True),
                                  (700, 1, False, True),
                                  (700, H, True, True)):
        q_c, q_p, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
                          for _ in range(4))
        if not ragged:
            q_p = q_c
        pose = (0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)).to(dev)
        lens = [T, T - 17, T // 2, 1, T, T - 90, 3, T // 3] if ragged \
            else [k_path] * B
        k_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q_c, q_p, k, v, pose)
        kw = dict(k_len=k_len, causal=causal)
        got = flash_attention_rel(*args, **kw)
        want = rel_mha_reference(*args, **kw)
        torch.cuda.synchronize()
        label = (f"B=8 H=4 D=64 T={T} Hp={Hp} causal={causal} k_len="
                 + ("ragged" if ragged else f"{k_path}"))
        if not torch.isfinite(got).all():
            fail(f"flash_attention_rel {label}: non-finite output")
        err = (got - want).abs().max().item()
        ms = time_ms(lambda: flash_attention_rel(*args, **kw))
        plain_ms = time_ms(lambda: rel_mha_reference(*args, **kw))
        # four inputs and the output, the pose table and k_len; the three
        # products q_c.k, q_p.pose and p.v over the pairs the mask leaves
        bound = bound_ms(
            4 * (5 * B * H * T * D + Hp * (2 * T - 1) * D + B),
            3 * 2 * D * H * valid_pairs(T, lens, causal))
        rows.append((label, err, ms, plain_ms) + bound)
        if not err <= TOL_ATT:
            fail(f"flash_attention_rel {label}: max abs err {err} > "
                 f"{TOL_ATT}")
    return rows


def check_rel_attention_bwd(dev, gen, T_path, lens_path):
    """The three backward kernels of K3, each launched alone, against
    rel_mha_backward_reference and against autograd through
    rel_mha_reference: first at the training step's shape (B = 32, one
    shared pose table, the loader's padded T and valid frames), then with
    ragged k_len over several tiles, causal masks, per-head tables and
    batch entries without any valid key (k_len 0: zero gradients, no NaN).
    Also holds and times the forward that writes lse, which the backward
    reads (rows "fwd")."""
    import torch

    from aps_tpu_torch.ops.rel_attention import (launch_backward_kernel,
                                                 launch_forward,
                                                 rel_mha_backward_reference,
                                                 rel_mha_reference)
    H, D = 4, 64
    ragged = lambda T: [T, T - 17, T // 2, 1, 0, T - 90, 3, T // 3]
    rows = {kernel: [] for kernel in BACKWARD + ("fwd",)}
    for T, Hp, causal, lens in ((T_path, 1, False, lens_path),
                                (T_path, 1, True, ragged(T_path)),
                                (700, 1, False, ragged(700)),
                                (700, H, True, ragged(700))):
        B = len(lens)
        q_c, q_p, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                              for _ in range(5))
        pose = (0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)).to(dev)
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q_c, q_p, k, v, pose, klen)
        label = (f"B={B} H=4 D=64 T={T} Hp={Hp} causal={causal} k_len="
                 + (f"{lens[0]}" if len(set(lens)) == 1 else "ragged"))
        out, lse = launch_forward(*args, causal, True)
        delta = (do * out).sum(-1)
        got = {kernel: launch_backward_kernel(kernel, *args, do, lse, delta,
                                              causal)
               for kernel in BACKWARD}
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
        fwd_ms = time_ms(lambda: launch_forward(*args, causal, True))
        fwd_plain_ms = time_ms(lambda: rel_mha_reference(
            *args[:5], k_len=klen, causal=causal))
        rows["fwd"].append((label + " with lse", fwd_err, fwd_ms,
                            fwd_plain_ms) + bound_ms(
            4 * (5 * B * H * T * D + B * H * T + Hp * (2 * T - 1) * D + B),
            3 * 2 * D * H * valid_pairs(T, lens, causal)))
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
        pairs = H * valid_pairs(T, lens, causal)
        size = B * H * T * D
        table = Hp * (2 * T - 1) * D
        # every kernel reads q_c, q_p, k, v, do, pose, lse, delta and k_len
        # and recomputes the scores (q_c.k, q_p.pose) and dp = do.v; dq
        # adds ds.k and ds.pose, dk/dv adds p.do and ds.q_c, dpose adds
        # ds.q_p; outputs: two B x H x T x D tensors, or the table
        reads = 4 * (5 * size + table + 2 * B * H * T + B)
        bounds = {"dq": bound_ms(reads + 8 * size, 5 * 2 * D * pairs),
                  "dkv": bound_ms(reads + 8 * size, 5 * 2 * D * pairs),
                  "dpose": bound_ms(reads + 4 * table, 4 * 2 * D * pairs)}
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
            ms = time_ms(lambda: launch_backward_kernel(
                kernel, *args, do, lse, delta, causal))
            rows[kernel].append((label, err, ms, plain_ms) + bounds[kernel])
        # keys past k_len get exactly zero dk and dv
        for g in got["dkv"]:
            for b, n in enumerate(lens):
                if torch.count_nonzero(g[b, :, n:]) != 0:
                    fail(f"flash_attention_rel_dkv {label}: gradient at a "
                         f"padded key of batch entry {b}")
    return rows


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
                                             launch_backward_kernel,
                                             launch_forward, flash_attention,
                                             mha_backward_reference,
                                             mha_reference)
    H = 4
    (B_dec, T_dec, k_dec), (T_trn, lens_trn) = dec_shape, trn_shape
    rows = {name: [] for name in ("fwd", "dq", "dkv", "dbias")}
    library, backends = {}, {}
    more = {f"flash_attention_{kernel}": {} for kernel in ("dq", "dkv")}

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
            with torch.no_grad():
                lib_out = _sdpa(q, k, v, k_len)
                lib_err = (lib_out - got).abs().max().item()
                if not lib_err <= TOL_ATT:
                    fail(f"flash_attention {label}: {lib_err} from the "
                         "library's scaled_dot_product_attention")
                lib_ms = time_ms(lambda: _sdpa(q, k, v, k_len))
                if lib == "decode":
                    library["flash_attention"] = lib_ms
                    backends["forward"] = _device_kernel_names(
                        lambda: _sdpa(q, k, v, k_len))[:2]
                elif lib == "training":
                    library["flash_attention (training shape)"] = lib_ms
            print(f"flash_attention [{label}]: the library's "
                  f"scaled_dot_product_attention {lib_ms:.4f} ms, max abs "
                  f"diff from the kernel {lib_err:.3e}", flush=True)

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
            ((8, _EDGE_LENS), 65, 129, 32, False, False, "library")):
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
            tensor_ms = ops[kernel] * TF32_PASSES / PEAK_TF32_PER_S * 1e3
            if role == "path":
                library[name] = lib_ms
                backends["backward"] = _device_kernel_names(lib_bwd)[:2]
                more[name].update(
                    ms_queued=queued[kernel], library_ms_queued=lib_queued,
                    tensor_core_bound_ms=tensor_ms,
                    tensor_core_bound_note=(
                        f"operations x {TF32_PASSES} (each float32 product "
                        "is three TF32 products) over the dense TF32 peak"),
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
    search step, nothing else. -> (stats, launches)."""
    from aps_tpu_torch.cmd import decode_batch
    from aps_tpu_torch.ops import build
    best = root / "best.txt"
    argv = [str(root / "wav.scp"), str(best), "--am", str(cpt),
            "--dict", str(root / "dict")] + LONG_DECODE_ARGS
    build.reset_launches()
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
    want = {kernel: 0 for kernel in launches}
    want.update({"fused_logmel": batches,
                 "flash_attention": ENC_LAYERS * batches,
                 "ctc_score_step": launches["ctc_score_step"]})
    if launches != want or launches["ctc_score_step"] <= 0 or \
            len(stats["batch_secs"]) != batches:
        fail(f"long-form decode launches {launches} in "
             f"{len(stats['batch_secs'])} batches, expected {want} with "
             "ctc_score_step > 0")
    secs = stats["decode_secs"]
    print(f"long-form decode: {LONG_UTTS} utterances x {LONG_SECS} s "
          f"through decode_batch in {secs:.4f} s (batches of {LONG_BATCH}: "
          f"{', '.join(f'{b:.4f}' for b in stats['batch_secs'])} s) = "
          f"{stats['audio_secs'] / secs:.2f} audio-s/s, launches "
          f"{launches} ({card})", flush=True)
    return stats, launches


def _ctc_inputs(T, L, groups, dev, gen):
    """Realistic scorer operands: log-probs, monotone gammas with some
    impossible lanes, eos and repeat lanes."""
    import torch

    from aps_tpu_torch.ops.ctc_score import MIN_F32
    p_c = -1.0 - 3.0 * torch.rand((T, L), generator=gen)
    gnx = torch.cumsum(-2.0 * torch.rand((T, L), generator=gen), 0)
    gbx = torch.cumsum(-2.0 * torch.rand((T, L), generator=gen), 0)
    gnx[:, ::7] = float(MIN_F32)
    gbx[:3] = float(MIN_F32)
    p_blank = -0.05 - 0.5 * torch.rand((T, groups), generator=gen)
    repeat_ok = (torch.rand((1, L), generator=gen) > 0.1).float()
    eos_mask = (torch.rand((1, L), generator=gen) > 0.92).float()
    old = -50.0 * torch.rand((1, L), generator=gen)
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


def check_ctc(dev, gen, T, batches=(8, 64)):
    """K4 at the decode's lanes (8 utterances x beam 8 x ctc beam 12) and
    at the 64-utterance batch of the benchmark shape; for the long-form
    path at its T and its batch of 4."""
    import torch

    from aps_tpu_torch.ops.ctc_score import (ctc_score_step,
                                             ctc_score_step_plain)
    rows = []
    beam, C = 8, 12
    for utts in batches:
        L = utts * beam * C
        ops = _ctc_inputs(T, L, utts, dev, gen)
        for is_first in (True, False):
            got = ctc_score_step(*ops, is_first)
            want = ctc_score_step_plain(*ops, is_first)
            torch.cuda.synchronize()
            err, ok = _ctc_err(got, want)
            label = f"T={T} L={L} is_first={is_first}"
            ms = time_ms(lambda: ctc_score_step(*ops, is_first))
            plain_ms = time_ms(lambda: ctc_score_step_plain(*ops, is_first),
                               iters=5, warmup=1)
            # reads p_c and the two gammas, writes the two new gammas
            # (T x L each), the blank column and five lane rows; two
            # logaddexp of about eight operations per frame and lane
            bound = bound_ms(4 * (5 * T * L + T * utts + 5 * L),
                             16 * T * L)
            rows.append((label, err, ms, plain_ms) + bound)
            if not ok:
                fail(f"ctc_score_step {label}: outside |d| <= {TOL_CTC_ABS} "
                     f"+ {TOL_CTC_REL} |x| (max abs err {err})")
    return rows


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
    return launches, per_step


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


def step_check(egs, dev, gen, shapes, name="flagship"):
    """One training-mode pass of asr@ctc_xent over the batch with every
    dropout off, on the card (kernels) and on the CPU (their plain
    versions), same seeded weights: the loss and the gradients named in
    STEP_GRADS must agree, and the front end and the encoder must run at
    the shapes their kernels were checked at."""
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
    outs = {}
    for where in ("cpu", dev):
        side = copy.deepcopy(task).to(where).train()
        seen = []
        side.nnet.encoder.register_forward_hook(
            lambda mod, args, out: seen.append(
                (out[0].shape[1], out[1].tolist())))
        wavs = []
        side.nnet.asr_transform.register_forward_hook(
            lambda mod, args, out: wavs.append(tuple(args[0].shape)))
        stats = side(to_device(tensors, torch.device(where)))
        stats["loss"].backward()
        if seen != [(T, k_len)] or wavs != [(utts, S)]:
            fail(f"on {where} the front end ran at {wavs} and the encoder "
                 f"at {seen}; the kernels were checked at {utts} x "
                 f"{S} samples, T = {T}, k_len = {k_len}")
        params = dict(side.nnet.named_parameters())
        outs[str(where)] = (stats["loss"].item(),
                            {k: params[k].grad.cpu() for k in grads})
    (loss_c, grad_c), (loss_g, grad_g) = outs["cpu"], outs[str(dev)]
    if not (math.isfinite(loss_g) and
            abs(loss_g - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
        fail(f"training loss card {loss_g} vs CPU {loss_c}: outside "
             f"{TOL_STEP_LOSS} relative")
    errs = {}
    for key in grads:
        scale = grad_c[key].abs().max().item()
        errs[key] = (grad_g[key] - grad_c[key]).abs().max().item() / scale
        if not (scale > 0 and errs[key] <= TOL_STEP_GRAD):
            fail(f"gradient of {key} card vs CPU: {errs[key]} of its "
                 f"largest entry {scale}, over {TOL_STEP_GRAD}")
    return loss_g, loss_c, errs


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
    eight rows, whose times add up to a quarter of a forward), causal at the
    largest, a T shorter than twice the dilation, and bfloat16."""
    import torch

    from aps_tpu_torch.ops.tcn import tcn_block_fused, tcn_block_reference
    f32, bf16 = torch.float32, torch.bfloat16
    B, H = TCN_CONF["B"], TCN_CONF["H"]
    cases = [(T, 2**n, False, f32) for n in range(TCN_CONF["X"])]
    cases += [(T, 128, True, f32), (100, 128, False, f32),
              (100, 64, True, f32), (T, 16, False, bf16),
              (T, 128, True, bf16)]
    rows = []
    args, made = None, None
    for Tc, d, causal, dtype in cases:
        if made != (Tc, dtype):
            args, made = _tcn_inputs(SEP_BATCH, Tc, dtype, dev, gen), \
                (Tc, dtype)
        got = tcn_block_fused(*args, d, causal=causal)
        want = tcn_block_reference(*args, d, causal=causal)
        torch.cuda.synchronize()
        label = (f"N={SEP_BATCH} T={Tc} B={B} H={H} dilation={d} "
                 f"causal={causal} {str(dtype).split('.')[1]}")
        if got.dtype != dtype or not torch.isfinite(got).all():
            fail(f"tcn_block_fused {label}: wrong type or non-finite output")
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
        bound = bound_ms(
            2 * SEP_BATCH * Tc * B * size + 2 * B * H * size +
            4 * (11 * H + B), 2 * SEP_BATCH * Tc * 2 * B * H,
            peak=PEAK_FP32_PER_S if dtype == f32 else PEAK_BF16_PER_S)
        rows.append((label, err, ms, plain_ms) + bound)
    return rows


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


def write_mixtures(root: Path, count: int, gen):
    """count seeded two-speaker mixtures of SEP_SECS at SEP_SR (two
    modulated tones and a little noise) as 16-bit files, with their sources:
    root/{mix,spk1,spk2}.scp -> {key: mixture samples as the readers give
    them back}."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    S = SEP_SECS * SEP_SR
    t = np.arange(S) / SEP_SR
    mixes = {}
    scps = {name: open(root / f"{name}.scp", "w")
            for name in ("mix", "spk1", "spk2")}
    for n in range(count):
        noise = torch.randn(S, generator=gen).numpy()
        a = 0.2 * np.sin(2 * np.pi * (180.0 + 7.0 * n) * t) * \
            (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
        b = 0.2 * np.sin(2 * np.pi * (520.0 + 11.0 * n) * t) * \
            (0.5 + 0.5 * np.cos(2 * np.pi * 0.9 * t)) + 0.01 * noise
        for name, sig in (("mix", a + b), ("spk1", a), ("spk2", b)):
            pcm = np.clip(np.round(sig * 32768), -32768, 32767).astype(
                np.int16)
            path = root / f"{name}{n:02d}.wav"
            wavfile.write(str(path), SEP_SR, pcm)
            scps[name].write(f"mix{n:02d}\t{path}\n")
            if name == "mix":
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
    mixtures of the batch, same seeded weights: in float32 on the CPU and on
    the card, and in float64 on the card as the referee. The losses must
    agree; each gradient named in SEP_GRADS is held to the float64 one (see
    TOL_SEP_GRAD_*)."""
    import torch

    from aps_tpu_torch.libs import aps_sse_nnet, aps_task
    from aps_tpu_torch.trainer.dp import to_device
    torch.manual_seed(SEED)
    task = aps_task("sse@sisnr", aps_sse_nnet("sse@time_tcn")(**TCN_CONF),
                    num_spks=2, permute=True)
    tensors = {"mix": egs["mix"][:SEP_CHECK_UTTS],
               "ref": [r[:SEP_CHECK_UTTS] for r in egs["ref"]]}
    outs = {}
    for name, where, dtype in (("cpu32", "cpu", torch.float32),
                               ("card32", dev, torch.float32),
                               ("card64", dev, torch.float64)):
        side = copy.deepcopy(task).to(where, dtype).train()
        batch = to_device(tensors, torch.device(where))
        batch = {"mix": batch["mix"].to(dtype),
                 "ref": [r.to(dtype) for r in batch["ref"]]}
        stats = side(batch)
        stats["loss"].backward()
        params = dict(side.nnet.named_parameters())
        outs[name] = (stats["loss"].item(),
                      {k: params[k].grad.double().cpu() for k in SEP_GRADS})
    loss_c, loss_g, loss_ref = (outs[k][0] for k in ("cpu32", "card32",
                                                     "card64"))
    for loss in (loss_g, loss_ref):
        if not (math.isfinite(loss) and
                abs(loss - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
            fail(f"sse@sisnr loss: card {loss_g} (float64 {loss_ref}) vs CPU "
                 f"{loss_c}: outside {TOL_STEP_LOSS} relative")
    errs = {}
    for key in SEP_GRADS:
        ref = outs["card64"][1][key]
        scale = ref.abs().max().item()
        rel = lambda name: ((outs[name][1][key] - ref).abs().max().item()  # noqa
                            / scale)
        noise_cpu, noise_card = rel("cpu32"), rel("card32")
        errs[key] = (noise_card, noise_cpu)
        if not (scale > 0 and noise_cpu <= TOL_SEP_GRAD_REFEREE):
            fail(f"gradient of {key}: the CPU's float32 pass is {noise_cpu} "
                 f"of the largest entry {scale} from the card's float64 "
                 f"pass, over {TOL_SEP_GRAD_REFEREE}")
        bound = TOL_STEP_GRAD + TOL_SEP_GRAD_NOISE * noise_cpu
        if not noise_card <= bound:
            fail(f"gradient of {key}: the card's float32 pass is "
                 f"{noise_card} of the largest entry from the float64 pass, "
                 f"over {bound} (the CPU's float32 pass: {noise_cpu})")
    return loss_g, loss_c, errs


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

    beg = time.perf_counter()
    for name, secs in build.build_all().items():
        print(f"built {name}.cu in {secs:.1f} s", flush=True)
    print(f"all kernels built in {time.perf_counter() - beg:.1f} s (one "
          "nvcc per source, started together)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
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
        checks = {
            "fused_logmel": check_fbank(dev, model, (
                ("decode", decode_batch_of(wavs, 8, S)),
                ("training", egs["src_pad"]),
                ("long-form decode",
                 decode_batch_of(wavs_long, LONG_BATCH, S_long)),
                ("long-form training", egs_long["src_pad"]))),
            "flash_attention_rel": check_rel_attention(dev, gen, T, k_len),
            "ctc_score_step": check_ctc(dev, gen, T) + check_ctc(
                dev, gen, T_long, batches=(LONG_BATCH,)),
        }
        bwd = check_rel_attention_bwd(dev, gen, T_trn, k_trn)
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
        del model, model_long
        for name, rows in checks.items():
            print_rows(name, rows, card)
        print("the plain time beside a backward kernel is that of the whole "
              "plain backward, which gives all of its gradients", flush=True)

        best = root / "best.txt"
        argv = [str(root / "wav.scp"), str(best), "--am", str(cpt),
                "--dict", str(root / "dict")] + DECODE_ARGS
        build.reset_launches()
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
        secs = stats["decode_secs"]
        batches = ", ".join(f"{b:.4f}" for b in stats["batch_secs"])
        print(f"decode: {NUM_UTTS} utterances x {UTT_SECS} s through "
              f"decode_batch in {secs:.4f} s (batches of 8: {batches} s) = "
              f"{stats['audio_secs'] / secs:.2f} audio-s/s, launches "
              f"{launches} ({card})", flush=True)
        enc_err, score_err = reference_check(cpt, wavs, dev, stats, shapes)
        print(f"card vs CPU on 2 utterances: encoder max abs err "
              f"{enc_err:.3e}, best-score diff {score_err:.3e}", flush=True)

        dropout_step(egs, dev, gen, card)
        launches_trn, per_step = train_phase(root, train, egs, dev, card)
        loss_g, loss_c, errs = step_check(egs, dev, gen, shapes_trn)
        print(f"training pass card vs CPU, dropouts off: loss {loss_g:.6f} "
              f"vs {loss_c:.6f}; gradient errors relative to the largest "
              "entry " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)

        # the long-form path: decode, card vs CPU, training, card vs CPU
        stats_long, launches_long = long_decode_phase(long_root, cpt_long,
                                                      wavs_long, card)
        enc_err, score_err = reference_check(cpt_long, wavs_long, dev,
                                             stats_long, shapes_long)
        print(f"long-form card vs CPU on {LONG_CHECK_UTTS} utterances: "
              f"encoder max abs err {enc_err:.3e}, best-score diff "
              f"{score_err:.3e}", flush=True)
        launches_ltr, per_step_long = train_phase(
            long_root, train_long, egs_long, dev, card, "xfmr_abs",
            LONG_TRAIN_UTTS, LONG_SECS, LONG_TIMED_STEPS,
            LONG_TRAIN_BATCHES)
        loss_g, loss_c, errs = step_check(egs_long, dev, gen, shapes_ltr,
                                          "xfmr_abs")
        print(f"long-form training pass card vs CPU, dropouts off: loss "
              f"{loss_g:.6f} vs {loss_c:.6f}; gradient errors relative to "
              "the largest entry "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)

        # the separation path: its kernel, the separate command, the
        # train_ss command
        sep_root = root / "separation"
        sep_root.mkdir()
        shapes_sep = S_sep, T_sep = sep_shapes()
        print(f"separation path: batches of {SEP_BATCH} x {S_sep} samples, "
              f"{TCN_BLOCKS} TCN blocks at T = {T_sep} frames x "
              f"{TCN_CONF['B']} channels", flush=True)
        checks["tcn_block_fused"] = check_tcn(dev, gen, T_sep)
        print_rows("tcn_block_fused", checks["tcn_block_fused"], card)
        tcn_cpt = write_tcn_checkpoint(sep_root, gen)
        mixes = write_mixtures(sep_root, SEP_UTTS, gen)
        launches_sep = separate_phase(sep_root, tcn_cpt, mixes, shapes_sep,
                                      card)
        separation_check(tcn_cpt, mixes, dev, shapes_sep, card)
        train_ss = write_sep_corpus(sep_root, gen)
        egs_ss, launches_ss = train_ss_phase(train_ss, dev, card)
        loss_g, loss_c, errs = sep_step_check(egs_ss, dev)
        print(f"sse@sisnr training pass card vs CPU on {SEP_CHECK_UTTS} "
              f"mixtures: loss {loss_g:.6f} vs {loss_c:.6f}; distance of "
              "the float32 gradients (card, CPU) from the card's float64 "
              "gradient, relative to the largest entry: "
              + ", ".join(f"{k} {a:.3e}, {b:.3e}"
                          for k, (a, b) in errs.items()), flush=True)

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
        elif name.startswith("flash_attention_d"):
            path_launches = launches_ltr[name]
            if name == "flash_attention_dbias":
                extra["why_no_launches"] = (
                    "no model passes a bias (nor does any caller in "
                    "aps_tpu): the kernel is held against its plain "
                    "versions only")
            else:
                extra["library_ms_covers"] = (
                    "dq, dk and dv together (one backward through the "
                    "library call)")
                extra.update(more[name])
        elif name == "tcn_block_fused":
            path_launches = launches_sep[name]
            # one forward runs each of the first X rows' dilations R times
            path = rows[:TCN_CONF["X"]]
            extra = {"forward_ms": TCN_CONF["R"] * sum(r[2] for r in path),
                     "forward_plain_ms": TCN_CONF["R"] * sum(
                         r[3] for r in path),
                     "launches_per_batch": TCN_BLOCKS,
                     "max_abs_err_bfloat16": max(
                         r[1] for r in rows if "bfloat16" in r[0])}
        else:
            path_launches = launches_trn[name]
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
            "max_abs_err": max(r[1] for r in rows
                               if "bfloat16" not in r[0]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            # one PyTorch call, scaled_dot_product_attention, computes the
            # scaled-dot-product attention's forward without a bias, and
            # autograd through it dq, dk and dv together: timed in
            # check_attention and used nowhere in the port. No single call
            # computes any other of these functions: the relative term is
            # formed inside the rel attention kernels, a bias gradient
            # summed over the batch has no call of its own, the front end
            # is a chain of calls, the scorer a loop over frames, the TCN
            # block two products around a stencil
            "library_ms": library.get(name),
            **extra,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
