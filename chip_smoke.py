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

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed."""

import contextlib
import copy
import json
import math
import pickle
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
# published peaks of one H100 SXM at its full 700 W: device memory and
# float32 outside the tensor cores (every kernel here computes in float32
# on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

KERNELS = {
    "fused_logmel": ("aps_tpu_torch/csrc/fbank.cu",
                     "aps_tpu/ops/pallas/fbank.py:72"),
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
}
# the path each kernel's first check row (and its `launches`) belongs to
DECODE_KERNELS = ("fused_logmel", "flash_attention_rel", "ctc_score_step")
# kernels on both paths: the check row taken at the training step's shape
TRAIN_ROW = {"fused_logmel": 1, "flash_attention_rel": 4}
BACKWARD = ("dq", "dkv", "dpose")
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
TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-4, 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms over iters timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        beg = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        beg.record()
        fn()
        end.record()
        end.synchronize()
        times.append(beg.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes and do flops float32 operations, at its published
    peaks."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def path_shapes(model):
    """(S, T, k_len) of a batch of UTT_SECS utterances in decode_batch:
    samples per utterance after padding to the duration bucket, encoder
    (and CTC) frames of that padded batch, and the valid frames of each."""
    import torch

    from aps_tpu_torch.cmd.decode_batch import quantize_dur
    S = quantize_dur(UTT_SECS * SR, base=SR)
    frames = model.asr_transform._num_frames(torch.tensor([S, UTT_SECS * SR]))
    T, k_len = model.encoder.num_frames(frames).tolist()
    return S, T, k_len


def check_fbank(dev, model, wavs, S, src_pad):
    """K1 with the front end's own arguments on the decode's first batch,
    padded as decode_batch pads it, and on the training batch as the loader
    collates it (another grid size and frame count)."""
    import torch

    from aps_tpu_torch.ops.fbank import fused_logmel, fused_logmel_plain
    tf = model.asr_transform
    wav = torch.zeros((8, S))
    for n, key in enumerate(sorted(wavs)[:8]):
        wav[n, :len(wavs[key])] = torch.from_numpy(wavs[key])
    kw = dict(mel=tf.mel, pre_emphasis=tf.pre_emphasis,
              normalized=tf.stft_normalized, use_power=tf.use_power,
              log_lower_bound=tf.log_lower_bound, log_eps=tf.eps)
    rows = []
    for path, wav in (("decode", wav), ("training", torch.as_tensor(src_pad))):
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


def valid_pairs(T, lens, causal):
    """Number of (query l, key s) pairs the mask leaves, summed over the
    batch: s < k_len[b], and s <= l under causal."""
    total = 0
    for n in lens:
        n = min(int(n), T)
        total += n * (n + 1) // 2 + (T - n) * n if causal else T * n
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


def check_ctc(dev, gen, T):
    """K4 at the decode's lanes (8 utterances x beam 8 x ctc beam 12) and
    at the 64-utterance batch of the benchmark shape."""
    import torch

    from aps_tpu_torch.ops.ctc_score import (ctc_score_step,
                                             ctc_score_step_plain)
    rows = []
    beam, C = 8, 12
    for utts in (8, 64):
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


def write_wavs(root: Path, prefix: str, count: int, gen):
    """count seeded UTT_SECS waveforms (noise under a modulated tone) as
    16-bit files root/<prefix>NN.wav and root/wav.scp -> {key: samples as
    the readers give them back}."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    wavs = {}
    t = np.arange(UTT_SECS * SR) / SR
    with open(root / "wav.scp", "w") as scp:
        for n in range(count):
            noise = torch.randn(UTT_SECS * SR, generator=gen).numpy()
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


def write_checkpoint(root: Path, gen):
    """Full-width flagship with seeded weights -> an aps_tpu checkpoint
    directory, a wav.scp of NUM_UTTS waveforms and a dict."""
    import torch

    from aps_tpu_torch.convert import to_variables
    from aps_tpu_torch.flagship import (build_flagship, flagship_conf,
                                        init_weights)
    conf = flagship_conf(vocab_size=VOCAB, small=False)
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
    wavs = write_wavs(root, "utt", NUM_UTTS, gen)
    return cpt, wavs, model


def write_corpus(root: Path, gen) -> Path:
    """root/train: TRAIN_UTTS waveforms of UTT_SECS with TRAIN_LABELS seeded
    labels each (wav.scp, text, utt2dur) and the train.yaml of the
    full-width flagship under asr@ctc_xent. The encoder's attention dropout
    is 0, as the rel-pose kernel needs in training; the other dropouts keep
    their 0.1."""
    import torch

    from aps_tpu_torch.flagship import flagship_train_conf
    train = root / "train"
    train.mkdir()
    keys = sorted(write_wavs(train, "trn", TRAIN_UTTS, gen))
    labels = torch.randint(1, VOCAB - 3, (TRAIN_UTTS, TRAIN_LABELS),
                           generator=gen).tolist()
    with open(train / "text", "w") as text, \
            open(train / "utt2dur", "w") as dur:
        for key, toks in zip(keys, labels):
            text.write(f"{key} {' '.join(f't{i}' for i in toks)}\n")
            dur.write(f"{key} {UTT_SECS:.2f}\n")
    conf = flagship_train_conf(VOCAB)
    for key in ("vocab_size", "sos", "eos", "ctc"):
        conf["nnet_conf"].pop(key)  # load_am_conf takes them from the dict
    data = {name: str(train / name) for name in ("text", "utt2dur")}
    data["wav_scp"] = str(train / "wav.scp")
    conf.update(
        # 8 s utterances fill the whole batch size (adaptive batching
        # halves it from adapt_dur seconds on)
        data_conf={"fmt": "am@raw",
                   "loader": {"adapt_dur": UTT_SECS + 2, "tokenizer": "word"},
                   "train": data, "valid": data})
    (train / "train.yaml").write_text(json.dumps(conf, indent=2))
    return train


def first_batch(root: Path, train: Path):
    """The one batch of the corpus as the trainer's loader collates it."""
    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.libs import aps_dataloader
    conf, vocab = load_am_conf(str(train / "train.yaml"), str(root / "dict"))
    data_conf = conf["data_conf"]
    loader = aps_dataloader(fmt=data_conf["fmt"], train=False,
                            vocab_dict=vocab, max_batch_size=TRAIN_UTTS,
                            **data_conf["loader"], **data_conf["valid"])
    batches = list(loader)
    if len(batches) != 1 or batches[0]["src_pad"].shape[0] != TRAIN_UTTS:
        fail(f"expected one batch of {TRAIN_UTTS} utterances, got "
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
    return [float(line.split(") = ")[1].split("/")[0])
            for line in log.read_text().splitlines() if f"/{mode}:" in line]


def train_phase(root: Path, train: Path, egs, dev, card):
    """TRAIN_EPOCHS one-step epochs through aps_tpu_torch.cmd.train_am with
    the launch counts read over the whole run, then TIMED_STEPS more steps
    of the same trainer on the same batch, each timed and counted alone.
    -> (launches of the run, launches of one step)."""
    import torch

    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.ops import build
    cpt = train / "cpt"
    argv = ["--conf", str(train / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(cpt), "--batch-size", str(TRAIN_UTTS),
            "--epochs", str(TRAIN_EPOCHS), "--seed", str(SEED)]
    build.reset_launches()
    # the command prints its arguments and configuration: to stderr here,
    # so that every "{" line of this script's stdout is one of its own
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_am.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if trainer.device.type != "cuda" or trainer.cur_step != TRAIN_EPOCHS:
        fail(f"train_am took {trainer.cur_step} steps on {trainer.device}")
    # every epoch is one training pass, and a validation pass (forward
    # only) runs before the first and after each
    passes = 2 * TRAIN_EPOCHS + 1
    want = {"fused_logmel": passes,
            "flash_attention_rel": ENC_LAYERS * passes,
            "ctc_score_step": 0}
    want.update({f"flash_attention_rel_{k}": ENC_LAYERS * TRAIN_EPOCHS
                 for k in BACKWARD})
    if launches != want:
        fail(f"train_am launches {launches}, expected {want}")
    losses = _epoch_losses(cpt / "trainer.log", "train")
    valid = _epoch_losses(cpt / "trainer.log", "valid")
    if len(losses) != TRAIN_EPOCHS or len(valid) != TRAIN_EPOCHS + 1:
        fail(f"trainer.log reports {len(losses)} training and {len(valid)} "
             "validation epochs")
    for name in ("best.ckpt", "last.ckpt", "train.yaml", "dict"):
        if not (cpt / name).is_file():
            fail(f"train_am wrote no {name}")

    per_step = {"fused_logmel": 1, "flash_attention_rel": ENC_LAYERS,
                "ctc_score_step": 0}
    per_step.update({f"flash_attention_rel_{k}": ENC_LAYERS
                     for k in BACKWARD})
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
        if dict(build.LAUNCHES) != per_step:
            fail(f"timed step {step} launches {dict(build.LAUNCHES)}, "
                 f"expected {per_step}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses += [float(v) for v in trainer.reporter.stats["loss"]]
    if not all(map(math.isfinite, losses + valid)):
        fail(f"non-finite loss: training {losses}, validation {valid}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the repeated batch: {losses}")
    print(f"train: {TRAIN_UTTS} x {UTT_SECS} s, {TRAIN_LABELS} labels each, "
          f"asr@ctc_xent through train_am: {TRAIN_EPOCHS} one-step epochs, "
          f"launches {launches}; then {TIMED_STEPS} timed steps, launches "
          f"per step {per_step}; training losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; validation losses "
          f"{', '.join(f'{v:.4f}' for v in valid)}", flush=True)
    print(f"train step: median {statistics.median(secs):.4f} s of "
          f"{', '.join(f'{v:.4f}' for v in secs)} s (host clock around a "
          f"synchronised step), peak memory {peak:.3f} GiB ({card})",
          flush=True)
    return launches, per_step


STEP_GRADS = ("encoder.pose_layer.embed.weight",
              "encoder.encoder.layers.0.self_attn.in_proj.weight",
              "ctc_head.weight")


def step_check(egs, dev, gen, shapes):
    """One training-mode pass of asr@ctc_xent over the batch with every
    dropout off, on the card (kernels) and on the CPU (their plain
    versions), same seeded weights: the loss and the gradients named in
    STEP_GRADS must agree, and the front end and the encoder must run at
    the shapes their kernels were checked at."""
    import torch

    from aps_tpu_torch.flagship import (build_flagship, flagship_train_conf,
                                        init_weights)
    from aps_tpu_torch.libs import aps_task
    from aps_tpu_torch.trainer.dp import to_device
    S, T, k_len = shapes
    conf = flagship_train_conf(VOCAB)
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
        if seen != [(T, k_len)] or wavs != [(TRAIN_UTTS, S)]:
            fail(f"on {where} the front end ran at {wavs} and the encoder "
                 f"at {seen}; the kernels were checked at {TRAIN_UTTS} x "
                 f"{S} samples, T = {T}, k_len = {k_len}")
        params = dict(side.nnet.named_parameters())
        outs[str(where)] = (stats["loss"].item(),
                            {k: params[k].grad.cpu() for k in STEP_GRADS})
    (loss_c, grad_c), (loss_g, grad_g) = outs["cpu"], outs[str(dev)]
    if not (math.isfinite(loss_g) and
            abs(loss_g - loss_c) <= TOL_STEP_LOSS * abs(loss_c)):
        fail(f"training loss card {loss_g} vs CPU {loss_c}: outside "
             f"{TOL_STEP_LOSS} relative")
    errs = {}
    for key in STEP_GRADS:
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
        checks = {
            "fused_logmel": check_fbank(dev, model, wavs, S, egs["src_pad"]),
            "flash_attention_rel": check_rel_attention(dev, gen, T, k_len),
            "ctc_score_step": check_ctc(dev, gen, T),
        }
        bwd = check_rel_attention_bwd(dev, gen, T_trn, k_trn)
        checks["flash_attention_rel"] += bwd.pop("fwd")
        for kernel, rows in bwd.items():
            checks[f"flash_attention_rel_{kernel}"] = rows
        del model
        for name, rows in checks.items():
            for label, err, ms, plain_ms, bound, bound_by in rows:
                print(f"{name} [{label}]: max abs err {err:.3e}, kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound:.5f} ms by {bound_by} ({card})", flush=True)
        print("the plain time beside a backward kernel is that of the whole "
              "plain backward, which gives all five gradients", flush=True)

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

        launches_trn, per_step = train_phase(root, train, egs, dev, card)
        loss_g, loss_c, errs = step_check(egs, dev, gen, shapes_trn)
        print(f"training pass card vs CPU, dropouts off: loss {loss_g:.6f} "
              f"vs {loss_c:.6f}; gradient errors relative to the largest "
              "entry " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)

    kernels = []
    for name, rows in checks.items():
        source, replaces = KERNELS[name]
        _, _, ms, plain_ms, bound, bound_by = rows[0]
        at_train = {}
        if name in TRAIN_ROW:
            row = rows[TRAIN_ROW[name]]
            at_train = {"train_shape": row[0], "train_ms": row[2],
                        "train_plain_ms": row[3], "train_bound_ms": row[4]}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # of the path whose shape the first row was checked at; both
            # paths' counts follow
            "launches": (launches if name in DECODE_KERNELS
                         else launches_trn)[name],
            "launches_decode": launches[name],
            "launches_train_run": launches_trn[name],
            "launches_train_step": per_step[name],
            "max_abs_err": max(r[1] for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            # no single PyTorch call computes any of these functions: the
            # relative term is formed inside the attention kernels, the
            # front end is a chain of calls, the scorer a loop over frames
            "library_ms": None,
            **at_train,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
