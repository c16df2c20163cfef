#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aps_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and the torch/CUDA
   versions; exits non-zero when torch sees no CUDA device.
2. Builds the port's CUDA kernels from aps_tpu_torch/csrc with nvcc.
3. Builds the full-width flagship (12 conformer layers of width 256, 6
   decoder layers, vocab 4233) from a seeded torch.Generator and writes it
   as an aps_tpu checkpoint (train.yaml + best.ckpt) with a wav.scp of 16
   seeded 8 s waveforms and a dict into a temporary directory.
4. Holds each kernel against its plain PyTorch version at the shapes the
   decode gives it (TF32 off for matmuls and cuDNN) and prints the max abs
   error and the median times of both. decode_batch pads each 8 s
   utterance to its duration bucket, so the front end sees N = 8 x
   149003 samples and the encoder and CTC scorer T = 233 frames of which
   200 are valid; a few other shapes widen the check.
5. Decodes them through `aps_tpu_torch.cmd.decode_batch` (batch 8, beam 8,
   ctc weight 0.4, max_len 40), with every kernel's launch count reset just
   before and read just after; each kernel must have launched.
6. Checks 16 transcripts with finite scores, and holds the card's encoder
   output (which must have the shapes the kernels were checked at) and
   best hypotheses for two utterances against the same model on the CPU
   (plain versions of every kernel).

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed."""

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

KERNELS = {
    "fused_logmel": ("aps_tpu_torch/csrc/fbank.cu",
                     "aps_tpu/ops/pallas/fbank.py:72"),
    "flash_attention_rel": ("aps_tpu_torch/csrc/rel_attention.cu",
                            "aps_tpu/ops/pallas/rel_attention.py:512"),
    "ctc_score_step": ("aps_tpu_torch/csrc/ctc_score.cu",
                       "aps_tpu/ops/pallas/ctc_score.py:231"),
}
# tolerances of kernel vs plain version, both float32 on the card:
# log-mel: 512-term DFT sums in another order, then a log (the JAX package's
#   own fused-vs-layered bound);
# attention: O(1) outputs, D = 64 dot products and online vs two-pass
#   softmax in another order;
# CTC: values grow to ~1e3 over T = 233 steps of the same sequential
#   recursion; relative term for the large ones, entries at or below
#   MIN_F32 / 2 compare as "both impossible".
TOL_LOGMEL = 1e-3
TOL_ATT = 1e-3
TOL_CTC_ABS, TOL_CTC_REL = 1e-3, 1e-5


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


def check_fbank(dev, model, wavs, S):
    """K1 on the decode's first batch, padded as decode_batch pads it, with
    the front end's own arguments."""
    import torch

    from aps_tpu_torch.ops.fbank import fused_logmel, fused_logmel_plain
    tf = model.asr_transform
    wav = torch.zeros((8, S))
    for n, key in enumerate(sorted(wavs)[:8]):
        wav[n, :len(wavs[key])] = torch.from_numpy(wavs[key])
    args = (wav.to(dev), tf.window, tf.fft_size, tf.frame_hop)
    kw = dict(mel=tf.mel, pre_emphasis=tf.pre_emphasis,
              normalized=tf.stft_normalized, use_power=tf.use_power,
              log_lower_bound=tf.log_lower_bound, log_eps=tf.eps)
    label = f"N=8 S={S} M={tf.feats_dim}"
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
    return [(label, err, ms, plain_ms)]


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
        rows.append((label, err, ms, plain_ms))
        if not err <= TOL_ATT:
            fail(f"flash_attention_rel {label}: max abs err {err} > "
                 f"{TOL_ATT}")
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
            rows.append((label, err, ms, plain_ms))
            if not ok:
                fail(f"ctc_score_step {label}: outside |d| <= {TOL_CTC_ABS} "
                     f"+ {TOL_CTC_REL} |x| (max abs err {err})")
    return rows


def write_checkpoint(root: Path, gen):
    """Full-width flagship with seeded weights -> an aps_tpu checkpoint
    directory, a wav.scp of NUM_UTTS waveforms and a dict."""
    import numpy as np
    import torch
    from scipy.io import wavfile

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
    wavs = {}
    t = np.arange(UTT_SECS * SR) / SR
    with open(root / "wav.scp", "w") as scp:
        for n in range(NUM_UTTS):
            noise = torch.randn(UTT_SECS * SR, generator=gen).numpy()
            f0 = 150.0 + 20.0 * n
            wav = 0.05 * noise + 0.2 * np.sin(2 * np.pi * f0 * t) * \
                (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
            # 16-bit PCM; the decoder reads it back as pcm / 32768
            pcm = np.clip(np.round(wav * 32768), -32768, 32767).astype(
                np.int16)
            path = root / f"utt{n:02d}.wav"
            wavfile.write(str(path), SR, pcm)
            scp.write(f"utt{n:02d}\t{path}\n")
            wavs[f"utt{n:02d}"] = pcm.astype(np.float32) / 32768
    return cpt, wavs, model


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

    for name in ("fbank", "rel_attention", "ctc_score"):
        beg = time.perf_counter()
        lib = build.build(name)
        print(f"built {lib.name} in {time.perf_counter() - beg:.1f} s",
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cpt, wavs, model = write_checkpoint(root, gen)
        shapes = S, T, k_len = path_shapes(model)
        print(f"decode path: batches of 8 x {S} samples, encoder T = {T} "
              f"with {k_len} valid frames", flush=True)
        checks = {
            "fused_logmel": check_fbank(dev, model, wavs, S),
            "flash_attention_rel": check_rel_attention(dev, gen, T, k_len),
            "ctc_score_step": check_ctc(dev, gen, T),
        }
        del model
        for name, rows in checks.items():
            for label, err, ms, plain_ms in rows:
                print(f"{name} [{label}]: max abs err {err:.3e}, kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({card})",
                      flush=True)

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
        for name, count in launches.items():
            if count <= 0:
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

    kernels = []
    for name, rows in checks.items():
        source, replaces = KERNELS[name]
        label, _, ms, plain_ms = rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r[1] for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
