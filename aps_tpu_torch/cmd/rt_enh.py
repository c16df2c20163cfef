#!/usr/bin/env python
"""Real-time enhancement, frame by frame (port of
demos/real_time_enhancement/python/rt_enh_dfsmn.py and
rt_enh_transformer.py, one command for both models).

    python -m aps_tpu_torch.cmd.rt_enh <noisy.wav> <enhan.wav>
        --checkpoint <dir> [--tag best] [--sr 16000]
        [--device cuda|cpu] [--device-id -1]

Takes the demos' arguments and loop: the streaming STFT a frame at a time,
its log magnitude (floored at 1.19e-7) as the frame's features, a context
block through the model's mask_predict, the mask of the block's current
frame on the frame's spectrum, the streaming iSTFT; prints the real-time
factor. The model comes from the checkpoint: rt_sse@dfsmn takes blocks of
num_layers x lctx frames before the current one and num_layers x rctx
after it (the first frame repeated on the left; the last frames, which
have no right context, are not output), rt_sse@freq_xfmr the current frame
and the lctx x chunk frames before it. Runs on the card by default
(raises without one); --device cpu asks for the CPU."""

import argparse
import time

import numpy as np
import torch

from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.io import read_audio, write_audio
from aps_tpu_torch.opts import add_device_args
from aps_tpu_torch.transform.streaming import StreamingiSTFT, StreamingSTFT
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision


def context(conf: dict):
    """(frames before, frames after) the current one in a block, and the
    index of the current one in the mask mask_predict gives back."""
    nnet_conf = conf["nnet_conf"]
    if conf["nnet"] == "rt_sse@dfsmn":
        layers = nnet_conf.get("num_layers", 4)
        lctx = layers * nnet_conf.get("lctx", 3)
        return lctx, layers * nnet_conf.get("rctx", 3), lctx
    if conf["nnet"] == "rt_sse@freq_xfmr":
        lctx = nnet_conf.get("lctx", 3) * nnet_conf.get("chunk", 1)
        return lctx, 0, -1
    raise ValueError(f"rt_enh runs rt_sse@dfsmn or rt_sse@freq_xfmr, not "
                     f"{conf['nnet']}")


def run(args) -> np.ndarray:
    """-> the enhanced samples written."""
    evaluator = NnetEvaluator(args.checkpoint, cpt_tag=args.tag,
                              device=args.device, device_id=args.device_id)
    dev, conf = evaluator.device, evaluator.conf
    enh = conf["enh_transform"]
    window = enh.get("window", "sqrthann")
    complex_mask = conf["nnet_conf"].get("complex_mask", True)
    lctx, rctx, center = context(conf)
    stft = StreamingSTFT(enh["frame_len"], enh["frame_hop"], window=window)
    istft = StreamingiSTFT(enh["frame_len"], enh["frame_hop"],
                           window=window)
    mix = read_audio(args.noisy, sr=args.sr)
    total, hop = mix.shape[-1], enh["frame_hop"]
    frames = [mix[beg:beg + stft.win_length]
              for beg in range(0, total - stft.win_length + 1, hop)]
    out = []
    start = time.time()
    with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION, dev):
        specs = [stft.step(torch.from_numpy(f).to(dev)[None])[0]
                 for f in frames]
        feats = [torch.log(torch.clamp_min(s.abs(), 1.19e-7)) for s in specs]
        state = istft.init_state(1, dev)
        for t in range(len(frames) - rctx):
            block = [feats[max(0, t - lctx + i)] for i in range(lctx)]
            block += [feats[t + i] for i in range(1 + rctx)]
            mask = evaluator.nnet.mask_predict(torch.stack(block)[None])[0]
            m = mask[min(center, mask.shape[0] - 1)] if center >= 0 \
                else mask[center]
            if complex_mask:
                m = torch.complex(m[..., 0], m[..., 1])
            state, frame = istft.step(state, (specs[t] * m)[None])
            out.append(frame[0])
        out.append(istft.flush(state)[0])
        enhanced = torch.cat(out).cpu().numpy()
    cost = time.time() - start
    write_audio(args.enhan, enhanced, sr=args.sr)
    dur = total / args.sr
    print(f"Processed {dur:.2f}s audio in {cost:.2f}s, "
          f"RTF = {cost / dur:.4f}", flush=True)
    return enhanced


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Real-time enhancement, frame by frame (PyTorch port)")
    parser.add_argument("noisy", help="input noisy wav")
    parser.add_argument("enhan", help="output enhanced wav")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--tag", default="best")
    parser.add_argument("--sr", type=int, default=16000)
    add_device_args(parser)
    return parser


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
