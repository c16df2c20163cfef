#!/usr/bin/env python
"""Where the chime4 1b training pass's float32 spread comes from: the
pass at CHIME4_PROBE_SEEDS, each held as chip_smoke.chime4_pass_check
holds it (but reported, not failed) with witnesses, each one float32 pass
on the card with one part of the front end in float64, and then float64
passes on the card moved by one float32 rounding in one place. It found
that no single part is at fault and that the gradients in front of the
MVDR's solve are ill-conditioned (chip_smoke's CHIME4_PASS_DRAWS comment).

One card, about 5-10 minutes, from the root of the repository:

    python3 probes/chime4_referee.py
"""

import copy
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def front_end_float64(task) -> None:
    """A witness of the chime4 training pass: the front end (the mask
    network and the MVDR) of `task` in float64, its output cast back to
    complex64; the STFT, the features and the ASR model stay float32."""
    import torch
    enh = task.nnet.enh_net.double()
    forward = enh.forward
    enh.forward = lambda feats, cstft, inp_len=None: forward(
        feats.double(), cstft.to(torch.complex128),
        inp_len=inp_len).to(torch.complex64)


def mask_net_float64(task) -> None:
    """Witness: the front end's mask network (its cuDNN BLSTM and output
    layer) in float64, the MVDR in complex64."""
    net = task.nnet.enh_net.mask_net.double()
    forward = net.forward
    net.forward = lambda feats, inp_len=None: (
        forward(feats.double(), inp_len)[0].float(), inp_len)


def mvdr_float64(part: str):
    """Witness: one op of the MVDR in float64, the rest of the front end in
    float32: "covar" the masked covariances (complex einsum: cuBLAS's
    batched cgemm), "solve" the loaded noise covariance's clamped Cholesky
    and the solve against the speech covariance with the trace and the
    reference vector's product, "beamform" the weighted sum over the
    channels."""
    import torch

    from aps_tpu_torch.asr.filter import mvdr

    def up(t):
        return t.to(torch.complex128 if t.is_complex() else torch.float64)

    def witness(task) -> None:
        bf = task.nnet.enh_net.mvdr_net

        def forward(mask_s, x, mask_n=None, x_len=None):
            mask_s = bf._process_mask(mask_s, x_len)
            mask_n = bf._process_mask(mask_n, x_len)
            mask_n = 1 - mask_s if mask_n is None else mask_n
            if part == "covar":
                Rs, Rn = (mvdr.estimate_covar(up(m), up(x)).to(x.dtype)
                          for m in (mask_s, mask_n))
            else:
                Rs, Rn = (mvdr.estimate_covar(m, x) for m in (mask_s, mask_n))
            u = bf.ref(Rs)
            if part == "solve":
                weight = bf._derive_weight(up(Rs), up(Rn), up(u),
                                           eps=bf.eps).to(x.dtype)
            else:
                weight = bf._derive_weight(Rs, Rn, u, eps=bf.eps)
            if part == "beamform":
                return mvdr.beamform(up(weight).transpose(1, 2), up(
                    x)).transpose(1, 2).to(x.dtype)
            return mvdr.beamform(weight.transpose(1, 2), x).transpose(1, 2)

        bf.forward = forward
    return witness


# the witnesses of the chime4 pass: where the card's float32 distance from
# float64 comes from, one part of the front end in float64 at a time
CHIME4_WITNESSES = {"dense": cs.dense_attention, "front64": front_end_float64,
                    "mask64": mask_net_float64,
                    "covar64": mvdr_float64("covar"),
                    "solve64": mvdr_float64("solve"),
                    "beamform64": mvdr_float64("beamform")}

# chime4_probe: the chime4 1b training pass at CHIME4_PROBE_SEEDS on a
# corpus of its own, each draw through cs.step_pass_check (witnesses and CPU
# rounding draws), then float64 passes on the card (dense attention)
# moved by one float32 rounding in one place each: the MVDR's inputs
# rounded to float32, its covariances moved entry by entry, the gradient
# arriving at the front end's output moved. How far each moves a gradient
# from float64 shows where the float32 passes' spread comes from
CHIME4_PROBE_CORPUS = cs.SEED + 30
CHIME4_PROBE_SEEDS = tuple(range(cs.SEED + 40, cs.SEED + 48))
CHIME4_PROBE_MOVES = 3


def moved_by_rounding(t, gen):
    """t (real or complex) plus one float32 rounding of each entry, in a
    random direction: t + 2^-24 |t| xi."""
    import torch

    def xi():
        return torch.randint(0, 2, t.shape, generator=gen,
                             device=t.device).to(t.real.dtype) * 2 - 1
    step = cs.F32_UNIT * t.abs()
    return t + (step * torch.complex(xi(), xi()) if t.is_complex() else
                step * xi())


def chime4_probe_pass(task, batch, dev, where: str, seed: int):
    """A float64 pass on the card on the dense path, moved by one float32
    rounding at `where` ("none", "inputs", "covar" or "grad") -> the
    gradients of cs.CHIME4_GRADS."""
    import torch

    from aps_tpu_torch.asr.filter import mvdr
    from aps_tpu_torch.trainer.dp import to_device
    side = copy.deepcopy(task).to(dev, torch.float64).train()
    cs.dense_attention(side)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = side.nnet.enh_net.mvdr_net
    forward, covar = bf.forward, mvdr.estimate_covar
    if where == "inputs":
        bf.forward = lambda mask_s, x, mask_n=None, x_len=None: forward(
            mask_s.float().double(), x.to(torch.complex64).to(
                torch.complex128), mask_n, x_len)
    elif where == "covar":
        mvdr.estimate_covar = lambda *args, **kwargs: moved_by_rounding(
            covar(*args, **kwargs), gen)
    elif where == "grad":
        def hook(mod, inp, out):
            out.register_hook(lambda g: moved_by_rounding(g, gen))
        side.nnet.enh_net.register_forward_hook(hook)
    try:
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in to_device(batch, dev).items()}
        side(b)["loss"].backward()
    finally:
        mvdr.estimate_covar = covar
    params = dict(side.nnet.named_parameters())
    return {k: params[k].grad.cpu() for k in cs.CHIME4_GRADS}


def chime4_probe() -> None:
    """The chime4
    1b training pass at each of CHIME4_PROBE_SEEDS (the i-th on utterances
    4i to 4i + 3 of a corpus of seed CHIME4_PROBE_CORPUS), held as
    chime4_pass_check holds it but reported, not failed; then the float64
    passes of chime4_probe_pass against the CPU's float64 pass."""
    import torch

    from aps_tpu_torch.conf import load_am_conf
    from aps_tpu_torch.ops import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    build.build_all()
    failures = []
    cs.fail = failures.append
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = cs.write_chime4(root, torch.Generator().manual_seed(
            CHIME4_PROBE_CORPUS))
        conf, _ = load_am_conf(str(data / "train.yaml"), str(root / "dict"))
        egs = cs.first_batch(root, data, cs.CHIME4_TRAIN_UTTS)
        for i, seed in enumerate(CHIME4_PROBE_SEEDS):
            first = (i % 8) * cs.CHIME4_PASS_UTTS
            batch = {k: torch.as_tensor(v[first:first + cs.CHIME4_PASS_UTTS])
                     for k, v in egs.items() if not k.startswith("#")}
            task = cs.chime4_model(conf, torch.Generator().manual_seed(seed))
            before = len(failures)
            launched = {}
            _, _, errs = cs.step_pass_check(
                task, batch, dev, cs.CHIME4_GRADS, cs.CHIME4_PASS_UTTS,
                referee=True, referee_on="cpu", witnesses=CHIME4_WITNESSES,
                cpu_draws=cs.CHIME4_CPU_DRAWS, launched=launched)
            print(f"chime4 probe, weights of seed {seed}, utterances "
                  f"{first}-{first + cs.CHIME4_PASS_UTTS - 1}: distance from "
                  "the CPU's float64 pass (card, the CPU's float32 pass, "
                  + ", ".join(CHIME4_WITNESSES) + ", the largest of the "
                  f"CPU's {cs.CHIME4_CPU_DRAWS} passes on inputs moved by "
                  "one rounding, the bound, a planted missing term) "
                  + "; ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in e)
                              for k, e in errs.items())
                  + f"; {len(failures) - before} over the bound "
                  + " / ".join(failures[before:]), flush=True)
            cpu = {}
            for dtype in (torch.float64, torch.float32):
                side = copy.deepcopy(task).to(dtype).train()
                side({k: v.to(dtype) if v.is_floating_point() else v
                      for k, v in batch.items()})["loss"].backward()
                params = dict(side.nnet.named_parameters())
                cpu[dtype] = {k: params[k].grad.double()
                              for k in cs.CHIME4_GRADS}
            cpu64 = cpu[torch.float64]
            moves = [("card64", "none", 0), ("inputs", "inputs", 0)] + [
                (f"{w}{d}", w, d) for w in ("covar", "grad")
                for d in range(CHIME4_PROBE_MOVES)]
            dists = {name: chime4_probe_pass(task, batch, dev, where, d)
                     for name, where, d in moves}
            def rel(got, key):
                return float((got[key] - cpu64[key]).abs().max()) / \
                    float(cpu64[key].abs().max())
            # the one-pass rule: the CPU's one float32 pass sets the bound
            one = {k: cs.TOL_STEP_GRAD + cs.TOL_SEP_GRAD_NOISE * rel(
                cpu[torch.float32], k) for k in cs.CHIME4_GRADS}
            names = ("card32",) + tuple(CHIME4_WITNESSES)
            over = [f"{k} {n} {d:.3e} > {one[k]:.3e}"
                    for k, e in errs.items()
                    for n, d in zip(names, (e[0],) + e[2:]) if d > one[k]]
            print(f"chime4 probe, seed {seed}: the CPU's one float32 pass "
                  + ", ".join(f"{k} {rel(cpu[torch.float32], k):.3e}"
                              for k in cs.CHIME4_GRADS)
                  + f"; over the one-pass bound: {over or 'none'}",
                  flush=True)
            print(f"chime4 probe, seed {seed}: float64 passes on the card "
                  "moved by one float32 rounding, distance from the CPU's "
                  "float64 pass "
                  + "; ".join(f"{k} " + ", ".join(
                      f"{n} {rel(g, k):.3e}" for n, g in dists.items())
                      for k in cs.CHIME4_GRADS)
                  + f" ({card})", flush=True)
    print(f"chime4 probe: {len(failures)} passes over the bound ({card})",
          flush=True)


if __name__ == "__main__":
    chime4_probe()
