#!/usr/bin/env python
"""PyTorch port, the rest of the SSE zoo: sse@freq_xfmr (rel pose on the
plain rel attention here, the path K3 takes on the card; a context-masked
one on the dense path), sse@dfsmn (real and complex masks), sse@phasen and
sse@chimera++ with the deep-clustering branch of the spectral
approximation, against aps_tpu with converted weights: eval and
training-mode outputs, infer, mask_predict, a task's loss (and its dpcl
and mask parts) with every gradient against jax.value_and_grad, the batch
statistics and the converter's round trip; and a chimera++ model trained
through train_ss from a YAML with dpcl_weight."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu_torch.libs import aps_sse_nnet, aps_transform  # noqa: E402

# one_thread: test_torch_sse_time's autouse fixture, applied here too
from test_torch_sse_time import (check_model, check_separate,  # noqa: E402,F401
                                 check_task, close, mixtures, one_thread,
                                 write_corpus, zoo_pair)

ENH = dict(feats="spectrogram-log-cmvn", frame_len=64, frame_hop=32,
           window="sqrthann", center=True)
BINS = 33
XFMR = dict(att_dim=16, nhead=2, feedforward_dim=24, att_dropout=0.0,
            ffn_dropout=0.0)
MODELS = {
    "freq_xfmr": ("sse@freq_xfmr", dict(input_size=BINS, num_bins=BINS,
                                        num_layers=2, arch_kwargs=XFMR,
                                        pose_kwargs=dict(lradius=8,
                                                         rradius=8))),
    "freq_xfmr_ctx": ("sse@freq_xfmr", dict(input_size=BINS, num_bins=BINS,
                                            num_layers=2, lctx=3, rctx=1,
                                            arch="cfmr", arch_kwargs=dict(
                                                XFMR, kernel_size=3),
                                            training_mode="time")),
    "dfsmn_cplx": ("sse@dfsmn", dict(dim=16, num_bins=BINS, num_branchs=2,
                                     num_layers=2, project=8, lctx=2, rctx=1,
                                     complex_mask=True)),
    "dfsmn_real": ("sse@dfsmn", dict(dim=16, num_bins=BINS, num_branchs=1,
                                     num_layers=3, project=8, lctx=1, rctx=2,
                                     complex_mask=False, non_linear="sigmoid",
                                     training_mode="time")),
    "phasen": ("sse@phasen", dict(channel_amp=4, channel_pha=3, num_tsbs=2,
                                  num_bins=BINS, channel_r=2,
                                  conv1d_kernel=3, lstm_hidden=6,
                                  linear_size=8)),
    "chimera": ("sse@chimera++", dict(input_size=BINS, num_bins=BINS,
                                      hidden=8, num_layers=2, dropout=0.0,
                                      dpcl_embed_size=4, bidirectional=True,
                                      mask_non_linear="relu")),
}


def _pair(key, seed=0, **extra):
    name, conf = MODELS[key]
    return zoo_pair(name, dict(conf, **extra), enh=ENH, seed=seed)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_model_matches_jax(key):
    """The eval forward, infer in time and freq mode, mask_predict where
    the model has it, and the converter's round trip."""
    jnet, variables, net = _pair(key)
    mix = mixtures(2)["mix"]
    check_model(jnet, variables, net, mix)
    if hasattr(net, "mask_predict") and not key.startswith("chimera"):
        feats = np.random.default_rng(3).standard_normal(
            (2, 9, BINS)).astype(np.float32)
        with torch.no_grad():
            close(net.mask_predict(torch.from_numpy(feats)),
                  jax.jit(lambda v, f: jnet.apply(
                      v, f, method="mask_predict"))(variables,
                                                     jnp.asarray(feats)))


def test_chimera_dpcl_embed_matches_jax():
    """The embeddings (N x FT x D, F major) in eval and, with the trunk's
    dropout on, in training mode: dpcl_embed runs the trunk without it."""
    jnet, variables, net = _pair("chimera", dropout=0.5)
    mix = mixtures(4)["mix"]
    want = jax.jit(lambda v, m: jnet.apply(v, m, method="dpcl_embed"))(
        variables, jnp.asarray(mix))
    for training in (False, True):
        net.train(training)
        with torch.no_grad():
            got = net.dpcl_embed(torch.from_numpy(mix))
        assert got.shape == (2, BINS * 38, 4)
        close(got, want)
        assert net.encoder.training == training


# task, model, task_conf
TASKS = [
    ("sse@freq_linear_sa", "freq_xfmr", {"num_spks": 2}),
    ("sse@sisnr", "freq_xfmr_ctx", {"num_spks": 2}),
    ("sse@complex_masking", "dfsmn_cplx", {"num_spks": 2}),
    ("sse@wa", "dfsmn_real", {"num_spks": 1, "permute": False,
                              "objf": "L2"}),
    ("sse@complex_mapping", "phasen", {"num_spks": 1, "permute": False}),
    ("sse@freq_linear_sa", "chimera",
     {"num_spks": 2, "dpcl_weight": 0.3, "phase_sensitive": True}),
    ("sse@freq_mel_sa", "chimera",
     {"num_spks": 2, "dpcl_weight": 0.6, "num_bins": BINS, "num_mels": 8,
      "mel_log": True}),
]


# the training-mode output of sse@phasen: its unit phase divides by the
# norm of a 2-vector that comes out of four BatchNorms on batch
# statistics, and where that norm is small float32 drifts: measured 1.9e-4
# (the port) and 9.5e-5 (aps_tpu, eagerly) from a float64 pass of the
# port, out of 5.45, where the two float32 passes differ by up to 6.3e-4
# (aps_tpu jitted). Both are held to the float64 pass, relative to its
# largest entry
PHASEN_REFEREE_ATOL = 1e-4
# its SiSNR loss (-2.4786 dB in time mode): the port's float32 pass lands
# 1.6e-5 of it from the float64 pass, aps_tpu's 3e-6
PHASEN_LOSS_RTOL = 5e-5
# and each gradient leaf: up to 7.6e-4 (the port) and 1.5e-3 (aps_tpu) of
# its own largest entry from the float64 pass (the BatchNorm scales of the
# first two-stream block); PERF.md's training gate, 2e-3, plus ZERO_F32 of
# the model's largest entry
PHASEN_GRAD_RTOL = 2e-3
# 38 hops of 32: the iSTFT gives the input's length back
S_TIME = 1216


@pytest.mark.parametrize("task_name,key,task_conf", TASKS)
def test_task_loss_and_gradients_match_jax(task_name, key, task_conf):
    """A training pass: outputs, loss (with chimera++: loss, dpcl and
    mask), every gradient, batch statistics."""
    jnet, variables, net = _pair(key, seed=3)
    egs = mixtures(5, S=S_TIME, spks=task_conf["num_spks"])
    phasen = dict(referee_atol=PHASEN_REFEREE_ATOL,
                  loss_rtol=PHASEN_LOSS_RTOL,
                  grad_rtol=PHASEN_GRAD_RTOL) if key == "phasen" else {}
    out = check_task(jnet, variables, net, task_name, task_conf, egs,
                     **phasen)
    if "dpcl_weight" in task_conf:
        w = task_conf["dpcl_weight"]
        assert sorted(out) == ["dpcl", "loss", "mask"]
        np.testing.assert_allclose(
            out["loss"].item(),
            w * out["dpcl"].item() + (1 - w) * out["mask"].item(),
            rtol=1e-6)


def test_phasen_time_mode_matches_jax():
    """sse@phasen in training mode "time" (the iSTFT of its spectrum)
    under sse@sisnr."""
    jnet, variables, net = _pair("phasen", seed=5, training_mode="time")
    check_task(jnet, variables, net, "sse@sisnr",
               {"num_spks": 1, "permute": False},
               mixtures(6, S=S_TIME, spks=1),
               referee_atol=PHASEN_REFEREE_ATOL,
               loss_rtol=PHASEN_LOSS_RTOL, grad_rtol=PHASEN_GRAD_RTOL)


def test_freq_xfmr_takes_the_rel_kernel_path(monkeypatch):
    """The rel-pose self-attention goes through flash_attention_rel (the
    plain version on a CPU tensor, K3 on the card) once a layer, in eval and
    in training with the attention dropout off; a context mask (lctx /
    rctx) takes the dense path."""
    from aps_tpu_torch.asr.transformer import impl
    calls = []
    real = impl.flash_attention_rel

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(impl, "flash_attention_rel", counted)
    mix = torch.from_numpy(mixtures(1)["mix"])
    for key, want in (("freq_xfmr", 2), ("freq_xfmr_ctx", 0)):
        _, _, net = _pair(key)
        for training in (False, True):
            calls.clear()
            net.train(training)
            out = net(mix)
            if training:
                sum(o.sum() for o in out).backward()
            assert len(calls) == want, (key, training, calls)
            assert all(c == (2, 2, 38, 8) for c in calls)


def test_models_refuse_what_aps_tpu_refuses():
    for name in ("sse@freq_xfmr", "sse@dfsmn", "sse@phasen",
                 "sse@chimera++"):
        with pytest.raises(ValueError, match="enh_transform"):
            aps_sse_nnet(name)()
    enh = aps_transform("enh")(**ENH)
    with pytest.raises(ValueError, match="Unsupported nonlinear"):
        aps_sse_nnet("sse@dfsmn")(enh_transform=enh, complex_mask=False,
                                  non_linear="tanh")


def test_chimera_trains_with_dpcl_and_separates(tmp_path):
    """A chimera++ YAML (sse@freq_linear_sa with dpcl_weight, the
    spectrogram-log-cmvn transform) through train_ss: the loss and its
    dpcl and mask parts reported; then separate against aps_tpu's
    Separator (batch 1 in time mode) on that checkpoint."""
    from aps_tpu_torch.cmd import train_ss
    root = tmp_path / "data"
    root.mkdir()
    sr = 8000
    write_corpus(root, sr, 2)
    conf = {
        "nnet": "sse@chimera++",
        "nnet_conf": dict(MODELS["chimera"][1], training_mode="freq"),
        "enh_transform": ENH,
        "task": "sse@freq_linear_sa",
        "task_conf": {"num_spks": 2, "dpcl_weight": 0.5,
                      "phase_sensitive": True, "truncated": 1},
        "trainer_conf": {"optimizer": "adam",
                         "optimizer_kwargs": {"lr": 1.0e-3},
                         "lr_scheduler": "reduce_lr",
                         "lr_scheduler_kwargs": {"factor": 0.5,
                                                 "patience": 1},
                         "clip_gradient": 5, "no_impr": 6,
                         "report_metrics": ["loss", "dpcl", "mask"],
                         "stop_criterion": "loss"},
        "data_conf": {"fmt": "se@chunk",
                      "loader": {"chunk_size": 3200, "sr": sr},
                      "train": {"mix_scp": str(root / "mix.scp"),
                                "ref_scp": f"{root / 's1.scp'},"
                                f"{root / 's2.scp'}"}},
    }
    conf["data_conf"]["valid"] = conf["data_conf"]["train"]
    yaml = root / "chimera.yaml"
    yaml.write_text(json.dumps(conf))
    cpt = root / "exp"
    trainer = train_ss.main(["--conf", str(yaml), "--checkpoint", str(cpt),
                             "--batch-size", "2", "--epochs", "1",
                             "--device", "cpu"])
    stats = trainer.reporter.stats
    for key in ("loss", "dpcl", "mask"):
        assert stats[key] and all(np.isfinite(float(v)) for v in stats[key])
    check_separate(root, cpt, sr, 2, tmp_path)
