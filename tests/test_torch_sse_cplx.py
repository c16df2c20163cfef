#!/usr/bin/env python
"""PyTorch port, the complex U-nets of the SSE zoo: sse@dcunet, sse@dccrn
and sse@dense_unet against aps_tpu with converted weights (eval and
training-mode outputs, a task's loss and every gradient against
jax.value_and_grad, the batch statistics, the converter's round trip),
the 2-D transposed conv's weight layout, the tasks sse@complex_mapping
and sse@complex_masking, and export_dcunet/1a from its YAML through
train_ss and separate against cmd/separate.py's Separator."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.libs import aps_sse_nnet, aps_transform  # noqa: E402

# one_thread: test_torch_sse_time's autouse fixture, applied here too
from test_torch_sse_time import (REPO, check_model,  # noqa: E402,F401
                                 check_separate, check_task, close,
                                 mixtures, one_thread, train_recipe,
                                 write_corpus, zoo_pair)

# 65 bins: each stride-2 layer of kernel 3 (or kernel 5 with an output
# padding of 1 back) maps an odd F onto (F - 1) / 2 and back
ENH = dict(feats="spectrogram-log-cmvn", frame_len=128, frame_hop=64,
           window="sqrthann", center=True)
ENH_STFT = dict(ENH, feats="spectrogram")
UNET = dict(K="5,3;3,3", S="2,1;2,1", C="4,6", P="1,1", O="0,1")
MODELS = {
    "dcunet_cplx": ("sse@dcunet", dict(UNET, cplx=True), ENH_STFT),
    "dcunet_real": ("sse@dcunet", dict(UNET, cplx=False, num_branch=2,
                                       non_linear="sigmoid",
                                       connection="cat", causal_conv=True),
                    ENH_STFT),
    # 16 half-bins x 6 channels feed the bottleneck: rnn_resize 2 x 96
    "dccrn_cplx": ("sse@dccrn", dict(UNET, cplx=True, num_spks=2,
                                     rnn_hidden=8, rnn_layers=2,
                                     rnn_resize=192, training_mode="freq"),
                   ENH_STFT),
    "dccrn_real": ("sse@dccrn", dict(UNET, cplx=False, num_spks=2,
                                     rnn_hidden=8, rnn_layers=1,
                                     rnn_resize=96, connection="cat",
                                     share_decoder=False, rnn_bidir=True,
                                     non_linear="sigmoid",
                                     training_mode="time"), ENH_STFT),
    # 65 bins: 63 (stride 1, no F padding) -> 31 -> 15; 15 x 12 channels
    "dense_unet": ("sse@dense_unet", dict(
        K="3,3;3,3;3,3", S="1,1;2,1;2,1", P="0,1;0,1;0,1", O="0,0,0",
        enc_channel="4,8,12", dec_channel="4,6,8", num_dense_blocks=2,
        norm="BN", num_spks=2, rnn_hidden=8, rnn_layers=1, rnn_resize=180,
        training_mode="time"), ENH),
    "dense_unet_cplx": ("sse@dense_unet", dict(
        K="3,3;3,3;3,3", S="1,1;2,1;2,1", P="0,1;0,1;0,1", O="0,0,0",
        enc_channel="4,8,12", dec_channel="4,6,8", num_dense_blocks=1,
        inp_cplx=True, out_cplx=True, norm="IN", num_spks=1,
        rnn_hidden=8, rnn_layers=1, rnn_resize=180, non_linear="relu",
        training_mode="freq"), ENH),
}


def _pair(key, seed=0, **extra):
    name, conf, enh = MODELS[key]
    return zoo_pair(name, dict(conf, **extra), enh=enh, seed=seed, S=1600)


def _modes(key):
    return ("time",) if key.startswith("dcunet") else ("time", "freq")


@pytest.mark.parametrize("key", sorted(MODELS))
def test_model_matches_jax(key):
    """The eval forward, infer in each mode and the round trip."""
    jnet, variables, net = _pair(key)
    check_model(jnet, variables, net, mixtures(2, S=1600)["mix"],
                modes=_modes(key))


# task, model, task_conf
TASKS = [
    ("sse@sisnr", "dcunet_cplx", {"num_spks": 1, "permute": False}),
    ("sse@sisnr", "dcunet_real", {"num_spks": 2}),
    ("sse@complex_masking", "dccrn_cplx", {"num_spks": 2}),
    ("sse@complex_masking", "dccrn_cplx",
     {"num_spks": 2, "compress_masks": True,
      "compress_param": [10, 0.1, -1]}),
    ("sse@complex_mapping", "dccrn_cplx", {"num_spks": 2, "objf": "L2"}),
    ("sse@complex_mapping", "dccrn_cplx",
     {"num_spks": 2, "add_magnitude_loss": False, "permute": False}),
    ("sse@sisnr", "dccrn_real", {"num_spks": 2}),
    ("sse@snr", "dense_unet", {"num_spks": 2}),
    ("sse@complex_mapping", "dense_unet_cplx",
     {"num_spks": 1, "permute": False}),
]


@pytest.mark.parametrize("task_name,key,task_conf", TASKS)
def test_task_loss_and_gradients_match_jax(task_name, key, task_conf):
    """A training pass: outputs, loss, every gradient, batch statistics.
    sse@complex_mapping on dense_unet_cplx takes its complex spectrum
    (out_cplx without a mask non-linearity); on DCCRN the complex masks
    stand for spectra, as the task reads any complex output."""
    extra = {"non_linear": ""} if key == "dense_unet_cplx" and \
        task_name == "sse@complex_mapping" else {}
    jnet, variables, net = _pair(key, seed=3, **extra)
    egs = mixtures(5, S=1600, spks=task_conf["num_spks"])
    check_task(jnet, variables, net, task_name, task_conf, egs)


def test_transposed_conv_2d_layout():
    """flax's ConvTranspose with transpose_kernel=True (kernel kf x kt x O x
    I) against nn.ConvTranspose2d (I x O x kf x kt) through the converter
    (no tap reversal), stride, padding, output padding and the causal crop
    as aps_tpu's slice of the VALID output gives them."""
    from aps_tpu.sse.enh import dcunet as jax_dcunet
    from aps_tpu_torch.sse.enh import dcunet
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    for kernel, stride, pad, out_pad, causal in (
            ((5, 3), (2, 1), 1, 1, False), ((3, 3), (2, 1), 1, 0, True),
            ((4, 2), (3, 1), 2, 2, False), ((3, 5), (1, 1), 0, 0, True)):
        jmod = jax_dcunet._ConvTranspose2dTorch(
            5, kernel, stride, pad, out_pad, causal=causal)
        variables = jax.tree_util.tree_map(np.array, dict(jmod.init(
            jax.random.PRNGKey(0), x)))
        kern = variables["params"]["ConvTranspose_0"]["kernel"]
        assert kern.shape == kernel + (5, 3)
        tmod = dcunet.ConvTranspose2dTorch(3, 5, kernel, stride, pad,
                                           out_pad, causal=causal)
        tmod.load_state_dict(to_state_dict(variables, tmod))
        assert tmod.conv_t.weight.shape == (3, 5) + kernel
        np.testing.assert_array_equal(
            tmod.conv_t.weight.detach().numpy(),
            np.transpose(kern, (3, 2, 0, 1)))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        close(got.permute(0, 2, 3, 1), jmod.apply(variables, x), 1e-6)
        np.testing.assert_array_equal(
            to_variables(tmod)["params"]["ConvTranspose_0"]["kernel"], kern)
    with pytest.raises(ValueError, match="cut it short"):
        dcunet.ConvTranspose2dTorch(3, 5, (3, 3), (2, 1), 0, 1)


def test_models_refuse_what_aps_tpu_refuses():
    enh = aps_transform("enh")(**ENH_STFT)
    for name in ("sse@dcunet", "sse@dccrn", "sse@dense_unet"):
        with pytest.raises(ValueError, match="enh_transform"):
            aps_sse_nnet(name)()
    with pytest.raises(ValueError, match="connection"):
        aps_sse_nnet("sse@dcunet")(enh_transform=enh, connection="add",
                                   **UNET)


# ---------------------------------------------------------------------------
# export_dcunet/1a
# ---------------------------------------------------------------------------
# The recipe's 7 stride-2 layers take each 257-bin half to 127, 62, 29,
# 14, 6, 2 and 0 bins: neither package builds it as written. The 6-layer
# cut with the output padding the even sizes need (62, 14 and 6 come back
# one short without it) is what both run.
DCUNET_6 = dict(K="7,5;7,5;7,5;5,3;5,3;5,3", S="2,1;2,1;2,1;2,1;2,1;2,1",
                C="32,32,64,64,64,64", P="1,1,1,1,1,1", O="0,0,1,0,1,1")


def test_export_dcunet_as_written_builds_in_neither_package():
    from aps_tpu.conf import load_ss_conf as jax_load_conf
    conf = jax_load_conf(str(REPO / "examples/sse/export_dcunet/conf/"
                             "1a.yaml"))
    mix = np.zeros((1, 4000), dtype=np.float32)
    jnet = jax_libs.aps_sse_nnet(conf["nnet"])(
        enh_transform=jax_libs.aps_transform("enh")(**conf["enh_transform"]),
        **conf["nnet_conf"])
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda m: jnet.init(jax.random.PRNGKey(0), m,
                                           training=False), mix)
    net = aps_sse_nnet(conf["nnet"])(
        enh_transform=aps_transform("enh")(**conf["enh_transform"]),
        **conf["nnet_conf"])
    with pytest.raises(RuntimeError):
        net(torch.from_numpy(mix))


def test_export_dcunet_trains_and_separates(tmp_path):
    """export_dcunet/1a (sse@dcunet, complex, training_mode time, sse@sisnr
    with one reference, the 512-point STFT) at the recipe's widths cut to
    6 layers, through train_ss and separate against aps_tpu's Separator
    (batch 1 as run.sh's Separator runs it, and batched against aps_tpu's
    run_batch: the model is a function of the whole padded input)."""
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    sr = 16000
    root = tmp_path / "data"
    root.mkdir()
    write_corpus(root, sr, 1)
    cpt, trainer = train_recipe("export_dcunet/1a", root, DCUNET_6,
                                int(0.4 * sr))
    assert type(trainer.task).__name__ == "SisnrTask"
    assert trainer.cur_step >= 2
    assert all(np.isfinite(float(v)) for v in trainer.reporter.stats["loss"])
    assert type(jax_load(str(cpt))["nnet"]).__name__ == "DCUNet"
    check_separate(root, cpt, sr, 1, tmp_path,
                   lambda jsep, srcs: jsep.run_batch(srcs))
