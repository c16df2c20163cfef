#!/usr/bin/env python
"""PyTorch port, the two multi-channel recipes as a whole against aps_tpu
on JAX's CPU: asr@enh_xfmr (the model of examples/asr/chime4/conf/1b.yaml
at toy widths: MVDR front end, conformer with rel attention, CTC) through
its forward, decode_enc, an asr@ctc_xent step and the batched search on
3-channel input; sse@rnn_enh_ml with the sse@enh_ml task (chime4_ml);
aps_tpu's two faults on this path (1b's fbank-log-cmvn after the
beamformer, the batched search's padding of the channel axis); and the
commands: train_am -> decode_batch / decode -> compute_wer, train_ss ->
separate, with --device cpu."""

import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import transformer as jax_search  # noqa: E402
from aps_tpu.asr.beam_search.utils import \
    stack_padded as jax_stack_padded  # noqa: E402
from aps_tpu_torch.asr.beam_search import transformer as search  # noqa
from aps_tpu_torch.asr.beam_search.utils import stack_padded  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import (aps_asr_nnet, aps_sse_nnet,  # noqa: E402
                                aps_task, aps_transform)

from test_torch_train import assert_trees_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SR = 16000
C = 3
VOCAB = 12
ENH = dict(feats="spectrogram-log-cmvn", frame_len=256, frame_hop=128,
           window="hann")
ASR = dict(feats="abs-mel-log-cmvn", frame_len=256, frame_hop=128,
           window="hann", sr=SR, num_mels=20)
# 1b.yaml's model at toy widths, every dropout off (both sides compute the
# same function in training mode)
NNET = dict(
    input_size=20, enh_input_size=129, enh_type="rnn_mask_mvdr",
    enh_kwargs=dict(num_bins=129, num_layers=1, hidden_size=8,
                    mvdr_att_dim=8),
    enc_type="cfmr",
    enc_kwargs=dict(num_layers=2, proj="conv2d",
                    proj_kwargs=dict(conv_channels=8, num_layers=2),
                    pose="rel",
                    pose_kwargs=dict(lradius=8, rradius=8, dropout=0.0),
                    arch_kwargs=dict(att_dim=32, nhead=4, feedforward_dim=64,
                                     kernel_size=7, att_dropout=0.0,
                                     ffn_dropout=0.0)),
    dec_kwargs=dict(num_layers=1, pose_kwargs=dict(dropout=0.0),
                    arch_kwargs=dict(att_dim=32, nhead=4, feedforward_dim=64,
                                     att_dropout=0.0, ffn_dropout=0.0)),
    vocab_size=VOCAB, sos=VOCAB - 3, eos=VOCAB - 2, ctc=True)
TASK_CONF = dict(ctc_weight=0.2, blank=VOCAB - 1, lsm_factor=0.1)
# encoder outputs and logits of a two-layer model behind the MVDR
OUT_RTOL = 1e-4
# PERF.md section 2: the loss relative to itself, each gradient leaf
# relative to its own largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3
# beam scores: length-normalised sums of log-probs
SCORE_ATOL = 1e-3
# output layers scaled so that candidates stand apart (no near-ties)
PEAKY = 4.0
# chime4_ml/1a.yaml at toy widths: cos-IPD of 2 pairs on 65 bins
ML_ENH = dict(feats="spectrogram-log-cmvn-ipd", frame_len=128, frame_hop=64,
              window="hann", ipd_index="0,1;0,2", cos_ipd=True)
ML_NNET = dict(input_size=65 * 3, input_proj=16, num_bins=65, rnn="lstm",
               dropout=0.0, bidirectional=True, hidden=8, num_layers=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM slows
    down 100-fold when the suite's other workers load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= rtol, f"{what}: {err:.3g} > {rtol:.3g}"


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def _multichannel(seed, lens, C=C):
    """N x C x S: delayed copies of a source of tones and noise (real
    spatial structure without an RIR) and noise of each channel's own,
    zero past each length. The channels' own noise keeps the covariances
    of the MVDR well conditioned: with 0.01 of it in place of 0.05 the two
    packages' float32 solves part by ~3e-4 of the enhanced features
    (tests/test_torch_multichannel.py holds that near-rank-1 corner)."""
    rng = np.random.default_rng(seed)
    S = max(lens)
    out = np.zeros((len(lens), C, S), dtype=np.float32)
    t = np.arange(S) / SR
    for i, n in enumerate(lens):
        src = 0.2 * np.sin(2 * np.pi * rng.uniform(200, 900) * t) + \
            0.05 * rng.standard_normal(S)
        for c in range(C):
            out[i, c, :n] = np.roll(src, 2 * c)[:n] + \
                0.05 * rng.standard_normal(n)
    return out


def _batch(seed, lens=(9000, 7000, 5600), L=5):
    rng = np.random.default_rng(seed)
    tgt_len = np.array([L, L - 2, 3][:len(lens)])
    tgt = rng.integers(0, VOCAB - 3, (len(lens), L))
    for i, n in enumerate(tgt_len):
        tgt[i, n:] = -1
    return {"src_pad": _multichannel(seed, lens),
            "src_len": np.array(lens), "tgt_pad": tgt, "tgt_len": tgt_len}


def _jax_model(asr=ASR, **extra):
    return jax_libs.aps_asr_nnet("asr@enh_xfmr")(
        enh_transform=jax_libs.aps_transform("enh")(**ENH),
        asr_transform=jax_libs.aps_transform("asr")(**asr),
        **dict(NNET, **extra))


def _port_model(asr=ASR, **extra):
    return aps_asr_nnet("asr@enh_xfmr")(
        enh_transform=aps_transform("enh")(**ENH),
        asr_transform=aps_transform("asr")(**asr), **dict(NNET, **extra))


@pytest.fixture(scope="module")
def enh_pair():
    """(flax task, its variables as numpy, the port's task with the same
    weights: output layers x PEAKY, batch statistics moved)."""
    jtask = jax_libs.aps_task("asr@ctc_xent", _jax_model(), **TASK_CONF)
    egs = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    key = jax.random.PRNGKey(0)
    init = jax.jit(functools.partial(jtask.init, training=True))
    variables = jax.tree_util.tree_map(np.array, dict(init(
        {"params": key, "dropout": key}, egs)))
    params = variables["params"]["nnet"]
    params["decoder"]["output"]["kernel"] *= PEAKY
    params["ctc_head"]["kernel"] *= PEAKY
    rng = np.random.default_rng(5)
    for path, val in _leaves(variables["batch_stats"]):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    task = aps_task("asr@ctc_xent", _port_model(), **TASK_CONF)
    nnet_vars = {"params": params,
                 "batch_stats": variables["batch_stats"]["nnet"]}
    task.nnet.load_state_dict(to_state_dict(nnet_vars, task.nnet))
    back = to_variables(task.nnet)
    for (path, a), (_, b) in zip(sorted(_leaves(back)),
                                 sorted(_leaves(nnet_vars))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    return jtask, variables, task.eval()


def _nnet_vars(variables):
    return {"params": variables["params"]["nnet"],
            "batch_stats": variables["batch_stats"]["nnet"]}


def test_enh_xfmr_forward_and_decode_enc_match_jax(enh_pair):
    """Eval forward (decoder and CTC logits, encoder lengths) and
    decode_enc on a 3-channel batch of unequal lengths."""
    jtask, variables, task = enh_pair
    egs = _batch(2)
    jnnet = jtask.nnet
    x, xl = jnp.asarray(egs["src_pad"]), jnp.asarray(egs["src_len"])
    y = np.where(egs["tgt_pad"] < 0, VOCAB - 2, egs["tgt_pad"])
    y = np.pad(y, ((0, 0), (1, 0)), constant_values=VOCAB - 3)
    yl = egs["tgt_len"] + 1
    want = jax.jit(functools.partial(jnnet.apply, training=False))(
        _nnet_vars(variables), x, xl, jnp.asarray(y), jnp.asarray(yl))
    with torch.no_grad():
        got = task.nnet(torch.from_numpy(egs["src_pad"]),
                        torch.from_numpy(egs["src_len"]),
                        torch.from_numpy(y), torch.from_numpy(yl))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    enc_len = np.asarray(want[2])
    for i, n in enumerate(enc_len):
        _close(got[1][i, :n].numpy(), np.asarray(want[1])[i, :n], OUT_RTOL,
               "ctc logits")
        _close(got[0][i, :yl[i]].numpy(), np.asarray(want[0])[i, :yl[i]],
               OUT_RTOL, "decoder logits")
    want = jax.jit(functools.partial(jnnet.apply, method="decode_enc"))(
        _nnet_vars(variables), x, xl)
    with torch.no_grad():
        got = task.nnet.decode_enc(torch.from_numpy(egs["src_pad"]),
                                   torch.from_numpy(egs["src_len"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i, n in enumerate(enc_len):
        _close(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], OUT_RTOL,
               "encoder")
        _close(got[2][i, :n].numpy(), np.asarray(want[2])[i, :n], OUT_RTOL,
               "ctc")


def test_ctc_xent_step_matches_jax(enh_pair):
    """One training-mode asr@ctc_xent pass: the loss and its statistics,
    every gradient (the MVDR's mask network and reference attention
    included) and the batch statistics."""
    jtask, variables, task = enh_pair
    egs = _batch(3)
    task = copy.deepcopy(task).train()
    stats = task({k: torch.from_numpy(v) for k, v in egs.items()})
    stats["loss"].backward()
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}

    def loss_fn(params):
        out, state = jtask.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jegs, training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return out["loss"], (out, state)

    (_, (want, state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    for key in want:
        np.testing.assert_allclose(stats[key].item(), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    got_grads = to_gradients(task.nnet)
    assert "mvdr_net" in got_grads["enh_net"]
    exact = copy.deepcopy(task).double()
    exact.zero_grad(set_to_none=True)
    exact({k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                               else v) for k, v in egs.items()}
          )["loss"].backward()
    zeros = assert_trees_close(got_grads, grads["nnet"], GRAD_RTOL,
                         exact=to_gradients(exact.nnet))
    # the conv biases before a batch norm, the reference attention's
    # channel-constant bias under its softmax
    assert zeros == [
        "encoder/encoder/layer_0/dconv/bias",
        "encoder/encoder/layer_1/dconv/bias",
        "encoder/proj_layer/Conv2dEncoder_0/conv_0/Conv_0/bias",
        "encoder/proj_layer/Conv2dEncoder_0/conv_1/Conv_0/bias",
        "enh_net/mvdr_net/ref/Dense_1/bias"], zeros
    assert_trees_close(to_variables(task.nnet)["batch_stats"],
                 state["batch_stats"]["nnet"], 1e-5)


def test_1b_fbank_log_cmvn_fails_in_both_packages():
    """examples/asr/chime4/conf/1b.yaml's asr_transform (fbank-log-cmvn)
    frames the beamformed magnitude N x T x 257 as samples: aps_tpu gets
    zero frames and fails; the port refuses the transform."""
    asr = dict(feats="fbank-log-cmvn", frame_len=512, frame_hop=256,
               window="hann", sr=SR, num_mels=20)
    jnnet = _jax_model(asr=asr)
    egs = _batch(4, lens=(6000, 5000))
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(lambda: jnnet.init(
            jax.random.PRNGKey(0), jnp.asarray(egs["src_pad"]),
            jnp.asarray(egs["src_len"]), jnp.zeros((2, 3), jnp.int32),
            jnp.asarray([3, 3]), training=False))
    with pytest.raises(ValueError, match="abs-mel-log-cmvn"):
        _port_model(asr=asr)


def test_enh_att_raises_until_attasr_is_ported():
    """AttASR is ported: asr@enh_att builds behind the same front end
    (tests/test_torch_att.py holds its forward against aps_tpu's)."""
    nnet = aps_asr_nnet("asr@enh_att")(
        asr_transform=aps_transform("asr")(**ASR),
        enh_transform=aps_transform("enh")(**ENH),
        **dict(NNET, dec_kwargs=dict(num_layers=1, hidden=8)))
    assert type(nnet).__name__ == "EnhAttASR"
    assert type(nnet.decoder).__name__ == "TorchRNNDecoder"


def test_stack_padded_pads_the_sample_axis_only():
    """The port pads C x S utterances on the sample axis; aps_tpu's
    np.pad(x, (0, S - l)) also pads the channel axis of a shorter one."""
    a = _multichannel(6, [3000])[0]
    b = _multichannel(7, [2000])[0]
    x_pad, lens, S = stack_padded([a, b], pad_to=3200)
    assert tuple(x_pad.shape) == (2, C, 3200) and lens == [3000, 2000]
    np.testing.assert_array_equal(x_pad[1, :, :2000].numpy(), b)
    assert not x_pad[1, :, 2000:].any()
    with pytest.raises(ValueError):
        jax_stack_padded([a, b])  # C + 1000 channels against C
    same, _, _ = stack_padded([a, a[:, ::-1].copy()])
    want, _, _ = jax_stack_padded([a, a[:, ::-1].copy()])
    np.testing.assert_array_equal(same.numpy(), np.asarray(want))


SEARCH = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=4, nbest=4, max_len=12,
              ctc_weight=0.4, allow_partial=True)


def _same_nbest(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["trans"] == w["trans"]
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL


def test_beam_search_batch_matches_jax(enh_pair, monkeypatch):
    """An equal-length 3-channel batch (where aps_tpu's padding is right)
    against aps_tpu's batched search. A batch of unequal lengths against
    aps_tpu's batched search with its stack_padded replaced by one that
    pads the sample axis only (as is, it hands the model C + S - l
    channels), and its longest utterance, which is not padded, against
    aps_tpu's one-utterance search. (A shorter one differs from its
    one-utterance search by design in both packages: the asr transform's
    cmvn takes its statistics over every frame of the padded batch.)"""
    jtask, variables, task = enh_pair
    nv = _nnet_vars(variables)
    wav = _multichannel(8, [8000, 8000])
    batch = [wav[0], wav[1]]
    want = jax_search.beam_search_batch(jtask.nnet, nv, batch, **SEARCH)
    got = search.beam_search_batch(task.nnet, batch, **SEARCH)
    for g, w in zip(got, want):
        _same_nbest(g, w)
    wav = _multichannel(9, [8000, 6100])
    batch = [wav[0], wav[1, :, :6100]]
    got = search.beam_search_batch(task.nnet, batch, **SEARCH)
    _same_nbest(got[0], jax_search.beam_search(jtask.nnet, nv,
                                               jnp.asarray(batch[0]),
                                               **SEARCH))

    def sample_axis_padded(batch, pad_to=-1):
        x_pad, lens, S = stack_padded(batch, pad_to=pad_to)
        return jnp.asarray(x_pad.numpy()), lens, S

    monkeypatch.setattr(jax_search, "stack_padded", sample_axis_padded)
    want = jax_search.beam_search_batch(jtask.nnet, nv, batch, **SEARCH)
    for g, w in zip(got, want):
        _same_nbest(g, w)


def _ml_pair(seed=0):
    jnet = jax_libs.aps_sse_nnet("sse@rnn_enh_ml")(
        enh_transform=jax_libs.aps_transform("enh")(**ML_ENH), **ML_NNET)
    jtask = jax_libs.aps_task("sse@enh_ml", jnet)
    mix = _multichannel(seed, [4000, 4000])
    # the third channel silent over a stretch: zero TF points in the
    # normalised observation
    mix[:, 2, 1000:2000] = 0
    key = jax.random.PRNGKey(seed)
    init = jax.jit(functools.partial(jtask.init, training=True))
    variables = jax.tree_util.tree_map(np.array, dict(init(
        {"params": key, "dropout": key}, {"mix": jnp.asarray(mix)})))
    net = aps_sse_nnet("sse@rnn_enh_ml")(
        enh_transform=aps_transform("enh")(**ML_ENH), **ML_NNET)
    net.load_state_dict(to_state_dict(
        {"params": variables["params"]["nnet"]}, net))
    return jtask, variables, aps_task("sse@enh_ml", net), mix


def test_permu_aligner_matches_jax():
    """norm_observation and permu_aligner, numpy on the host in both
    packages: masks of two sources, active at different frames, whose
    order is swapped on a random half of the 257 bins come back in one
    order on every bin, as aps_tpu's do, K x T x F and K x F x T."""
    from aps_tpu.sse.unsuper import rnn as jax_unsuper
    from aps_tpu_torch.sse.unsuper import rnn as unsuper
    rng = np.random.default_rng(9)
    K, T, F = 2, 24, 257
    act = (rng.random((K, T, 1)) < 0.5).astype(np.float32)
    masks = act * (0.6 + 0.4 * rng.random((K, T, F))) + \
        0.05 * rng.random((K, T, F))
    swapped = rng.random(F) < 0.5
    masks[:, :, swapped] = masks[::-1][:, :, swapped]
    for mat in (masks, masks.transpose(0, 2, 1)):
        np.testing.assert_array_equal(
            unsuper.norm_observation(mat, axis=1),
            jax_unsuper.norm_observation(mat, axis=1))
    got = unsuper.permu_aligner(masks.copy())
    np.testing.assert_array_equal(
        got, jax_unsuper.permu_aligner(masks.copy()))
    np.testing.assert_array_equal(
        unsuper.permu_aligner(masks.transpose(0, 2, 1).copy(),
                              transpose=True), got)
    # each bin's first mask follows one source's activity
    first = np.einsum("tf,kt->kf", got[0], act[..., 0])
    assert len(set(first.argmax(0))) == 1
    for module in (unsuper, jax_unsuper):
        with pytest.raises(ValueError, match="num_bins"):
            module.permu_aligner(masks[..., :100].copy())


def test_ml_task_loss_and_gradients_match_jax():
    """sse@rnn_enh_ml's outputs and sse@enh_ml's loss and gradients (the
    Hermitian log-determinant and quadratic form through the clamped
    Cholesky) against jax.value_and_grad."""
    jtask, variables, task, mix = _ml_pair()
    task.train()
    stats = task({"mix": torch.from_numpy(mix)})
    stats["loss"].backward()

    def loss_fn(params):
        return jtask.apply({"params": params}, {"mix": jnp.asarray(mix)},
                           training=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    np.testing.assert_allclose(stats["loss"].item(), float(loss),
                               rtol=LOSS_RTOL)
    assert_trees_close(to_gradients(task.nnet), grads["nnet"], GRAD_RTOL)
    with torch.no_grad():
        obs, masks = task.nnet.eval()(torch.from_numpy(mix))
    jobs, jmasks = jtask.nnet.apply({"params": variables["params"]["nnet"]},
                                    jnp.asarray(mix), training=False)
    _close(masks.numpy(), np.asarray(jmasks), OUT_RTOL, "masks")
    jobs = np.asarray(jobs)
    _close(obs.numpy(), jobs[..., 0] + 1j * jobs[..., 1], 1e-5, "obs")
    with torch.no_grad():
        one = task.nnet.infer(torch.from_numpy(mix[0]))
    _close(one.numpy(), np.asarray(jmasks)[0], OUT_RTOL, "infer")


# -- the commands --------------------------------------------------------


def _write_corpus(root: Path, num_utts: int = 10):
    """3-channel wav.scp / text / utt2dur of delayed copies and a dict."""
    rng = np.random.default_rng(40)
    words = ["a", "b", "c", "d"]
    vocab = ["<unk>"] + words + ["<sos>", "<eos>"]
    (root / "dict").write_text("".join(f"{w} {i}\n"
                                       for i, w in enumerate(vocab)))
    with open(root / "wav.scp", "w") as scp, \
            open(root / "text", "w") as text, \
            open(root / "utt2dur", "w") as dur:
        for n in range(num_utts):
            S = 6400 + 400 * n
            wav = _multichannel(100 + n, [S])[0]
            write_audio(str(root / f"u{n}.wav"), wav, sr=SR)
            scp.write(f"u{n} {root / f'u{n}.wav'}\n")
            text.write(f"u{n} {' '.join(rng.choice(words, 2 + n % 3))}\n")
            dur.write(f"u{n} {S / SR}\n")


def _train_yaml(root: Path) -> Path:
    """1b.yaml with the toy widths and abs-mel-log-cmvn."""
    import yaml
    conf = yaml.safe_load((REPO / "examples/asr/chime4/conf/1b.yaml")
                          .read_text())
    nnet = {k: v for k, v in NNET.items()
            if k not in ("vocab_size", "sos", "eos", "ctc")}
    data = dict(wav_scp=str(root / "wav.scp"), text=str(root / "text"),
                utt2dur=str(root / "utt2dur"))
    conf.update(nnet_conf=nnet, enh_transform=ENH, asr_transform=ASR,
                data_conf=dict(fmt="am@raw",
                               loader=dict(channel=-1, min_batch_size=2,
                                           adapt_dur=0.5, min_dur=0.1,
                                           tokenizer="word"),
                               train=data, valid=data))
    conf["trainer_conf"].update(optimizer_kwargs=dict(lr=1e-3),
                                lr_scheduler="reduce_lr",
                                lr_scheduler_kwargs={}, no_impr=4)
    conf["trainer_conf"].pop("lr_scheduler_period")
    path = root / "1b.yaml"
    path.write_text(json.dumps(conf))
    return path


def test_train_am_decode_and_wer_commands(tmp_path):
    """train_am on 3-channel wavs (the 1b YAML cut to toy widths, with
    abs-mel-log-cmvn), then decode_batch with the search options of
    run.sh's stage 4 and decode (--channel -1), and compute_wer; the
    checkpoint loads in aps_tpu with the same decode_enc."""
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    from aps_tpu_torch.cmd import compute_wer, decode, decode_batch, train_am
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    _write_corpus(tmp_path)
    cpt = tmp_path / "exp"
    train_am.main(["--conf", str(_train_yaml(tmp_path)), "--dict",
                   str(tmp_path / "dict"), "--checkpoint", str(cpt),
                   "--batch-size", "4", "--epochs", "2", "--seed", "7",
                   "--device", "cpu", "--prog-interval", "2"])
    log = (cpt / "trainer.log").read_text()
    losses = [float(line.split(") = ")[1].split("/")[0])
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    args = ["--am", str(cpt), "--dict", str(tmp_path / "dict"),
            "--beam-size", "4", "--nbest", "2", "--ctc-weight", "0.4",
            "--len-norm", "true", "--max-len", "10", "--device", "cpu"]
    stats = decode_batch.main([str(tmp_path / "wav.scp"),
                               str(tmp_path / "batch.txt"),
                               "--batch-size", "3"] + args)
    assert stats["utts"] == 10
    one = decode.main([str(tmp_path / "wav.scp"), str(tmp_path / "one.txt"),
                       "--channel", "-1"] + args)
    assert one["utts"] == 10
    wer = compute_wer.main([str(tmp_path / "batch.txt"),
                            str(tmp_path / "text")])
    assert 0 <= wer["wer"] if isinstance(wer, dict) else wer is None or \
        wer >= 0
    ours = load_checkpoint(str(cpt))
    theirs = jax_load(str(cpt))
    wav = _multichannel(50, [7000, 5000])
    lens = np.array([7000, 5000])
    with torch.no_grad():
        got = ours["nnet"].decode_enc(torch.from_numpy(wav),
                                      torch.from_numpy(lens))
    want = theirs["nnet"].apply(theirs["variables"], jnp.asarray(wav),
                                jnp.asarray(lens), method="decode_enc")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i, n in enumerate(np.asarray(want[1])):
        _close(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], OUT_RTOL,
               "encoder")


def test_train_ss_and_separate_commands(tmp_path):
    """chime4_ml's 1a.yaml (cut to toy widths) through train_ss on 3-channel
    chunks without references, then separate with --channel -1: the masks
    T x F of each utterance, written as aps_tpu's separate writes them
    (a WAV file whose channels are the bins), equal to what
    cmd/separate.py's Separator gives its writer; --mode freq writes the
    same masks as .npy."""
    import importlib.util

    import yaml
    from aps_tpu_torch.cmd import separate, train_ss
    from aps_tpu_torch.io import read_audio
    conf = yaml.safe_load((REPO / "examples/sse/chime4_ml/conf/1a.yaml")
                          .read_text())
    lines = []
    for n in range(6):
        wav = _multichannel(200 + n, [9000 + 500 * n])[0]
        write_audio(str(tmp_path / f"m{n}.wav"), wav, sr=SR)
        lines.append(f"m{n} {tmp_path / f'm{n}.wav'}\n")
    (tmp_path / "mix.scp").write_text("".join(lines))
    conf.update(nnet_conf=ML_NNET, enh_transform=ML_ENH)
    conf["data_conf"]["loader"]["chunk_size"] = 8000
    conf["data_conf"]["train"]["mix_scp"] = str(tmp_path / "mix.scp")
    conf["data_conf"]["valid"]["mix_scp"] = str(tmp_path / "mix.scp")
    (tmp_path / "1a.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "exp"
    train_ss.main(["--conf", str(tmp_path / "1a.yaml"), "--checkpoint",
                   str(cpt), "--batch-size", "2", "--epochs", "2",
                   "--device", "cpu", "--num-workers", "0"])
    # (best.ckpt only after an improvement of no_impr_thres, 0.01)
    assert (cpt / "last.ckpt").is_file()
    sep = tmp_path / "enhan"
    stats = separate.main([str(tmp_path / "mix.scp"), str(sep),
                           "--checkpoint", str(cpt), "--tag", "last",
                           "--sr", str(SR), "--device", "cpu"])
    assert stats["utts"] == 6
    freq = tmp_path / "freq"
    separate.main([str(tmp_path / "mix.scp"), str(freq), "--checkpoint",
                   str(cpt), "--tag", "last", "--sr", str(SR), "--device",
                   "cpu", "--mode", "freq"])
    spec = importlib.util.spec_from_file_location(
        "aps_tpu_cmd_separate", REPO / "cmd" / "separate.py")
    jax_separate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_separate)
    jsep = jax_separate.Separator(str(cpt), cpt_tag="last")
    for n in (0, 5):
        mix = read_audio(str(tmp_path / f"m{n}.wav"), sr=SR)
        assert mix.shape[0] == C
        # what aps_tpu's command hands its writer: the masks T x F
        want = np.asarray(jsep.run(mix))
        got = read_audio(str(sep / f"m{n}.wav"), sr=SR)
        # write_audio takes the longer axis for samples
        want = want if want.shape[0] >= want.shape[1] else want.T
        want = np.clip(np.round(want * 32768), -32768, 32767) / 32768
        assert got.T.shape == want.shape
        np.testing.assert_allclose(got.T, want, atol=2.0 / 32768)
        _close(np.load(freq / f"m{n}.npy"),
               np.asarray(jsep.run(mix, mode="freq")), OUT_RTOL, "freq")
