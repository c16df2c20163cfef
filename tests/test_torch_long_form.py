#!/usr/bin/env python
"""PyTorch port, the long-form slice as a whole: the small abs-pose
transformer AED + CTC (xfmr_abs_conf) with weights converted from aps_tpu,
against aps_tpu on the same inputs: encoder pass, batched joint
CTC/attention beam search, one asr@ctc_xent step with an Adam update, the
weight round trip, and the decode_batch / train_am commands on the CPU."""

import copy
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import transformer as jax_search  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.asr.beam_search import transformer as search  # noqa: E402
from aps_tpu_torch.asr.transformer import impl  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.flagship import (MODELS, build_flagship,  # noqa: E402
                                    xfmr_abs_conf)
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_task, aps_trainer  # noqa: E402

from test_torch_train import (assert_trees_close,  # noqa: E402
                              float64_gradients)

VOCAB = 64
# encoder outputs / logits of a 2-layer width-64 model behind a conv2d front
# end in float32: the same math in another summation order (measured ~1e-5)
ENC_ATOL = 2e-4
# the loss is an O(30) sum of float32 log-probs through a 2-layer model
LOSS_RTOL = 1e-5
# a gradient leaf sums the batch's contributions in another order; its
# bound is relative to the leaf's largest entry (at least 1)
GRAD_RTOL = 2e-4
# beam scores are length-normalised sums of ~30 log-probs
SCORE_ATOL = 1e-4
# parameters after one Adam step of rate 1e-3
STEP_ATOL = 2e-5
# output layers are scaled on both sides so candidates are well apart and
# near-ties cannot flip the ranking
PEAKY = 4.0


def _suffix_mask(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def _numpy_variables(variables, seed=5):
    """flax variables as writable numpy, batch statistics moved off their
    initial (0, 1) so that the norms are not the identity."""
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.default_rng(seed)
    for path, val in _leaves(variables.get("batch_stats", {})):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    return variables


def no_dropout_conf():
    conf = xfmr_abs_conf(VOCAB, small=True, enc_att_dropout=0.0)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    return conf


def _jax_nnet(conf):
    return jax_libs.aps_asr_nnet(conf["nnet"])(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])


@pytest.fixture(scope="module")
def long_form():
    """(flax model, numpy variables, port model, waveforms, lengths) of the
    small long-form model."""
    rng = np.random.default_rng(21)
    lens = np.array([32000, 26000])
    wav = np.zeros((2, 32000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    conf = xfmr_abs_conf(VOCAB, small=True)
    assert MODELS["xfmr_abs"][0] is xfmr_abs_conf
    nnet = _jax_nnet(conf)
    variables = nnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(wav), jnp.asarray(lens),
                          jnp.zeros((2, 4), jnp.int32),
                          jnp.asarray([4, 4]), training=False)
    variables = _numpy_variables(variables, 21)
    params = variables["params"]
    params["decoder"]["output"]["kernel"] *= PEAKY
    params["ctc_head"]["kernel"] *= PEAKY
    model = build_flagship(conf).eval()
    model.load_state_dict(to_state_dict(variables, model))
    return nnet, variables, model, wav, lens


def test_long_form_conf_is_the_abs_pose_transformer():
    full = xfmr_abs_conf(4233, small=False)["nnet_conf"]
    assert full["enc_type"] == "xfmr"
    enc = full["enc_kwargs"]
    assert (enc["pose"], enc["proj"], enc["num_layers"]) == \
        ("abs", "conv2d", 12)
    assert enc["arch_kwargs"] == {"att_dim": 256, "nhead": 4,
                                  "feedforward_dim": 2048,
                                  "pre_norm": False}
    assert full["dec_kwargs"]["num_layers"] == 6 and full["ctc"]
    model = build_flagship(xfmr_abs_conf(VOCAB, small=True))
    layer = model.encoder.encoder.layers[0]
    assert type(layer) is impl.ApsTransformerEncoderLayer
    assert type(layer.self_attn) is impl.ApsMultiheadAttention
    assert model.encoder.encoder.norm is None  # post-norm: no final norm
    train = MODELS["xfmr_abs"][1](4233)
    assert train["nnet_conf"]["enc_kwargs"]["arch_kwargs"]["att_dropout"] \
        == 0.0 and train["task"] == "asr@ctc_xent"


def test_long_form_decode_enc_matches_jax(long_form):
    nnet, variables, model, wav, lens = long_form
    want = nnet.apply(variables, jnp.asarray(wav), jnp.asarray(lens),
                      method="decode_enc")
    with torch.no_grad():
        got = model.decode_enc(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    valid = ~_suffix_mask(np.asarray(want[1]), want[0].shape[1])[..., None]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy() * valid, np.asarray(w) * valid,
                                   atol=ENC_ATOL)


def test_long_form_beam_search_matches_jax(long_form):
    """n-best tokens and scores of the batched joint CTC/attention search."""
    nnet, variables, model, wav, lens = long_form
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    kw = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=4, nbest=4,
              max_len=24, ctc_weight=0.4, allow_partial=True)
    want = jax_search.beam_search_batch(nnet, variables, batch, **kw)
    got = search.beam_search_batch(model, batch, **kw)
    assert len(got) == len(want) == 2
    for hyps_g, hyps_w in zip(got, want):
        assert len(hyps_g) == len(hyps_w) == 4
        for g, w in zip(hyps_g, hyps_w):
            assert g["trans"] == w["trans"]
            assert abs(g["score"] - w["score"]) <= SCORE_ATOL


def test_long_form_weights_round_trip(long_form):
    """flax -> port -> flax is exact; the converter refuses unmapped and
    missing keys of the new leaves too."""
    _, variables, model, _, _ = long_form
    back = to_variables(model)
    flat_a = dict(_leaves(variables))
    flat_b = dict(_leaves(back))
    assert sorted(flat_a) == sorted(flat_b)
    for path, val in flat_a.items():
        np.testing.assert_array_equal(flat_b[path], val)
    assert "params/encoder/encoder/layer_0/norm1/scale" in flat_b
    assert "params/encoder/encoder/layer_0/feedforward/Dense_0/kernel" \
        in flat_b
    enc = back["params"]["encoder"]["encoder"]
    extra = copy.deepcopy(back)
    extra["params"]["encoder"]["encoder"]["layer_0"]["norm3"] = \
        {"scale": np.ones(2)}
    with pytest.raises(KeyError, match="unmapped"):
        to_state_dict(extra, model)
    missing = copy.deepcopy(back)
    del missing["params"]["encoder"]["encoder"]["layer_1"]["norm2"]
    with pytest.raises(KeyError, match="missing"):
        to_state_dict(missing, model)
    assert "attn_0" in enc and "self_attn" not in enc["layer_0"]


TASK_CONF = dict(ctc_weight=0.2, blank=VOCAB - 1, lsm_factor=0.1)


def make_batch(seed, N=3, S=24000, L=7):
    rng = np.random.default_rng(seed)
    src_len = np.array([S, S - 3100, S - 7000][:N])
    src = np.zeros((N, S), dtype=np.float32)
    for i, n in enumerate(src_len):
        src[i, :n] = 0.1 * rng.standard_normal(n)
    tgt_len = np.array([L, L - 2, 3][:N])
    tgt = rng.integers(0, VOCAB - 3, (N, L))
    for i, n in enumerate(tgt_len):
        tgt[i, n:] = -1
    return {"src_pad": src, "src_len": src_len, "tgt_pad": tgt,
            "tgt_len": tgt_len}


def test_long_form_ctc_xent_step_matches_jax(tmp_path):
    """One asr@ctc_xent training pass of the small long-form model with
    every dropout off: loss, stats and every parameter gradient against
    aps_tpu; then one trainer step (clip + Adam) against optax."""
    conf = no_dropout_conf()
    jtask = jax_libs.aps_task("asr@ctc_xent", _jax_nnet(conf), **TASK_CONF)
    egs = make_batch(11)
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    key = jax.random.PRNGKey(0)
    rngs = {"dropout": key, "aug": key, "ss": key}
    variables = _numpy_variables(
        jtask.init(dict(rngs, params=key), jegs, training=True))
    task = aps_task("asr@ctc_xent", build_flagship(conf), **TASK_CONF)
    task.nnet.load_state_dict(to_state_dict(
        {"params": variables["params"]["nnet"],
         "batch_stats": variables["batch_stats"]["nnet"]}, task.nnet))

    def loss_fn(params):
        out, _ = jtask.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jegs, training=True, mutable=["batch_stats"], rngs=rngs)
        return out["loss"], out

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    side = copy.deepcopy(task).train()
    stats = side({k: torch.from_numpy(v) for k, v in egs.items()})
    stats["loss"].backward()
    assert sorted(stats) == sorted(want) == ["@ctc", "accu", "loss", "xent"]
    for name in want:
        np.testing.assert_allclose(stats[name].item(), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    zeros = assert_trees_close(to_gradients(side.nnet), grads["nnet"],
                               rtol=GRAD_RTOL,
                               exact=float64_gradients(task, egs))
    # the conv biases before a batch norm in training mode
    assert zeros == [
        "encoder/proj_layer/Conv2dEncoder_0/conv_0/Conv_0/bias",
        "encoder/proj_layer/Conv2dEncoder_0/conv_1/Conv_0/bias"], zeros

    # eps well above the gradients' rounding noise (see test_torch_train)
    trainer = aps_trainer("dp")(
        copy.deepcopy(task), device="cpu", checkpoint=tmp_path,
        optimizer="adam", optimizer_kwargs={"lr": 1e-3, "eps": 1e-3},
        clip_gradient=5.0, report_metrics=["loss", "accu", "@ctc", "xent"])
    assert trainer.train_one_step(dict(egs))
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(1.0, eps=1e-3))
    params = variables["params"]
    updates, _ = tx.update(grads, tx.init(params), params)
    rate = trainer.reporter.stats["rate"][-1]
    after = optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: u * rate, updates))
    got = to_variables(trainer.task.nnet)["params"]
    assert_trees_close(got, after["nnet"], atol=STEP_ATOL)
    moved = dict(_leaves(params["nnet"]))
    assert max(np.abs(v - moved[k]).max()
               for k, v in _leaves(got)) > 1e-4


def _write_dict(path):
    with open(path, "w") as fd:
        for i in range(VOCAB - 3):
            fd.write(f"{'<unk>' if i == 0 else f'w{i}'} {i}\n")
        fd.write(f"<sos> {VOCAB - 3}\n<eos> {VOCAB - 2}\n")


def test_long_form_decode_batch_command_on_the_cpu(long_form, tmp_path):
    """`aps_tpu_torch.cmd.decode_batch --device cpu` on an aps_tpu-format
    checkpoint of the small long-form model: its transcripts are those of
    aps_tpu's search on the same checkpoint."""
    from aps_tpu_torch.cmd import decode_batch
    nnet, variables, model, wav, lens = long_form
    cpt = tmp_path / "cpt"
    cpt.mkdir()
    conf = dict(xfmr_abs_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    out = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": out["params"],
                     "mstate": {"batch_stats": out["batch_stats"]},
                     "epoch": 1}, fd)
    _write_dict(tmp_path / "dict")
    with open(tmp_path / "wav.scp", "w") as scp:
        for i, n in enumerate(lens):
            write_audio(str(tmp_path / f"u{i}.wav"), wav[i, :n])
            scp.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
    best = tmp_path / "best.txt"
    stats = decode_batch.main(
        [str(tmp_path / "wav.scp"), str(best), "--am", str(cpt), "--dict",
         str(tmp_path / "dict"), "--beam-size", "4", "--ctc-weight", "0.4",
         "--max-len", "20", "--batch-size", "2", "--device", "cpu"])
    lines = best.read_text().splitlines()
    assert sorted(ln.split("\t")[0] for ln in lines) == ["u0", "u1"]
    assert all(np.isfinite(s) for s in stats["scores"].values())


def test_long_form_train_am_command_on_the_cpu(tmp_path):
    """`aps_tpu_torch.cmd.train_am --device cpu` trains the small long-form
    model (encoder att_dropout 0.1: the dense path in training, the flash
    path in validation) for two epochs; the loss falls and aps_tpu loads
    the checkpoint to the same encoder output."""
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    from aps_tpu_torch.cmd import train_am
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    rng = np.random.default_rng(40)
    words = [f"w{i}" for i in range(1, VOCAB - 3)]
    _write_dict(tmp_path / "dict")
    with open(tmp_path / "wav.scp", "w") as scp, \
            open(tmp_path / "text", "w") as text, \
            open(tmp_path / "utt2dur", "w") as dur:
        for n in range(12):
            secs = 0.6 + 0.05 * n
            write_audio(str(tmp_path / f"u{n}.wav"),
                        0.1 * rng.standard_normal(int(16000 * secs)))
            scp.write(f"u{n} {tmp_path / f'u{n}.wav'}\n")
            text.write(f"u{n} {' '.join(rng.choice(words, 2 + n % 3))}\n")
            dur.write(f"u{n} {secs:.2f}\n")
    conf = xfmr_abs_conf(VOCAB, small=True, enc_att_dropout=0.1)
    for key in ("vocab_size", "sos", "eos", "ctc"):
        conf["nnet_conf"].pop(key)  # load_am_conf takes them from the dict
    data = dict(wav_scp=str(tmp_path / "wav.scp"),
                text=str(tmp_path / "text"),
                utt2dur=str(tmp_path / "utt2dur"))
    conf.update(
        task="asr@ctc_xent", task_conf=dict(ctc_weight=0.2, lsm_factor=0.1),
        trainer_conf=dict(optimizer="adam", optimizer_kwargs={"lr": 1e-3},
                          clip_gradient=5.0,
                          report_metrics=["loss", "accu", "@ctc", "xent"]),
        data_conf=dict(fmt="am@raw",
                       loader=dict(min_batch_size=2, adapt_dur=0.7,
                                   tokenizer="word"),
                       train=data, valid=data))
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "cpt"
    trainer = train_am.main(
        ["--conf", str(tmp_path / "train.yaml"), "--dict",
         str(tmp_path / "dict"), "--checkpoint", str(cpt), "--batch-size",
         "4", "--epochs", "2", "--seed", "7", "--device", "cpu"])
    assert trainer.device.type == "cpu" and trainer.cur_step > 0
    log = (cpt / "trainer.log").read_text()
    losses = [float(line.split(") = ")[1].split("/")[0])
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    wav = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
    lens = np.array([12000, 9000])
    ours = load_checkpoint(str(cpt), "last")
    with torch.no_grad():
        got = ours["nnet"].decode_enc(torch.from_numpy(wav),
                                      torch.from_numpy(lens))
    theirs = jax_load(str(cpt), "last")
    want = theirs["nnet"].apply(theirs["variables"], jnp.asarray(wav),
                                jnp.asarray(lens), method="decode_enc")
    valid = ~_suffix_mask(np.asarray(want[1]), want[0].shape[1])[..., None]
    np.testing.assert_allclose(got[0].numpy() * valid,
                               np.asarray(want[0]) * valid, atol=ENC_ATOL)
