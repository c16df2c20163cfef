#!/usr/bin/env python
"""PyTorch port, streaming: the streaming STFT / iSTFT, the four streaming
base encoders, the chunked transformer and conformer encoders with their
per-layer caches, streaming_asr@ctc and streaming_asr@transducer (outputs,
the transducer's greedy and beam searches), rt_sse@dfsmn and
rt_sse@freq_xfmr (eval and training passes, infer, step, mask_predict),
the deploy runners, torch.export's export, and the rt_ctc / rt_enh step
drivers, against aps_tpu on JAX's CPU at toy widths with the weights
carried across by the converter. Offline and step by step are held
against each other where aps_tpu's own tests hold them
(tests/test_streaming.py)."""

import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import transducer as jax_search  # noqa: E402
from aps_tpu.streaming_asr.base import encoder as jax_base  # noqa: E402
from aps_tpu.streaming_asr.transformer.encoder import \
    StreamingTransformerEncoder as JaxXfmrEncoder  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu.transform import streaming as jax_streaming  # noqa: E402
from aps_tpu_torch.asr.beam_search import transducer as search  # noqa
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import (aps_asr_nnet, aps_sse_nnet,  # noqa: E402
                                aps_transform)
from aps_tpu_torch.streaming_asr.base.encoder import \
    StreamingBaseEncoder  # noqa: E402
from aps_tpu_torch.streaming_asr.transformer.encoder import \
    StreamingTransformerEncoder  # noqa: E402
from aps_tpu_torch.streaming_asr.utils import \
    compute_conv_context  # noqa: E402
from aps_tpu_torch.transform import streaming  # noqa: E402
from aps_tpu_torch.transform.utils import (forward_stft,  # noqa: E402
                                           inverse_stft)

from test_torch_sse_time import (check_model, check_task, close,  # noqa
                                 mixtures, zoo_pair)
from test_torch_transducer import (_close, _same_nbest, _scale,  # noqa
                                   _seeded, _wavs)

REPO = Path(__file__).resolve().parents[1]
# one frame's spectrum or one hop of samples, float32 against float32
STFT_ATOL = 1e-5
# encoder outputs through a few float32 layers, and step vs offline
ENC_ATOL = 2e-5
ASR_RTOL = 1e-5
VOCAB = 20
BLANK = VOCAB - 1
TRANSFORM = dict(feats="fbank-log-cmvn", frame_len=400, frame_hop=160,
                 window="hamm", num_mels=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM slows
    down 100-fold when the suite's other workers load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    if torch.is_tensor(t):
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.detach().numpy()
    return np.asarray(t)


def _apply(module, variables, *args, method=None, jit=False):
    """module.apply, eager unless jit: at the encoders' widths compiling
    costs more than it saves, for a whole model with its front end not."""
    if jit:
        return jax.jit(lambda v, *a: module.apply(v, *a, method=method))(
            variables, *args)
    return module.apply(variables, *args, method=method)


# ---------------------------------------------------------------------------
# the streaming STFT and iSTFT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,frame_len,hop,window", [
    ("librosa", 512, 256, "hann"), ("kaldi", 400, 160, "hamm")])
def test_streaming_stft_matches_jax_and_offline(mode, frame_len, hop,
                                                window):
    """Frame by frame against aps_tpu's StreamingSTFT (complex64 against
    its real pairs, and the polar form) and against the port's offline
    forward_stft."""
    wav = (0.1 * np.random.default_rng(0).standard_normal(
        (2, 4096))).astype(np.float32)
    kw = dict(window=window, mode=mode)
    port = streaming.StreamingSTFT(frame_len, hop, **kw)
    jstft = jax_streaming.StreamingSTFT(frame_len, hop, **kw)
    got = port.forward(torch.from_numpy(wav))
    np.testing.assert_allclose(_np(got), np.asarray(jstft.forward(
        jnp.asarray(wav))), atol=STFT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got), _np(forward_stft(
        torch.from_numpy(wav), frame_len, hop, **kw)), atol=STFT_ATOL,
        rtol=0)
    frame = wav[:, :port.win_length]
    polar = port.step(torch.from_numpy(frame), return_polar=True)
    want = np.asarray(jstft.step(jnp.asarray(frame), return_polar=True))
    np.testing.assert_allclose(_np(polar)[..., 0], want[..., 0],
                               atol=STFT_ATOL, rtol=0)
    # the phase where the magnitude is not at float32's floor, modulo 2 pi
    # (a real bin sits on the branch cut)
    keep = want[..., 0] > 1e-3
    turn = np.angle(np.exp(1j * (_np(polar)[..., 1] - want[..., 1])))
    assert np.abs(turn[keep]).max() <= 1e-4


def test_streaming_istft_matches_jax_and_offline():
    """Step by step with the overlap-add state and flush, against aps_tpu's
    StreamingiSTFT and, away from the edges, the port's offline
    inverse_stft (as tests/test_streaming.py holds aps_tpu)."""
    wav = (0.1 * np.random.default_rng(1).standard_normal(
        (1, 8192))).astype(np.float32)
    spec = forward_stft(torch.from_numpy(wav), 512, 256, window="sqrthann")
    port = streaming.StreamingiSTFT(512, 256, window="sqrthann")
    got = port.forward(spec)
    jistft = jax_streaming.StreamingiSTFT(512, 256, window="sqrthann")
    want = np.asarray(jistft.forward(jnp.asarray(_np(spec))))
    np.testing.assert_allclose(got.numpy(), want, atol=STFT_ATOL, rtol=0)
    offline = inverse_stft(spec, 512, 256, window="sqrthann").numpy()
    S = min(got.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(got.numpy()[:, 256:S - 512],
                               offline[:, 256:S - 512], atol=STFT_ATOL,
                               rtol=0)
    # one step from a state of aps_tpu's, in polar form
    state = port.init_state(1)
    frame = torch.stack([spec.abs(), spec.angle()], -1)[..., 3, :]
    state, out = port.step(state, frame, return_polar=True)
    jstate, jout = jistft.step(jistft.init_state(1), jnp.asarray(
        _np(frame)), return_polar=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=STFT_ATOL, rtol=0)
    np.testing.assert_allclose(state.wav_cache.numpy(),
                               np.asarray(jstate.wav_cache), atol=STFT_ATOL)


# ---------------------------------------------------------------------------
# the streaming encoders
# ---------------------------------------------------------------------------
def _conv_conf(name):
    L, kernel, stride = 2, 3, 2
    if name == "conv1d":
        return dict(inp_features=16, out_features=8, dim=32, num_layers=L,
                    kernel=kernel, stride=stride)
    return dict(inp_features=16, out_features=-1, channel=4, num_layers=L,
                kernel=kernel, stride=stride)


BASE_CONFS = {
    "pytorch_rnn": dict(inp_features=16, out_features=8, hidden=16,
                        num_layers=2, input_proj=12),
    "fsmn": dict(inp_features=16, out_features=8, dim=32, project=16,
                 num_layers=2, lctx=3, rctx=1, residual=True),
    "conv1d": _conv_conf("conv1d"),
    "conv2d": _conv_conf("conv2d"),
}


def _windows(name, T):
    """The step inputs' (begin, end) frames and aps_tpu's step-vs-offline
    rule of each encoder: RNN chunks of 4 with the state carried; FSMN
    windows of the stacked receptive field a frame apart; conv windows of
    compute_conv_context's field a hop apart."""
    if name == "pytorch_rnn":
        return [(t, t + 4) for t in range(0, T, 4)]
    if name == "fsmn":
        win = 2 * (3 + 1) + 1
        return [(t, t + win) for t in range(T - win + 1)]
    lctx, rctx, hop = compute_conv_context(2, 3, 2)
    win = lctx + rctx + 1
    return [(i * hop, i * hop + win) for i in range(4)]


@pytest.mark.parametrize("name", sorted(BASE_CONFS))
def test_base_encoder_matches_jax(name):
    """Each streaming base encoder offline and step by step against
    aps_tpu's (the RNN's state carried, the others' windows with their
    context), and step == offline as aps_tpu's tests hold it."""
    conf = BASE_CONFS[name]
    port = StreamingBaseEncoder[name](**conf).eval()
    variables = _seeded(port, 3)
    jenc = jax_base.StreamingBaseEncoder[name](**conf)
    wins = _windows(name, 12 if name == "pytorch_rnn" else 20)
    T = wins[-1][1] if name.startswith("conv") else \
        (12 if name == "pytorch_rnn" else 20)
    inp = np.random.default_rng(4).standard_normal(
        (2, T, 16)).astype(np.float32)
    with torch.no_grad():
        offline, _ = port(torch.from_numpy(inp), None)
        state, jstate, outs = None, None, []
        for beg, end in wins:
            out, state = port.step(torch.from_numpy(inp[:, beg:end]), state)
            jout, jstate = _apply(jenc, variables,
                                  jnp.asarray(inp[:, beg:end]), jstate,
                                  method="step")
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       atol=ENC_ATOL, rtol=0)
            outs.append(out)
    want, _ = _apply(jenc, variables, jnp.asarray(inp), None)
    np.testing.assert_allclose(offline.numpy(), np.asarray(want),
                               atol=ENC_ATOL, rtol=0)
    online = torch.cat(outs, 1)
    assert online.shape == offline.shape
    np.testing.assert_allclose(online.numpy(), offline.numpy(),
                               atol=ENC_ATOL, rtol=0)


XFMR_ARCH = dict(att_dim=32, nhead=4, feedforward_dim=64, att_dropout=0.0,
                 ffn_dropout=0.0)


@pytest.mark.parametrize("arch,num_layers,proj", [
    ("xfmr", 3, "linear"), ("cfmr", 2, "linear"), ("cfmr", 2, "conv2d")])
def test_streaming_xfmr_encoder_matches_jax(arch, num_layers, proj):
    """The chunked encoder offline (dense attention under the chunk-context
    mask) and step by step (per-layer key / value caches, the conformer's
    conv cache) against aps_tpu's. With the linear projection step ==
    offline, as aps_tpu's tests hold it; a conv2d projection pads each
    chunk of raw frames on its own, so there step is held to aps_tpu's
    step only."""
    chunk, lctx = 4, 2
    arch_kwargs = dict(XFMR_ARCH, kernel_size=7) if arch == "cfmr" \
        else dict(XFMR_ARCH)
    conf = dict(arch=arch, input_size=16, output_proj=8,
                num_layers=num_layers, chunk=chunk, lctx=lctx, proj=proj,
                arch_kwargs=arch_kwargs)
    if proj == "conv2d":
        conf["proj_kwargs"] = dict(conv_channels=4, num_layers=2)
    port = StreamingTransformerEncoder(**conf).eval()
    variables = _seeded(port, 5)
    jenc = JaxXfmrEncoder(**conf)
    frames = chunk * (4 if proj == "conv2d" else 1)  # raw frames a chunk
    T = 8 * frames
    inp = np.random.default_rng(6).standard_normal(
        (2, T, 16)).astype(np.float32)
    with torch.no_grad():
        offline, _ = port(torch.from_numpy(inp), None)
        state, jstate, outs = None, None, []
        for t in range(0, T, frames):
            out, state = port.step(torch.from_numpy(inp[:, t:t + frames]),
                                   state)
            jout, jstate = _apply(jenc, variables,
                                  jnp.asarray(inp[:, t:t + frames]), jstate,
                                  method="step")
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       atol=ENC_ATOL, rtol=0)
            outs.append(out)
    assert int(state["count"]) == lctx * chunk
    want, _ = _apply(jenc, variables, jnp.asarray(inp), None)
    np.testing.assert_allclose(offline.numpy(), np.asarray(want),
                               atol=ENC_ATOL, rtol=0)
    if proj == "linear":
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                                   offline.numpy(), atol=ENC_ATOL, rtol=0)
    assert port.training is False


# ---------------------------------------------------------------------------
# streaming_asr@ctc and streaming_asr@transducer
# ---------------------------------------------------------------------------
# the transducer: a chunked conformer (aishell_v1/1f's structure, with
# chunk and lctx) on a conv2d projection; the CTC models: the same encoder,
# and the FSMN of the streaming demo with the model's lctx / rctx frames
XFMR_ENC = dict(num_layers=1, chunk=4, lctx=3, proj="conv2d",
                proj_kwargs=dict(conv_channels=4, num_layers=2), pose="rel",
                pose_kwargs=dict(dropout=0.0),
                arch_kwargs=dict(att_dim=16, nhead=2, feedforward_dim=32,
                                 att_dropout=0.0, ffn_dropout=0.0,
                                 kernel_size=3, pre_norm=True))
ASR_NNETS = {
    "ctc_cfmr": ("streaming_asr@ctc", dict(
        input_size=16, vocab_size=VOCAB, enc_type="cfmr",
        enc_kwargs=XFMR_ENC)),
    "ctc_fsmn": ("streaming_asr@ctc", dict(
        input_size=16, vocab_size=VOCAB, lctx=4, rctx=4, enc_type="fsmn",
        enc_kwargs=dict(dim=24, project=12, num_layers=2, lctx=2, rctx=2,
                        norm="LN"))),
    "transducer": ("streaming_asr@transducer", dict(
        input_size=16, vocab_size=VOCAB, enc_type="cfmr",
        enc_kwargs=XFMR_ENC,
        dec_kwargs=dict(embed_size=8, jot_dim=24, hidden=16, num_layers=2,
                        dropout=0.0))),
}


def _asr_models(kind, seed=1):
    """(flax model, numpy variables, port model in eval mode), the output
    layer scaled up so that no near-tie of random weights parts the two
    packages' searches."""
    name, conf = ASR_NNETS[kind]
    port = aps_asr_nnet(name)(asr_transform=aps_transform("asr")(
        **TRANSFORM), **conf).eval()
    variables = _seeded(port, seed)
    if kind == "transducer":
        variables = _scale(port, variables, "decoder/output/kernel", 4.0)
    jnnet = jax_libs.aps_asr_nnet(name)(
        asr_transform=JaxTransform(**TRANSFORM), **conf)
    return jnnet, variables, port


@pytest.mark.parametrize("kind", sorted(ASR_NNETS))
def test_asr_models_match_jax(kind):
    """The training-path outputs (N x T x V logits of the CTC models; the
    transducer's encoder output and joint logits) and the decoding entry
    (ctc_logits, decode_enc) against aps_tpu's on a ragged batch; the
    transducer's greedy and beam searches give aps_tpu's n-best lists."""
    jnnet, variables, port = _asr_models(kind)
    wavs = _wavs(3, (8000, 6400))
    x = np.zeros((2, 8000), dtype=np.float32)
    for i, w in enumerate(wavs):
        x[i, :len(w)] = w
    lens = np.array([8000, 6400])
    args = [jnp.asarray(x), jnp.asarray(lens)]
    targs = [torch.from_numpy(x), torch.from_numpy(lens)]
    if kind == "transducer":
        y = np.random.default_rng(4).integers(0, BLANK, (2, 5))
        y[:, 0] = BLANK
        args.append(jnp.asarray(y))
        targs.append(torch.from_numpy(y))
    want = _apply(jnnet, variables, *args, jit=True)
    with torch.no_grad():
        got = port(*targs)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        for i, n in enumerate(np.asarray(want[2])):
            _close(g[i, :n].numpy(), np.asarray(w)[i, :n], ASR_RTOL)
    method = "decode_enc" if kind == "transducer" else "ctc_logits"
    want = _apply(jnnet, variables, *args[:2], method=method, jit=True)
    with torch.no_grad():
        got = getattr(port, method)(*targs[:2])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i, n in enumerate(np.asarray(want[1])):
        _close(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], ASR_RTOL)
    if kind == "transducer":
        wav = _wavs(10, (12000,))[0]
        for fn, kw in (("greedy_search", {}),
                       ("beam_search", dict(beam_size=4, nbest=3))):
            hyps = getattr(search, fn)(port, wav, **kw)
            _same_nbest([hyps], [getattr(jax_search, fn)(
                jnnet, variables, jnp.asarray(wav), **kw)])
            assert len(hyps[0]["trans"]) > 2


# ---------------------------------------------------------------------------
# rt_sse@dfsmn and rt_sse@freq_xfmr
# ---------------------------------------------------------------------------
RT_ENH = dict(feats="spectrogram-log-cmvn", frame_len=64, frame_hop=32,
              window="sqrthann", center=True)
RT_BINS = 33
RT_NNETS = {
    "rt_sse@dfsmn": dict(dim=24, num_bins=RT_BINS, num_layers=2, project=12,
                         lctx=2, rctx=1, training_mode="time"),
    "rt_sse@freq_xfmr": dict(num_bins=RT_BINS, num_layers=2, chunk=4,
                             lctx=2, training_mode="time",
                             arch_kwargs=dict(att_dim=16, nhead=2,
                                              feedforward_dim=32,
                                              att_dropout=0.0,
                                              ffn_dropout=0.0)),
}


def _rt_block(name, net):
    """A feature block for step and mask_predict: the DFSMN's 4 frames
    with the stack's context, the transformer's window of lctx chunks and
    the current one."""
    W = net.lctx_total + 4 + net.rctx_total if name == "rt_sse@dfsmn" \
        else 3 * 4
    return np.random.default_rng(7).standard_normal(
        (2, W, RT_BINS)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RT_NNETS))
def test_rt_sse_matches_jax(name):
    """The eval forward, infer in both modes and the converter's round trip
    (check_model), step (the transformer's twice, its caches carried) and
    mask_predict on a feature block, and one training pass under sse@snr
    (each gradient leaf within 5e-4 of its largest entry, the batch
    statistics; check_task) against aps_tpu's."""
    jnet, variables, net = zoo_pair(name, RT_NNETS[name], RT_ENH, seed=2)
    # an input of whole hops: the centred iSTFT gives (T - 1) hops back
    check_model(jnet, variables, net, mixtures(3, S=1216, spks=1)["mix"])
    block = _rt_block(name, net)
    with torch.no_grad():
        mask = net.mask_predict(torch.from_numpy(block))
        close(mask, _apply(jnet, variables, jnp.asarray(block),
                           method="mask_predict"))
        chunks = [block] if name == "rt_sse@dfsmn" else \
            [block[:, :4], block[:, 4:8]]
        state, jstate = None, None
        for chunk in chunks:
            got, state = net.step(torch.from_numpy(chunk), state)
            want, jstate = _apply(jnet, variables, jnp.asarray(chunk),
                                  jstate, method="step")
            close(got, want)
    if name == "rt_sse@dfsmn":
        # the block's mask, frame by frame, is the offline mask of its
        # frames (the context consumed by the valid convolutions)
        assert mask.shape == (2, 4, RT_BINS, 2)
    check_task(jnet, variables, net, "sse@snr",
               {"num_spks": 1, "permute": False},
               mixtures(4, S=1216, spks=1))


def _write_checkpoint(root: Path, conf: dict, variables: dict) -> Path:
    """conf and variables as an aps_tpu checkpoint directory."""
    root.mkdir()
    (root / "train.yaml").write_text(json.dumps(conf))
    with open(root / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {k: {"nnet": v} for k, v in variables.items()
                                if k != "params"}, "epoch": 1}, fd)
    return root


def jax_script(path: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(path).stem, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def rt_checkpoints(tmp_path_factory):
    """Both rt_sse models as checkpoints (16 kHz, 64-sample frames), and a
    short noisy wav."""
    root = tmp_path_factory.mktemp("rt_sse")
    cpts = {}
    for name, conf in RT_NNETS.items():
        port = aps_sse_nnet(name)(
            enh_transform=aps_transform("enh")(**RT_ENH), **conf).eval()
        variables = _seeded(port, 8)
        cpts[name] = (_write_checkpoint(
            root / name.split("@")[1],
            {"nnet": name, "nnet_conf": conf, "enh_transform": RT_ENH},
            variables), port)
    wav = (0.1 * np.random.default_rng(9).standard_normal(4000)).astype(
        np.float32)
    write_audio(str(root / "noisy.wav"), wav)
    (root / "wav.scp").write_text(f"noisy {root / 'noisy.wav'}\n")
    return root, cpts


@pytest.mark.parametrize("name", sorted(RT_NNETS))
def test_deploy_export_and_rt_enh(rt_checkpoints, tmp_path, name):
    """RtModel.forward_bytes and RtSeparator.enhance_bytes against
    aps_tpu.deploy's on the same checkpoint; export -> RtExported gives
    RtModel's masks; rt_enh writes what aps_tpu's demo loop writes; the
    separate command writes infer's output."""
    from aps_tpu import deploy as jax_deploy
    from aps_tpu_torch import deploy
    from aps_tpu_torch.cmd import export, rt_enh, separate
    from aps_tpu_torch.io import read_audio
    root, cpts = rt_checkpoints
    cpt, port = cpts[name]
    if not torch.cuda.is_available():
        # the runners' default device is the card
        for runner in (deploy.RtModel, deploy.RtSeparator):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                runner(str(cpt))
    block = _rt_block(name, port)[:1]
    W = block.shape[1]
    got = deploy.RtModel(str(cpt), device="cpu").forward_bytes(
        block.tobytes(), W, RT_BINS)
    want = jax_deploy.RtModel(str(cpt)).forward_bytes(block.tobytes(), W,
                                                      RT_BINS)
    assert got[1] == want[1]
    masks = np.frombuffer(got[0], dtype=np.float32)
    np.testing.assert_allclose(masks, np.frombuffer(want[0], np.float32),
                               atol=2e-5, rtol=0)
    mix = read_audio(str(root / "noisy.wav"))
    sep = deploy.RtSeparator(str(cpt), device="cpu").enhance_bytes(
        mix.tobytes(), mix.size)
    jsep = jax_deploy.RtSeparator(str(cpt)).enhance_bytes(mix.tobytes(),
                                                          mix.size)
    assert sep[1] == jsep[1]
    np.testing.assert_allclose(np.frombuffer(sep[0], np.float32),
                               np.frombuffer(jsep[0], np.float32),
                               atol=2e-5, rtol=0)
    # torch.export's program of mask_predict at 1 x W x F
    out = tmp_path / "export"
    export.main([str(cpt), str(out), "--num-frames", str(W), "--num-bins",
                 str(RT_BINS), "--device", "cpu"])
    meta = json.loads((out / "model.json").read_text())
    assert meta["input_shape"] == [1, W, RT_BINS] and meta["nnet"] == name
    assert {"nnet", "function", "input_shape", "conf"} <= set(meta)
    runner = deploy.RtExported(str(out), device="cpu")
    exported = runner.forward_bytes(block.tobytes(), W, RT_BINS)
    assert exported[1] == got[1]
    np.testing.assert_allclose(np.frombuffer(exported[0], np.float32), masks,
                               atol=1e-6, rtol=0)
    # the frame-by-frame loop against aps_tpu's demo of the model
    demo = "rt_enh_dfsmn" if name == "rt_sse@dfsmn" else \
        "rt_enh_transformer"
    argv = [str(root / "noisy.wav"), str(tmp_path / "port.wav"),
            "--checkpoint", str(cpt)]
    rt_enh.main(argv + ["--device", "cpu"])
    jdemo = jax_script(f"demos/real_time_enhancement/python/{demo}.py")
    args = jdemo.argparse.Namespace(noisy=argv[0],
                                    enhan=str(tmp_path / "jax.wav"),
                                    checkpoint=str(cpt), tag="best",
                                    sr=16000)
    jdemo.run(args)
    np.testing.assert_allclose(read_audio(str(tmp_path / "port.wav")),
                               read_audio(str(tmp_path / "jax.wav")),
                               atol=2e-5 + 1.0 / 32768, rtol=0)
    # separate takes the rt_sse@ models (the exact length: infer's output)
    separate.main([str(root / "wav.scp"), str(tmp_path / "sep"),
                   "--checkpoint", str(cpt), "--pad-grid", "1",
                   "--device", "cpu"])
    with torch.no_grad():
        want = port.infer(torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(read_audio(str(tmp_path / "sep/noisy.wav")),
                               want, atol=2e-5 + 1.0 / 32768, rtol=0)


# ---------------------------------------------------------------------------
# the commands: train_am, decode, rt_ctc
# ---------------------------------------------------------------------------
def jax_command(name: str):
    return jax_script(f"cmd/{name}.py")


def _toy_asr_corpus(root: Path, kind: str):
    """10 seeded 1 s utterances with 4 tokens each of a 17-token
    dictionary, and a train.yaml of ASR_NNETS[kind] under its task (the
    vocabulary and the blank filled in by load_am_conf)."""
    rng = np.random.default_rng(11)
    with open(root / "wav.scp", "w") as scp, \
            open(root / "text", "w") as text, \
            open(root / "utt2dur", "w") as dur:
        for i in range(10):
            path = root / f"u{i}.wav"
            write_audio(str(path), 0.1 * rng.standard_normal(16000))
            scp.write(f"u{i} {path}\n")
            text.write(f"u{i} " + " ".join(
                f"w{t}" for t in rng.integers(1, 17, 4)) + "\n")
            dur.write(f"u{i} 1.00\n")
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 17)))
    name, conf = ASR_NNETS[kind]
    conf = {k: v for k, v in conf.items() if k != "vocab_size"}
    data = {"wav_scp": str(root / "wav.scp"), "text": str(root / "text"),
            "utt2dur": str(root / "utt2dur")}
    task = "asr@transducer" if kind == "transducer" else "asr@ctc"
    (root / "train.yaml").write_text(json.dumps({
        "nnet": name, "nnet_conf": conf, "asr_transform": TRANSFORM,
        "task": task, "task_conf": {},
        "trainer_conf": {"optimizer": "adam",
                         "optimizer_kwargs": {"lr": 1e-3}},
        "data_conf": {"fmt": "am@raw", "loader": {"max_dur": 30},
                      "train": data, "valid": data}}))
    return ["--conf", str(root / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(root / "exp"), "--batch-size", "5",
            "--epochs", "1", "--device", "cpu"]


@pytest.mark.parametrize("kind", ["ctc_cfmr", "transducer"])
def test_train_am_and_decode_match_jax(tmp_path, monkeypatch, kind):
    """train_am takes both streaming models under asr@ctc and
    asr@transducer (one epoch of two steps, a finite loss, an aps_tpu
    checkpoint); decode --device cpu on it gives what aps_tpu's
    cmd/decode.py gives on the same checkpoint (streaming_asr@ctc through
    CtcApi, the transducer through its search)."""
    import math

    from aps_tpu_torch.cmd import decode, train_am
    trainer = train_am.main(_toy_asr_corpus(tmp_path, kind))
    assert trainer.cur_epoch == 1
    log = (tmp_path / "exp" / "trainer.log").read_text()
    assert math.isfinite(float(log.split("best = ")[-1].split(",")[0]))
    (tmp_path / "two.scp").write_text("".join(
        (tmp_path / "wav.scp").read_text().splitlines(True)[:2]))
    monkeypatch.syspath_prepend(str(REPO / "cmd"))
    outs = []
    for name, run in (("port", decode.run), ("jax", jax_command(
            "decode").run)):
        best = tmp_path / f"best.{name}"
        args = decode.make_parser().parse_args([
            str(tmp_path / "two.scp"), str(best), "--am",
            str(tmp_path / "exp"), "--dict", str(tmp_path / "dict"),
            "--beam-size", "4", "--device", "cpu"])
        args.data_parallel = False
        run(args)
        outs.append(sorted(best.read_text().splitlines()))
    assert outs[0] == outs[1] and len(outs[0]) == 2


def test_rt_ctc_matches_offline_and_the_demo(tmp_path, capsys):
    """rt_ctc on the FSMN CTC model (the streaming demo's structure, with
    the model's lctx / rctx context frames) prints aps_tpu's demo's
    partial-hypothesis lines, and the streamed tokens equal the greedy
    collapse of the offline ctc_logits (as tests/test_export.py holds
    aps_tpu's demo)."""
    from aps_tpu_torch.cmd import rt_ctc
    _, conf = ASR_NNETS["ctc_fsmn"]
    port = aps_asr_nnet("streaming_asr@ctc")(
        asr_transform=aps_transform("asr")(**TRANSFORM), **conf).eval()
    variables = _scale(port, _seeded(port, 12), "encoder/impl/fsmn_1/"
                       "out_proj/kernel", 4.0)
    cpt = _write_checkpoint(tmp_path / "cpt", {
        "nnet": "streaming_asr@ctc", "nnet_conf": conf,
        "asr_transform": TRANSFORM}, variables)
    wav = _wavs(13, (16000,))[0]
    write_audio(str(tmp_path / "in.wav"), wav)
    argv = [str(tmp_path / "in.wav"), "--checkpoint", str(cpt),
            "--chunk-frames", "8"]
    streamed = rt_ctc.main(argv + ["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    demo = jax_script("demos/streaming_asr/rt_ctc.py")
    demo.run(demo.argparse.Namespace(wav=argv[0], checkpoint=str(cpt),
                                     dict="", tag="best", sr=16000,
                                     chunk_frames=8))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[")]
    assert lines == want and len(lines) == 13
    from aps_tpu_torch.io import read_audio
    with torch.no_grad():
        logits, _ = port.ctc_logits(torch.from_numpy(read_audio(
            str(tmp_path / "in.wav")))[None])
    offline, prev = [], BLANK
    for tok in logits[0].argmax(-1).tolist():
        if tok != BLANK and tok != prev:
            offline.append(tok)
        prev = tok
    assert streamed == offline and len(offline) > 3
