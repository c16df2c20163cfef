#!/usr/bin/env python
"""PyTorch port, objective functions and task helpers: ce_objf, ls_objf
(uniform and unigram), ctc_objf, prep_asr_label, compute_accu and the
learning-rate schedulers against aps_tpu on the same numpy inputs, values
and gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.task import asr as jax_task  # noqa: E402
from aps_tpu.task import objf as jax_objf  # noqa: E402
from aps_tpu.trainer import lr as jax_lr  # noqa: E402
from aps_tpu_torch.task import asr as task  # noqa: E402
from aps_tpu_torch.task import objf  # noqa: E402
from aps_tpu_torch.trainer import lr  # noqa: E402

# losses are O(10) sums of N x T float32 log-probs in another order
LOSS_RTOL = 2e-6
# gradients of those losses w.r.t. O(1) logits
GRAD_ATOL = 2e-6
# CTC: log-space forward-backward over T = 40 frames; optax and PyTorch
# run different recursions (optax in a scan with log_epsilon clamps)
CTC_RTOL = 1e-5
CTC_GRAD_ATOL = 1e-5


def _logits_and_targets(seed=0, N=3, T=9, V=17):
    rng = np.random.default_rng(seed)
    outs = rng.standard_normal((N, T, V)).astype(np.float32) * 2
    tgts = rng.integers(0, V, (N, T))
    tgts[1, 6:] = -1
    tgts[2, 3:] = -1
    return outs, tgts


def _both(fn_t, fn_j, outs, *args_t_j, **kw):
    """(value, grad w.r.t. outs) from the port and from aps_tpu."""
    x = torch.from_numpy(outs).requires_grad_()
    val_t = fn_t(x, *[torch.from_numpy(np.asarray(a)) for a in args_t_j],
                 **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in kw.items()})
    val_t.backward()
    val_j, grad_j = jax.value_and_grad(
        lambda o: fn_j(o, *[jnp.asarray(a) for a in args_t_j],
                       **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                              else v) for k, v in kw.items()}))(
                                  jnp.asarray(outs))
    return val_t.item(), x.grad.numpy(), float(val_j), np.asarray(grad_j)


@pytest.mark.parametrize("reduction", ["mean", "batchmean"])
def test_ce_objf_matches_jax(reduction):
    outs, tgts = _logits_and_targets()
    vt, gt, vj, gj = _both(objf.ce_objf, jax_objf.ce_objf, outs, tgts,
                           reduction=reduction)
    np.testing.assert_allclose(vt, vj, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gt, gj, atol=GRAD_ATOL)


@pytest.mark.parametrize("method,reduction", [("uniform", "mean"),
                                              ("uniform", "batchmean"),
                                              ("unigram", "mean"),
                                              ("unigram", "batchmean")])
def test_ls_objf_matches_jax(method, reduction):
    outs, tgts = _logits_and_targets(1)
    kw = dict(method=method, reduction=reduction, lsm_factor=0.1)
    if method == "unigram":
        kw["label_count"] = np.random.default_rng(2).integers(
            1, 50, outs.shape[-1]).astype(np.float32)
    vt, gt, vj, gj = _both(objf.ls_objf, jax_objf.ls_objf, outs, tgts, **kw)
    np.testing.assert_allclose(vt, vj, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gt, gj, atol=GRAD_ATOL)


def test_ls_objf_refuses_bad_arguments():
    outs, tgts = map(torch.from_numpy, _logits_and_targets())
    with pytest.raises(ValueError, match="smoothing"):
        objf.ls_objf(outs, tgts, method="other")
    with pytest.raises(RuntimeError, match="label_count"):
        objf.ls_objf(outs, tgts, method="unigram",
                     label_count=torch.ones(3))


@pytest.mark.parametrize("reduction", ["mean", "batchmean"])
def test_ctc_objf_matches_jax(reduction):
    """Ragged input and target lengths, IGNORE_ID padded targets, repeated
    labels, the blank at the last id."""
    rng = np.random.default_rng(3)
    N, T, V, L = 4, 40, 12, 9
    outs = rng.standard_normal((N, T, V)).astype(np.float32) * 2
    tgts = rng.integers(0, V - 1, (N, L))
    tgts[0, 3] = tgts[0, 2]  # a repeat needs a blank between
    tgt_len = np.array([9, 6, 1, 4])
    for n, ln in enumerate(tgt_len):
        tgts[n, ln:] = -1
    out_len = np.array([40, 31, 7, 22])
    vt, gt, vj, gj = _both(objf.ctc_objf, jax_objf.ctc_objf, outs, tgts,
                           out_len, tgt_len, blank=V - 1,
                           reduction=reduction)
    np.testing.assert_allclose(vt, vj, rtol=CTC_RTOL)
    np.testing.assert_allclose(gt, gj, atol=CTC_GRAD_ATOL)
    # frames past out_len get no gradient
    assert np.count_nonzero(gt[2, 7:]) == 0


def test_ctc_objf_impossible_alignment_is_dropped():
    """A target longer than its input cannot align: PyTorch gives inf, which
    the port zeroes with a zero gradient (aps_tpu's optax clamps it at
    about 1e5 instead, so such a batch is not comparable)."""
    rng = np.random.default_rng(4)
    outs = torch.from_numpy(rng.standard_normal((2, 6, 5)).astype(
        np.float32)).requires_grad_()
    tgts = torch.tensor([[1, 2, 3, 1, 2, 3], [1, 2, -1, -1, -1, -1]])
    out_len, tgt_len = torch.tensor([3, 6]), torch.tensor([6, 2])
    loss = objf.ctc_objf(outs, tgts, out_len, tgt_len, blank=4,
                         reduction="batchmean")
    alone = objf.ctc_objf(outs[1:], tgts[1:], out_len[1:], tgt_len[1:],
                          blank=4, reduction="batchmean")
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(outs.grad).all()
    np.testing.assert_allclose(loss.item() * 2, alone.item(), rtol=1e-6)
    assert torch.count_nonzero(outs.grad[0]) == 0


@pytest.mark.parametrize("pad,sos,eos", [(7, 5, 6), (-1, -1, 6), (6, 5, -1)])
def test_prep_asr_label_matches_jax(pad, sos, eos):
    tgt = np.array([[1, 2, 3, -1], [4, -1, -1, -1], [1, 1, 2, 2]])
    tgt_len = np.array([3, 1, 4])
    got = task.prep_asr_label(torch.from_numpy(tgt),
                              torch.from_numpy(tgt_len), pad, sos_value=sos,
                              eos_value=eos)
    want = jax_task.prep_asr_label(jnp.asarray(tgt), jnp.asarray(tgt_len),
                                   pad, sos_value=sos, eos_value=eos)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compute_accu_matches_jax():
    outs, tgts = _logits_and_targets(5)
    tgts[0, :4] = outs[0, :4].argmax(-1)
    got = task.compute_accu(torch.from_numpy(outs), torch.from_numpy(tgts))
    want = jax_task.compute_accu(jnp.asarray(outs), jnp.asarray(tgts))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert got[1].item() == int(want[1])


def test_load_label_count_matches_jax(tmp_path):
    path = tmp_path / "label_count"
    path.write_text("a 3\nb 0\nc 12\n")
    np.testing.assert_array_equal(
        task.load_label_count(str(path)).numpy(),
        np.asarray(jax_task.load_label_count(str(path))))
    assert task.load_label_count("") is None


def test_ctc_task_runs_on_an_encoder_only_model():
    """asr@ctc on a stand-in model with the (enc_out, enc_ctc, enc_len)
    forward: the loss is ctc_objf of its logits."""
    from aps_tpu_torch.libs import aps_task

    class Encoder(torch.nn.Module):

        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(4, 6)

        def forward(self, x, x_len):
            return x, self.proj(x), x_len

    rng = np.random.default_rng(6)
    egs = {"src_pad": torch.from_numpy(rng.standard_normal(
        (2, 12, 4)).astype(np.float32)),
           "src_len": torch.tensor([12, 9]),
           "tgt_pad": torch.tensor([[1, 2, 3], [4, 4, -1]]),
           "tgt_len": torch.tensor([3, 2])}
    nnet = Encoder()
    got = aps_task("asr@ctc", nnet, blank=5, reduction="mean")(egs)
    want = objf.ctc_objf(nnet.proj(egs["src_pad"]), egs["tgt_pad"],
                         egs["src_len"], egs["tgt_len"], blank=5,
                         reduction="mean")
    assert got["loss"].item() == want.item()
    with pytest.raises(ValueError, match="reduction"):
        aps_task("asr@ctc", nnet, reduction="sum")


SCHEDULERS = [
    ("reduce_lr", dict(lr=1e-3, patience=1, threshold=1e-3)),
    ("step_lr", dict(lr=1e-3, step_size=3)),
    ("multi_step_lr", dict(lr=1e-3, milestones=[2, 5])),
    ("warmup_noam_lr", dict(peak_lr=1e-3, warmup=4)),
    ("warmup_noam_lr", dict(factor=2.0, att_dim=64, warmup=4)),
    ("warmup_exp_decay_lr", dict(time_stamps=[2, 4, 9], peak_lr=1e-3)),
    ("warmup_linear_decay_lr", dict(time_stamps=[2, 4, 9], peak_lr=1e-3)),
    ("warmup_cos_decay_lr", dict(time_stamps=[2, 4, 9], peak_lr=1e-3)),
    ("warmup_power_decay_lr", dict(time_stamps=[2, 4, 9], peak_lr=1e-3,
                                   power=3)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULERS)
def test_lr_scheduler_matches_jax(name, kwargs):
    """Twelve steps of every scheduler (reduce_lr fed a plateauing loss)
    give aps_tpu's rates exactly, and the state round-trips."""
    got, want = lr.LrScheduler[name](**kwargs), \
        jax_lr.LrScheduler[name](**kwargs)
    values = [1.0, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]
    for value in values:
        assert got.get_lr() == want.get_lr()
        got.step(value)
        want.step(value)
    again = lr.LrScheduler[name](**kwargs)
    again.load_state_dict(got.state_dict())
    assert again.get_lr() == want.get_lr()
    assert again.step_count == want.step_count
