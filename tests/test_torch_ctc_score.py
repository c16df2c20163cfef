#!/usr/bin/env python
"""PyTorch port, CTC prefix scoring: ctc_score_step (K4) and CtcScorer
against aps_tpu on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aps_tpu.asr.beam_search.ctc import CtcScorer as JaxCtcScorer  # noqa
from aps_tpu.const import MIN_F32  # noqa: E402
from aps_tpu.ops.pallas.ctc_score import \
    ctc_score_step as jax_ctc_score_step  # noqa: E402
from aps_tpu_torch.asr.beam_search.ctc import CtcScorer  # noqa: E402
from aps_tpu_torch.ops.ctc_score import ctc_score_step  # noqa: E402

# aps_tpu solves the recursions in closed form over 32-frame blocks, the
# port walks T sequentially: float32 sums in another order on values that
# reach ~1e2 here (aps_tpu holds its own kernel to 2e-5 at this size)
CTC_ATOL, CTC_RTOL = 1e-4, 1e-5


def assert_scores_close(got, want, atol=CTC_ATOL, rtol=CTC_RTOL):
    """Entries at or below MIN_F32 / 2 on both sides are 'both
    impossible' and compare equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    impossible = (got <= MIN_F32 / 2) & (want <= MIN_F32 / 2)
    assert np.isfinite(got[~impossible]).all()
    np.testing.assert_allclose(got[~impossible], want[~impossible],
                               atol=atol, rtol=rtol)


def _operands(seed, T, L, G):
    """Scorer operands with impossible states, eos and repeat lanes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p_c = (-1 - 3 * rng.random((T, L))).astype(f32)
    gnx = np.cumsum(-2 * rng.random((T, L)), 0).astype(f32)
    gbx = np.cumsum(-2 * rng.random((T, L)), 0).astype(f32)
    gnx[:, ::5] = MIN_F32
    gbx[:2] = MIN_F32
    pb = (-0.05 - 0.5 * rng.random((T, G))).astype(f32)
    rok = (rng.random((1, L)) > 0.25).astype(f32)
    eosm = (rng.random((1, L)) > 0.8).astype(f32)
    old = (-20 * rng.random((1, L))).astype(f32)
    return p_c, gnx, gbx, pb, rok, eosm, old


# T = 45 and 70 are not multiples of aps_tpu's 32-frame blocks
@pytest.mark.parametrize("T,is_first", [(45, True), (45, False),
                                        (70, False)])
def test_ctc_score_step_plain_matches_jax(T, is_first):
    """The port's ctc_score_step (plain version on CPU) == aps_tpu's
    Pallas kernel in interpret mode, with a shared blank column."""
    ops = _operands(T, T, 24, 1)
    isf = np.full((1, 1), float(is_first), dtype=np.float32)
    # is_first as aps_tpu passes it (a 1 x 1 array) or as a Python bool
    flag = torch.from_numpy(isf) if T == 70 else is_first
    got = ctc_score_step(*map(torch.from_numpy, ops), flag)
    want = jax_ctc_score_step(*map(jnp.asarray, ops), jnp.asarray(isf),
                              interpret=True)
    for g, w in zip(got, want):
        assert_scores_close(g.numpy(), w)


def test_ctc_score_step_groups_broadcast_blank():
    """A T x G blank table (one column per utterance) == the same column
    expanded to T x L."""
    T, L, G = 33, 24, 3
    ops = list(map(torch.from_numpy, _operands(7, T, L, G)))
    got = ctc_score_step(*ops, False)
    ops[3] = ops[3].repeat_interleave(L // G, dim=1)
    want = ctc_score_step(*ops, False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with pytest.raises(ValueError):
        ctc_score_step(*ops[:3], ops[3][:, :5], *ops[4:], False)


def test_ctc_scorer_matches_jax():
    """Multi-step joint-decoding loop over 2 utterances x 3 beams with
    update_var gathers and forced eos / repeat candidates: deltas and
    states == aps_tpu's portable CtcScorer."""
    rng = np.random.default_rng(5)
    N, T, V, B, C = 2, 45, 10, 3, 4
    eos = 1
    logits = rng.standard_normal((N, T, V)).astype(np.float32)
    ref = JaxCtcScorer(jnp.asarray(logits), eos=eos, beam_size=B)
    port = CtcScorer(torch.from_numpy(logits), eos=eos, beam_size=B)
    s_ref, s_port = ref.init_state(), port.init_state()
    for a, b in zip(s_port, s_ref):
        assert_scores_close(a.numpy(), b)
    last = np.zeros(N * B, dtype=np.int64)
    for step in range(4):
        cand = rng.integers(0, V - 1, size=(N * B, C))
        if step == 2:
            cand[0, 0] = eos
            cand[1, 1] = last[1]
        d_ref, n_ref = ref(s_ref, jnp.asarray(last), jnp.asarray(cand),
                           step == 0)
        d_port, n_port = port(s_port, torch.from_numpy(last),
                              torch.from_numpy(cand), step == 0)
        assert_scores_close(d_port.numpy(), d_ref)
        for a, b in zip(n_port, n_ref):
            assert_scores_close(a.numpy(), b)
        keep = np.concatenate([
            u * B * C + rng.integers(0, B * C, size=B) for u in range(N)
        ])
        s_ref = ref.update_var(n_ref, jnp.asarray(keep))
        s_port = port.update_var(n_port, torch.from_numpy(keep))
        last = cand.reshape(-1)[keep]
