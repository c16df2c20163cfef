#!/usr/bin/env python
"""PyTorch port, CTC prefix scoring: ctc_score_step (K4) and CtcScorer
against aps_tpu on the same numpy inputs, the parent beams' operands passed
unexpanded, and a numpy emulation of the CUDA kernel's chunked scan over T
(csrc/ctc_score.cu) against the plain version."""

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


def _operands(seed, T, L, G, P=None):
    """Scorer operands with impossible states, eos and repeat lanes; the
    parent's gammas and scores over P columns (default L)."""
    P = L if P is None else P
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p_c = (-1 - 3 * rng.random((T, L))).astype(f32)
    gnx = np.cumsum(-2 * rng.random((T, P)), 0).astype(f32)
    gbx = np.cumsum(-2 * rng.random((T, P)), 0).astype(f32)
    gnx[:, ::5] = MIN_F32
    gbx[:2] = MIN_F32
    pb = (-0.05 - 0.5 * rng.random((T, G))).astype(f32)
    rok = (rng.random((1, L)) > 0.25).astype(f32)
    eosm = (rng.random((1, L)) > 0.8).astype(f32)
    old = (-20 * rng.random((1, P))).astype(f32)
    return p_c, gnx, gbx, pb, rok, eosm, old


def _expand(ops):
    """The parent columns of gamma_nx, gamma_bx and old_score repeated to
    the lanes, as aps_tpu's ctc_score_step takes them."""
    p_c, gnx, gbx, pb, rok, eosm, old = ops
    C = p_c.shape[1] // gnx.shape[1]
    rep = lambda x: np.repeat(x, C, axis=1)  # noqa: E731
    return p_c, rep(gnx), rep(gbx), pb, rok, eosm, rep(old)


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


@pytest.mark.parametrize("T,G,is_first", [(1, 1, True), (33, 4, False),
                                          (45, 1, True)])
def test_ctc_score_step_reads_parent_columns(T, G, is_first):
    """gamma_nx, gamma_bx and old_score over P = L / C parent columns (lane
    l reads column l / C) == the same operands expanded to the lanes, and
    == aps_tpu's Pallas kernel (interpret mode) on the expanded inputs with
    the blank column broadcast."""
    C, P = 12, 4
    L = C * P
    ops = _operands(T + G, T, L, G, P)
    full = _expand(ops)
    got = ctc_score_step(*map(torch.from_numpy, ops), is_first)
    want = ctc_score_step(*map(torch.from_numpy, full), is_first)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    pb = np.repeat(full[3], L // G, axis=1)
    isf = np.full((1, 1), float(is_first), dtype=np.float32)
    for lo in range(0, L, L // G):  # aps_tpu's kernel takes one blank column
        cols = slice(lo, lo + L // G)
        part = [x[:, cols] for x in full[:3]] + [pb[:, lo:lo + 1]] + \
            [x[:, cols] for x in full[4:]]
        ref = jax_ctc_score_step(*map(jnp.asarray, part), jnp.asarray(isf),
                                 interpret=True)
        for g, w in zip(got, ref):
            assert_scores_close(g[:, cols].numpy(), w)
    with pytest.raises(ValueError, match="gamma_nx"):
        ctc_score_step(*map(torch.from_numpy, ops[:1]),
                       torch.zeros((T, 5)), torch.zeros((T, 5)),
                       *map(torch.from_numpy, ops[3:]), is_first)
    with pytest.raises(ValueError, match="old_score"):
        ctc_score_step(*map(torch.from_numpy, ops[:6]), torch.zeros((1, L)),
                       is_first)


# ---- numpy emulation of csrc/ctc_score.cu's chunked scan ----

_NEG = np.float32(-np.inf)


def _log_add(a, b):
    """logaddexp that keeps -inf (+) -inf at -inf, as the kernel's."""
    with np.errstate(invalid="ignore", over="ignore"):
        m = np.maximum(a, b)
        r = m + np.log1p(np.exp(-np.abs(a - b)))
    return np.where(m == _NEG, m, r).astype(np.float32)


def _after(b, a):
    """The frame map b (xx, yx, yy, vx, vy) after the map a: x -> (xx + x)
    (+) vx, y -> (yx + x) (+) (yy + y) (+) vy."""
    bxx, byx, byy, bvx, bvy = b
    axx, ayx, ayy, avx, avy = a
    return (bxx + axx, _log_add(byx + axx, byy + ayx), byy + ayy,
            _log_add(bxx + avx, bvx),
            _log_add(_log_add(byx + avx, byy + avy), bvy))


def _chunked_scan(p_c, gnx, gbx, pb, rok, eosm, old, is_first, W):
    """The kernel's three phases over W chunks of ceil(T / W) frames, all
    lanes at once: (1) each chunk's composed map and (max, sum) of a_t, (2)
    an inclusive Hillis-Steele scan of the maps over the chunks, the carried
    state being the offset of the chunks before, (3) the serial recurrence
    with the MIN_F32 clamps over each chunk from its carried state."""
    f32 = np.float32
    T, L = p_c.shape
    lane = np.arange(L)
    col = lane // (L // gnx.shape[1])
    gnx, gbx, old = gnx[:, col], gbx[:, col], old[:, col]
    pb = pb[:, lane // (L // pb.shape[1])]
    a = np.empty((T, L), f32)
    a[0] = p_c[0] if is_first else MIN_F32
    a[1:] = _log_add(gbx[:-1], np.where(rok[0] > 0, gnx[:-1],
                                        f32(MIN_F32))) + p_c[1:]
    per = -(-T // W)
    bounds = [(min(T, j * per), min(T, (j + 1) * per)) for j in range(W)]
    maps, sums = [], []
    for t0, t1 in bounds:
        xx, yy = np.zeros(L, f32), np.zeros(L, f32)
        yx, vx, vy = (np.full(L, _NEG) for _ in range(3))
        m, s = np.full(L, _NEG), np.zeros(L, f32)
        for t in range(t0, t1):
            yx = pb[t] + _log_add(xx, yx)
            vy = pb[t] + _log_add(vx, vy)
            vx = _log_add(p_c[t] + vx, a[t])
            xx, yy = p_c[t] + xx, pb[t] + yy
            with np.errstate(invalid="ignore", over="ignore"):
                s = np.where(a[t] > m, s * np.exp(m - a[t]) + 1,
                             s + np.exp(a[t] - m)).astype(f32)
            m = np.maximum(m, a[t])
        maps.append((xx, yx, yy, vx, vy))
        sums.append((m, s))
    off = 1
    while off < W:
        maps = [_after(maps[j], maps[j - off]) if j >= off else maps[j]
                for j in range(W)]
        off *= 2
    gamma_n, gamma_b = np.empty((T, L), f32), np.empty((T, L), f32)
    for j, (t0, t1) in enumerate(bounds):
        x, y = (np.full(L, _NEG), np.full(L, _NEG)) if j == 0 else \
            maps[j - 1][3:]
        for t in range(t0, t1):
            x, y = (np.maximum(_log_add(x + p_c[t], a[t]), MIN_F32),
                    np.maximum(_log_add(y + pb[t], x + pb[t]), MIN_F32))
            gamma_n[t], gamma_b[t] = x, y
    m = np.max([mj for mj, _ in sums], axis=0)
    with np.errstate(invalid="ignore", over="ignore"):
        s = sum(np.where(mj == _NEG, 0, sj * np.exp(mj - m))
                for mj, sj in sums)
        score = np.maximum(m + np.log(s), MIN_F32).astype(f32)
    score = np.where(eosm[0] > 0, _log_add(gbx[-1], gnx[-1]), score)[None]
    return gamma_n, gamma_b, score, score - old


@pytest.mark.parametrize("T", [1, 7, 233])
@pytest.mark.parametrize("W", [4, 32])
def test_chunked_scan_emulation_matches_plain(T, W):
    """The kernel's algebra (compose frame maps in the semiring, scan them
    over the chunks, walk each chunk again with the clamps) == the plain
    serial recursion, with chunks that hold no frame (T < W), parent
    columns read in place and both is_first; impossible states stay
    finite."""
    for is_first in (True, False):
        ops = _operands(T + W, T, 24, 2, 6)
        got = _chunked_scan(*ops, is_first, W)
        want = ctc_score_step(*map(torch.from_numpy, ops), is_first)
        for g, w in zip(got, want):
            assert_scores_close(g, w.numpy())


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
