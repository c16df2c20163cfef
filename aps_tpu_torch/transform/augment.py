#!/usr/bin/env python
"""Speed perturbation and SpecAugment masks (port of
aps_tpu/transform/augment.py: random_mask, tf_mask, perturb_speed).

The random draws are arguments: draw_spans makes them with a
torch.Generator on the batch's device (no host sync), and random_mask and
tf_mask turn them into masks, so that a test can feed in draws of its own.
The draws cannot equal aps_tpu's (jax.random is another generator); their
distributions are the same."""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Spans = Optional[Tuple[torch.Tensor, torch.Tensor]]


def draw_spans(batch: int,
               length: int,
               max_steps: int,
               num_masks: int,
               generator: Optional[torch.Generator] = None,
               device=None) -> Spans:
    """(durations, starts): batch x num_masks durations uniform in
    [1, max_steps) and uniforms in [0, 1) that place each span; None when
    no span is possible (max_steps <= 1)."""
    max_steps = min(max_steps, length)
    if max_steps <= 1:
        return None
    dur = torch.randint(1, max_steps, (batch, num_masks),
                        generator=generator, device=device)
    start = torch.rand((batch, num_masks), generator=generator,
                       device=device)
    return dur, start


def random_mask(batch: int, length: int, spans: Spans,
                device=None) -> torch.Tensor:
    """batch x length 0/1 mask with the drawn spans zeroed; a span that
    cannot fit (its duration not below length) is skipped."""
    if spans is None:
        return torch.ones((batch, length), device=device)
    dur, start = spans
    free = torch.clamp_min(length - dur, 1)
    beg = (start * free).to(torch.int32)
    pos = torch.arange(length, device=dur.device)[None, None, :]
    hit = (pos >= beg[..., None]) & (pos < (beg + dur)[..., None])
    hit = hit & (dur[..., None] < length)
    return 1.0 - hit.any(dim=1).to(torch.float32)


def mask_limits(shape: Tuple[int, int],
                pm: float = 0.0,
                ps: float = 0.0,
                max_bands: int = 30,
                max_frame: int = 40,
                num_time_masks: int = 2) -> Tuple[int, int, int]:
    """(max_bands, max_frame, num_time_masks) after the caps: the bands
    by F, and with the adaptive variant (SpecAugment on Large Scale
    Datasets) the span by ps * T and the count by pm * T."""
    T, F = shape
    max_bands = min(max_bands, F)
    if ps > 0:
        max_frame = min(max_frame, int(T * ps))
    if pm > 0:
        num_time_masks = min(num_time_masks, int(T * pm))
    return max_bands, max_frame, num_time_masks


def tf_mask(batch: int,
            shape: Tuple[int, int],
            pm: float = 0.0,
            ps: float = 0.0,
            max_bands: int = 30,
            max_frame: int = 40,
            num_freq_masks: int = 2,
            num_time_masks: int = 2,
            generator: Optional[torch.Generator] = None,
            device=None) -> torch.Tensor:
    """SpecAugment time and frequency masks: batch x T x F in {0, 1}."""
    T, F = shape
    max_bands, max_frame, num_time_masks = mask_limits(
        shape, pm, ps, max_bands, max_frame, num_time_masks)
    fmask = random_mask(batch, F, draw_spans(batch, F, max_bands,
                                             num_freq_masks, generator,
                                             device), device)
    tmask = random_mask(batch, T, draw_spans(batch, T, max_frame,
                                             num_time_masks, generator,
                                             device), device)
    return tmask[:, :, None] * fmask[:, None, :]


def perturb_speed(wav: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Polyphase resampling: N x S -> N x (S // src_sr) * dst_sr.

    weight: dst_sr x src_sr x K filter bank from speed_perturb_filter. A
    cross-correlation over the block axis (F.conv1d, as lax's
    conv_general_dilated), padded (K - 1) // 2 on the left and the rest on
    the right."""
    dst_sr, src_sr, K = weight.shape
    N, S = wav.shape
    num_blocks = S // src_sr
    if num_blocks == 0:
        raise RuntimeError(f"Input too short for speed perturb: {S}")
    # N x B x src_sr -> N x src_sr x B
    x = wav[:, :num_blocks * src_sr].reshape(N, num_blocks, src_sr)
    x = F.pad(x.transpose(1, 2), ((K - 1) // 2, K - 1 - (K - 1) // 2))
    # N x dst_sr x B -> N x B x dst_sr -> N x B * dst_sr
    y = F.conv1d(x, weight)
    return y.transpose(1, 2).reshape(N, -1)
