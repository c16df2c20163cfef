#!/usr/bin/env python
"""Frame-at-a-time STFT and iSTFT with an explicit carried state (port of
aps_tpu/transform/streaming.py: StreamingSTFT, IstftState,
StreamingiSTFT).

aps_tpu builds each frame's transform from real-pair DFT matrices; here a
frame is one torch.fft.rfft (irfft back) on complex64, with the window and
the geometry of aps_tpu_torch.transform.utils, so that a frame equals the
offline forward_stft's and the overlap-added frames the offline
inverse_stft's. `step` is pure: (state, frame) -> (state, out), the state
a NamedTuple of tensors, as in aps_tpu."""

import math
from typing import NamedTuple, Tuple

import torch

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.transform.utils import _stft_geometry, _window


class StreamingSTFT(object):
    """Frame-at-a-time analysis."""

    def __init__(self,
                 frame_len: int,
                 frame_hop: int,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 normalized: bool = False,
                 mode: str = "librosa") -> None:
        self.frame_len, self.frame_hop = frame_len, frame_hop
        self.window, self.round_pow_of_two, self.mode = window, \
            round_pow_of_two, mode
        self.fft_size, self.win_length = _stft_geometry(
            frame_len, round_pow_of_two, mode)
        self.normalized = normalized
        self.num_bins = self.fft_size // 2 + 1

    def _w(self, device) -> torch.Tensor:
        return _window(self.window, self.frame_len, self.round_pow_of_two,
                       self.mode, torch.device(device))

    def step(self, frame: torch.Tensor, return_polar: bool = False,
             eps: float = EPSILON) -> torch.Tensor:
        """frame: N x (C) x win_length -> N x (C) x F complex64 (with
        return_polar N x (C) x F x 2: magnitude and phase)."""
        spec = torch.fft.rfft(frame * self._w(frame.device), n=self.fft_size)
        if self.normalized:
            spec = spec / math.sqrt(self.fft_size)
        if return_polar:
            mag = torch.sqrt(spec.real**2 + spec.imag**2 + eps)
            return torch.stack([mag, torch.angle(spec)], -1)
        return spec

    def forward(self, wav: torch.Tensor, return_polar: bool = False,
                eps: float = EPSILON) -> torch.Tensor:
        """wav: N x (C) x S -> N x (C) x F x T (x 2), one step a frame."""
        S = wav.shape[-1]
        frames = [self.step(wav[..., t:t + self.win_length],
                            return_polar=return_polar, eps=eps)
                  for t in range(0, S - self.win_length + 1,
                                 self.frame_hop)]
        return torch.stack(frames, -2 if return_polar else -1)


class IstftState(NamedTuple):
    wav_cache: torch.Tensor  # N x (win - hop)
    win_cache: torch.Tensor  # (win - hop,)


class StreamingiSTFT(object):
    """Frame-at-a-time synthesis with an overlap-add cache."""

    def __init__(self,
                 frame_len: int,
                 frame_hop: int,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 normalized: bool = False,
                 mode: str = "librosa") -> None:
        self.frame_len, self.frame_hop = frame_len, frame_hop
        self.window, self.round_pow_of_two, self.mode = window, \
            round_pow_of_two, mode
        self.fft_size, self.win_length = _stft_geometry(
            frame_len, round_pow_of_two, mode)
        self.normalized = normalized

    def _w(self, device) -> torch.Tensor:
        return _window(self.window, self.frame_len, self.round_pow_of_two,
                       self.mode, torch.device(device))

    def init_state(self, batch: int, device="cpu") -> IstftState:
        overlap = self.win_length - self.frame_hop
        return IstftState(torch.zeros((batch, overlap), device=device),
                          torch.zeros((overlap,), device=device))

    def step(self, state: IstftState, frame: torch.Tensor,
             return_polar: bool = False,
             eps: float = EPSILON) -> Tuple[IstftState, torch.Tensor]:
        """frame: N x F complex (with return_polar N x F x 2: magnitude and
        phase) -> (state, out N x frame_hop)."""
        if return_polar:
            frame = torch.polar(frame[..., 0], frame[..., 1])
        wav = torch.fft.irfft(frame, n=self.fft_size)[..., :self.win_length]
        if self.normalized:
            wav = wav * math.sqrt(self.fft_size)
        w = self._w(wav.device)
        wav = wav * w
        window = w**2
        overlap = self.win_length - self.frame_hop
        wav = torch.cat([wav[:, :overlap] + state.wav_cache,
                         wav[:, overlap:]], -1)
        window = torch.cat([window[:overlap] + state.win_cache,
                            window[overlap:]])
        new_state = IstftState(wav[:, self.frame_hop:],
                               window[self.frame_hop:])
        out = wav[:, :self.frame_hop] / (window[:self.frame_hop] + eps)
        return new_state, out

    def flush(self, state: IstftState, eps: float = EPSILON) -> torch.Tensor:
        return state.wav_cache / (state.win_cache + eps)

    def forward(self, transform: torch.Tensor, return_polar: bool = False,
                eps: float = EPSILON) -> torch.Tensor:
        """transform: N x F x T complex (x 2 polar) -> wav N x S."""
        T = transform.shape[-2 if return_polar else -1]
        state = self.init_state(transform.shape[0], transform.device)
        outs = []
        for t in range(T):
            frame = transform[..., t, :] if return_polar else \
                transform[..., t]
            state, out = self.step(state, frame, return_polar=return_polar,
                                   eps=eps)
            outs.append(out)
        outs.append(self.flush(state, eps=eps))
        return torch.cat(outs, -1)
