#!/usr/bin/env python
"""Conv-TasNet in the time and the frequency domain (port of
aps_tpu/sse/bss/tcn.py: signal_mix_consistency, GlobalChannelLayerNorm,
NormalizeLayer, ScaleLinear, Conv1dBlock, Conv1dRepeat, TimeConvTasNet
"sse@time_tcn", the folded inference path _fold_eval_block /
tcn_fused_eval, and FreqConvTasNet "sse@freq_tcn").

Layout: channel-last N x T x C inside, as in aps_tpu, so the dense layers
act on the last axis and the fused block kernel reads rows of channels; the
three convolutions (encoder, depthwise, decoder) run channel-first between
two transposes. Submodule names map onto aps_tpu's (aps_tpu_torch/convert.
py::MODULE_NAMES): the repeats are `tcn` here and "conv" there, where a
Conv1dBlock's `conv` is its "Conv_0".

"cLN" and "gLN" are the same layer (statistics over T and C), as in aps_tpu;
BatchNorm keeps aps_tpu's running statistics (biased batch variance,
momentum 0.9)."""

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm1d
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.ops.tcn import tcn_block_fused
from aps_tpu_torch.sse.base import (FreqMaskingSSE, MaskNonLinear, SSEBase,
                                    supported_nonlinear)


def signal_mix_consistency(mix: torch.Tensor, sep: List[torch.Tensor],
                           weight: Optional[List]) -> List[torch.Tensor]:
    """Project separated signals so they sum to the mixture."""
    delta = mix - sum(sep)
    if weight is None:
        return [s + delta / len(sep) for s in sep]
    return [s + delta * w for s, w in zip(sep, weight)]


def _mix_weight_by_power(mix: torch.Tensor, bss: List[torch.Tensor]) -> List:
    """The "mag" weights: each source's mean power over the plain sum of the
    mixture's samples, as aps_tpu computes them."""
    mix_sum = mix.sum(-1, keepdim=True)
    return [(s**2).mean(-1, keepdim=True) / mix_sum for s in bss]


class GlobalChannelLayerNorm(nn.Module):
    """gLN over N x T x C (statistics over T and C, biased variance)."""
    jax_params = ("gamma", "beta")

    def __init__(self, dim: int, eps: float = 1e-5,
                 elementwise_affine: bool = True):
        super(GlobalChannelLayerNorm, self).__init__()
        self.eps = eps
        if elementwise_affine:
            self.gamma = nn.Parameter(torch.ones(dim))
            self.beta = nn.Parameter(torch.zeros(dim))
        else:
            self.gamma = self.beta = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((1, 2), keepdim=True)
        var = ((x - mean)**2).mean((1, 2), keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        if self.gamma is not None:
            x = x * self.gamma + self.beta
        return x


class NormalizeLayer(nn.Module):
    """cLN | IN | gLN | BN over N x T x C."""

    def __init__(self, norm: str, num_channels: int):
        super(NormalizeLayer, self).__init__()
        if norm not in ["cLN", "IN", "gLN", "BN"]:
            raise RuntimeError(f"Unsupported normalize layer: {norm}")
        self.norm = norm
        if norm in ("cLN", "gLN"):
            self.gln = GlobalChannelLayerNorm(num_channels)
        elif norm == "BN":
            # aps_tpu's BatchNorm: epsilon 1e-5, momentum 0.9 (torch: 0.1)
            self.bnorm = BatchNorm1d(num_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm in ("cLN", "gLN"):
            return self.gln(x)
        if self.norm == "IN":
            var, mean = torch.var_mean(x, 1, unbiased=False, keepdim=True)
            return (x - mean) * torch.rsqrt(var + 1e-5)
        # every frame of the batch is one sample of the C channels
        return self.bnorm(x.reshape(-1, x.shape[-1])).view_as(x)


class ScaleLinear(nn.Module):
    """1x1 conv (a dense layer over channels) with a learnable output scale;
    scale_param 0 leaves the scale out."""
    jax_params = ("scale",)

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, scale_param: float = 1.0):
        super(ScaleLinear, self).__init__()
        self.dense = nn.Linear(in_features, out_features, bias=use_bias)
        self.scale = nn.Parameter(torch.tensor(float(scale_param))) \
            if scale_param else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dense(x)
        return out if self.scale is None else out * self.scale


class Conv1dBlock(nn.Module):
    """TasNet TCN block: 1x1 -> PReLU/norm -> dconv -> PReLU/norm -> 1x1,
    plus the residual."""

    def __init__(self, in_channels: int = 256, conv_channels: int = 512,
                 kernel_size: int = 3, dilation: int = 1, norm: str = "cLN",
                 scale_param: float = 0, causal: bool = False):
        super(Conv1dBlock, self).__init__()
        pad = dilation * (kernel_size - 1)
        self.padding = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        self.dilation, self.causal = dilation, causal
        self.linear_in = ScaleLinear(in_channels, conv_channels,
                                     scale_param=scale_param)
        # flax's PReLU starts at 0.01 (torch: 0.25)
        self.prelu_in = nn.PReLU(init=0.01)
        self.norm_in = NormalizeLayer(norm, conv_channels)
        self.conv = nn.Conv1d(conv_channels, conv_channels, kernel_size,
                              dilation=dilation, groups=conv_channels)
        self.prelu_out = nn.PReLU(init=0.01)
        self.norm_out = NormalizeLayer(norm, conv_channels)
        self.linear_out = ScaleLinear(conv_channels, in_channels,
                                      scale_param=scale_param)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """inp: N x T x C -> N x T x C"""
        out = self.norm_in(self.prelu_in(self.linear_in(inp)))
        out = self.conv(tf.pad(out.transpose(1, 2), self.padding))
        out = self.norm_out(self.prelu_out(out.transpose(1, 2)))
        return self.linear_out(out) + inp


class Conv1dRepeat(nn.Module):
    """R repeats x X dilated blocks (block_{r}_{n}), optional cross-repeat
    skip residuals (skip_{i})."""

    def __init__(self, num_repeats: int, blocks_per_repeat: int,
                 in_channels: int = 128, conv_channels: int = 128,
                 kernel_size: int = 3, norm: str = "BN",
                 skip_residual: bool = True, scaling_param: bool = False,
                 causal: bool = False):
        super(Conv1dRepeat, self).__init__()
        self.num_repeats = num_repeats
        self.blocks_per_repeat = blocks_per_repeat
        self.skip_residual = skip_residual
        skip_index = 0
        for r in range(num_repeats):
            if skip_residual:
                for i in range(r):
                    self.add_module(
                        f"skip_{skip_index + i}",
                        ScaleLinear(in_channels, in_channels,
                                    scale_param=1.0))
                skip_index += r
            for n in range(blocks_per_repeat):
                self.add_module(
                    f"block_{r}_{n}",
                    Conv1dBlock(in_channels=in_channels,
                                conv_channels=conv_channels,
                                kernel_size=kernel_size, norm=norm,
                                causal=causal, dilation=2**n,
                                scale_param=0 if scaling_param else 0.9**n))

    def block(self, r: int, n: int) -> Conv1dBlock:
        return getattr(self, f"block_{r}_{n}")

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        outputs = [inp]
        skip_index = 0
        for r in range(self.num_repeats):
            if self.skip_residual:
                for i in range(r):
                    skip = getattr(self, f"skip_{skip_index + i}")
                    inp = inp + skip(outputs[i])
                skip_index += r
            for n in range(self.blocks_per_repeat):
                inp = self.block(r, n)(inp)
            if self.skip_residual:
                outputs.append(inp)
        return inp


@ApsRegisters.sse.register("sse@time_tcn")
class TimeConvTasNet(SSEBase):
    """Time-domain Conv-TasNet (Luo & Mesgarani 2019)."""

    def __init__(self, L: int = 20, N: int = 256, X: int = 8, R: int = 4,
                 B: int = 256, H: int = 512, P: int = 3, norm: str = "BN",
                 causal: bool = False, num_spks: int = 2,
                 non_linear: str = "relu", scaling_param: bool = False,
                 skip_residual: bool = False,
                 mixture_consistency: str = "none",
                 training_mode: str = "time", enh_transform=None):
        super(TimeConvTasNet, self).__init__(enh_transform=enh_transform,
                                             training_mode=training_mode)
        assert mixture_consistency in ["none", "fix", "mag", "learn"]
        self.L, self.N, self.X, self.R, self.B, self.H, self.P = \
            L, N, X, R, B, H, P
        self.norm, self.causal, self.num_spks = norm, causal, num_spks
        self.non_linear, self.skip_residual = non_linear, skip_residual
        self.mixture_consistency = mixture_consistency
        self.mask_act = MaskNonLinear(non_linear,
                                      enable="positive_wo_softplus")
        self.encoder = nn.Conv1d(1, N, L, stride=L // 2)
        self.ln = NormalizeLayer("cLN", N)
        self.proj = nn.Linear(N, B)
        self.tcn = Conv1dRepeat(R, X, in_channels=B, conv_channels=H,
                                kernel_size=P, norm=norm,
                                skip_residual=skip_residual,
                                scaling_param=scaling_param, causal=causal)
        self.mask_prelu = nn.PReLU(init=0.01)
        self.mask_out = nn.Linear(B, num_spks * N)
        self.decoder = nn.ConvTranspose1d(N, 1, L, stride=L // 2)
        if mixture_consistency == "learn":
            self.mc_weight = nn.Linear(num_spks * N, num_spks)

    def mix_consistency(self, out, mix, bss):
        if self.mixture_consistency == "fix":
            weight = None
        elif self.mixture_consistency == "mag":
            weight = _mix_weight_by_power(mix, bss)
        else:
            w = torch.softmax(self.mc_weight(out.mean(1)), -1)
            weight = [w[:, i:i + 1] for i in range(self.num_spks)]
        return signal_mix_consistency(mix, bss, weight)

    def forward(self, mix: torch.Tensor):
        """mix: N x S -> [N x S', ...] (one tensor when num_spks is 1)"""
        self.check_args(mix, training=True, valid_dim=[2])
        # N x T x N_
        w = torch.relu(self.encoder(mix[:, None])).transpose(1, 2)
        y = self.tcn(self.proj(self.ln(w)))
        e = self.mask_out(self.mask_prelu(y))  # N x T x spks*N_
        m = torch.stack(torch.chunk(e, self.num_spks, dim=-1), 0)
        # softmax over the speaker axis 0 (when chosen)
        m = self.mask_act(m.transpose(-1, -2)).transpose(-1, -2)
        bss = [self.decoder((w * m[n]).transpose(1, 2))[:, 0]
               for n in range(self.num_spks)]
        if self.mixture_consistency != "none":
            bss = self.mix_consistency(e, mix, bss)
        return bss[0] if self.num_spks == 1 else bss

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: S -> [S', ...]; the module should be in eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        sep = self.forward(mix[None])
        return sep[0] if self.num_spks == 1 else [s[0] for s in sep]

    def make_fused_eval(self) -> Optional[Callable]:
        """Folded inference fast path over the current weights (see
        tcn_fused_eval); None when the configuration cannot be folded (then
        use the module itself)."""
        return tcn_fused_eval(self)


Folded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _fold_eval_block(blk: Conv1dBlock, eps: float = 1e-5) -> Folded:
    """Fold one eval-mode BN Conv1dBlock into float32 (kernel1 B x H, pack
    11 x H, kernel2 H x B, bias2 1 x B) for ops.tcn.tcn_block_fused:
    ScaleLinear scales into the dense kernels, running-statistics BatchNorm
    into per-channel affines, the scalar PReLU slopes broadcast to pack
    rows. A ScaleLinear without a scale folds as scale 1."""
    f32 = lambda t: t.detach().float()

    def dense(lin: ScaleLinear):
        s = 1.0 if lin.scale is None else f32(lin.scale)
        return f32(lin.dense.weight).t() * s, f32(lin.dense.bias) * s

    def affine(norm: NormalizeLayer):
        bn = norm.bnorm
        g = f32(bn.weight) * torch.rsqrt(f32(bn.running_var) + eps)
        return g, f32(bn.bias) - f32(bn.running_mean) * g

    k1, c1 = dense(blk.linear_in)
    g1, h1 = affine(blk.norm_in)
    wk = f32(blk.conv.weight)[:, 0, :]  # H x 3
    cb = f32(blk.conv.bias)
    g2, h2 = affine(blk.norm_out)
    k2, b2 = dense(blk.linear_out)
    row = lambda p: f32(p).reshape(-1).expand(g1.shape[0])
    a1, a2 = row(blk.prelu_in.weight), row(blk.prelu_out.weight)
    pack = torch.stack([c1, g1, h1, wk[:, 0], wk[:, 1], wk[:, 2], cb, g2, h2,
                        a1, a2])
    return k1.contiguous(), pack.contiguous(), k2.contiguous(), b2[None, :]


def tcn_fused_eval(nnet: TimeConvTasNet) -> Optional[Callable]:
    """Build the folded inference forward of ``sse@time_tcn`` from the
    module's current weights (on their device, in their type).

    Every eval-mode block (BatchNorm running statistics, PReLU slopes,
    ScaleLinear scales) is folded into dense + affine form and run as one
    tcn_block_fused call: on the card one hand-written kernel per block, on
    the CPU its plain version. Returns ``forward(mix: N x S) -> [N x S'] *
    num_spks`` computing what the module computes in eval mode, or None when
    the configuration cannot be folded.

    Supported: norm="BN", P=3, no skip_residual (the time_tcn defaults);
    all mixture_consistency modes and mask non-linearities. The folded
    weights are a snapshot: fold again after the module's weights change."""
    if (nnet.norm != "BN" or nnet.P != 3 or nnet.skip_residual
            or nnet.num_spks < 1):
        return None
    dtype = nnet.proj.weight.dtype
    f32 = lambda t: t.detach().float()
    blocks = []
    for r in range(nnet.R):
        for n in range(nnet.X):
            blk = nnet.tcn.block(r, n)
            k1, pack, k2, b2 = _fold_eval_block(blk)
            blocks.append((k1.to(dtype), pack, k2.to(dtype), b2,
                           blk.dilation))
    enc_w, enc_b = nnet.encoder.weight.detach(), nnet.encoder.bias.detach()
    ln_g, ln_b = f32(nnet.ln.gln.gamma), f32(nnet.ln.gln.beta)
    proj_w, proj_b = f32(nnet.proj.weight), f32(nnet.proj.bias)
    mp = nnet.mask_prelu.weight.detach()
    mo_w, mo_b = nnet.mask_out.weight.detach(), nnet.mask_out.bias.detach()
    dec_w, dec_b = nnet.decoder.weight.detach(), nnet.decoder.bias.detach()
    mc = nnet.mc_weight if nnet.mixture_consistency == "learn" else None
    act = supported_nonlinear[nnet.non_linear]
    spks, stride = nnet.num_spks, nnet.L // 2
    mc_mode, causal = nnet.mixture_consistency, nnet.causal

    def forward(mix: torch.Tensor) -> List[torch.Tensor]:
        """mix: N x S -> [N x S'] * num_spks (eval mode)."""
        w = torch.relu(tf.conv1d(mix[:, None], enc_w, enc_b,
                                 stride=stride)).transpose(1, 2)
        # the layer norm's statistics and the projection in float32
        wf = w.float()
        mean = wf.mean((1, 2), keepdim=True)
        var = ((wf - mean)**2).mean((1, 2), keepdim=True)
        y = (wf - mean) * torch.rsqrt(var + 1e-5) * ln_g + ln_b
        y = tf.linear(y, proj_w, proj_b).to(dtype)
        for k1, pack, k2, b2, dilation in blocks:
            y = tcn_block_fused(y, k1, pack, k2, b2, dilation=dilation,
                                causal=causal)
        e = tf.linear(torch.where(y >= 0, y, mp * y), mo_w, mo_b)
        m = act(torch.stack(torch.chunk(e, spks, dim=-1), 0))
        bss = [tf.conv_transpose1d((w * m[n]).transpose(1, 2), dec_w, dec_b,
                                   stride=stride)[:, 0] for n in range(spks)]
        if mc_mode == "fix":
            bss = signal_mix_consistency(mix, bss, None)
        elif mc_mode == "mag":
            bss = signal_mix_consistency(mix, bss,
                                         _mix_weight_by_power(mix, bss))
        elif mc_mode == "learn":
            wgt = torch.softmax(
                tf.linear(e.mean(1), mc.weight.detach(), mc.bias.detach()),
                -1)
            bss = signal_mix_consistency(
                mix, bss, [wgt[:, i:i + 1] for i in range(spks)])
        return bss[0] if spks == 1 else bss

    return forward


@ApsRegisters.sse.register("sse@freq_tcn")
class FreqConvTasNet(FreqMaskingSSE):
    """Frequency-domain Conv-TasNet: TCN masking on the enh transform's
    features. It runs as the module: aps_tpu folds only sse@time_tcn, so
    no block kernel launches here."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 in_features: int = 257,
                 B: int = 6,
                 K: int = 3,
                 N: int = 3,
                 conv_channels: int = 512,
                 proj_channels: int = 256,
                 norm: str = "BN",
                 num_spks: int = 2,
                 num_bins: int = 257,
                 non_linear: str = "relu",
                 causal: bool = False,
                 scaling_param: bool = False,
                 skip_residual: bool = False,
                 training_mode: str = "freq"):
        super(FreqConvTasNet, self).__init__(enh_transform=enh_transform,
                                             num_spks=num_spks,
                                             training_mode=training_mode)
        self.proj = nn.Linear(in_features, proj_channels)
        # N repeats of B blocks (aps_tpu's "conv")
        self.tcn = Conv1dRepeat(N, B, in_channels=proj_channels,
                                conv_channels=conv_channels, kernel_size=K,
                                causal=causal, scaling_param=scaling_param,
                                skip_residual=skip_residual, norm=norm)
        self.mask_prelu = nn.PReLU(init=0.01)
        self.mask_out = nn.Linear(proj_channels, num_bins * num_spks)
        self.mask_act = MaskNonLinear(non_linear, enable="common")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T, ...]"""
        x = self.tcn(self.proj(feats))
        m = self.mask_out(self.mask_prelu(x))
        # N x T x S*F -> N x S*F x T
        masks = self.mask_act(m.transpose(-1, -2))
        return list(torch.chunk(masks, self.num_spks, dim=-2))
