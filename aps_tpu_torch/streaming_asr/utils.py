#!/usr/bin/env python
"""The context of a streaming conv stack (port of
aps_tpu/streaming_asr/utils.py: ConvParam, compute_conv_context)."""

from typing import List, Tuple, Union


class ConvParam(object):
    """Kernel/stride/dilation bookkeeping for one conv layer."""

    def __init__(self,
                 kernel: int,
                 stride: int = 1,
                 dilation: int = 1,
                 prev_param=None):
        self.kernel = kernel
        self.stride = stride * (prev_param.stride if prev_param else 1)
        ctx = (kernel - 1) * dilation
        prev_stride = prev_param.stride if prev_param else 1
        prev_ctx = prev_param.ctx if prev_param else 0
        self.ctx = prev_ctx + ctx * prev_stride

    @property
    def context(self) -> Tuple[int, int]:
        lctx = self.ctx // 2
        return (lctx, self.ctx - lctx)


def compute_conv_context(num_layers: int,
                         kernel: Union[List[int], int],
                         stride: Union[List[int], int],
                         dilation: Union[List[int], int] = 1):
    """Total (lctx, rctx, stride) of a conv stack in input frames."""

    def int2list(param, repeat):
        return [param] * repeat if isinstance(param, int) else list(param)

    kernel = int2list(kernel, num_layers)
    stride = int2list(stride, num_layers)
    dilation = int2list(dilation, num_layers)
    param = None
    for i in range(num_layers):
        param = ConvParam(kernel[i], stride=stride[i],
                          dilation=dilation[i], prev_param=param)
    lctx, rctx = param.context
    return lctx, rctx, param.stride
