"""Differentiable convolutions on the port's kernels (counterparts of the
custom VJPs of mvsnet_tpu/ops/pallas/conv3d.py:1357-1458,
deconv3d.py:256-318, conv2d.py:618-664, :927-951 and deconv2d.py:245-269).

Every gradient runs on a kernel: with the flip + channel swap
q(k)[t, co, ci] = k[K-1-t, ci, co],
- a stride-1 conv's dx is the stride-1 conv of g with q(k) (conv kernel);
- a stride-2 conv's dx is the stride-2 transposed conv of g with q(k), at
  the conv's low pads and the input's size (deconv kernel, K = 3 or 5);
- a transposed conv's dx is the stride-2 SAME conv of g with q(k);
- dk of a conv is the weight gradient of x and g (wgrad kernel); dk of a
  transposed conv is q of the stride-2 weight gradient with the roles
  swapped, <deconv(x, k), g> = <x, conv_s2(g, q(k))> (deconv3d.py:292-303).
As in the JAX backward, the cotangent is cast to the compute dtype first
(`g.astype(x.dtype)`) and dk leaves in the kernel's dtype, so a float32
parameter receives a rounded bfloat16 dk. dx is computed only when the
input needs it (the two convs on the images skip it).
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k
from mvsnet_tpu_torch.ops.kernels import wgrad as wgrad_k


def flip_swap(kernel):
    """q(k): every spatial axis flipped, input and output channels swapped."""
    rank = kernel.ndim - 2
    return kernel.flip(list(range(rank))).transpose(-1, -2).contiguous()


def conv_input_grad(g, kernel, stride: int, in_spatial):
    """dx of the SAME conv of an input of spatial size `in_spatial`."""
    q = flip_swap(kernel)
    if stride == 1:
        return conv_k.conv(g, q, None, 1)
    ks = kernel.shape[:-2]
    los = [conv_k.same_pads(n, k, 2)[0] for n, k in zip(in_spatial, ks)]
    return deconv_k.deconv(g, q, lo=los, out_spatial=tuple(in_spatial))


class ConvFn(torch.autograd.Function):
    """SAME conv without bias or activation, x and kernel in one dtype."""

    @staticmethod
    def forward(ctx, x, kernel, stride: int):
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        return conv_k.conv(x, kernel, None, stride)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv_input_grad(g, kernel, ctx.stride, x.shape[1:-1])
        if ctx.needs_input_grad[1]:
            dk = wgrad_k.wgrad(x, g, kernel.shape[:-2], ctx.stride).to(kernel.dtype)
        return dx, dk, None


class DeconvFn(torch.autograd.Function):
    """flax k3 s2 SAME transposed conv without bias or activation."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return deconv_k.deconv(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv_k.conv(g, flip_swap(kernel), None, 2)
        if ctx.needs_input_grad[1]:
            dq = wgrad_k.wgrad(g, x, kernel.shape[:-2], 2)
            dk = flip_swap(dq).to(kernel.dtype)
        return dx, dk

