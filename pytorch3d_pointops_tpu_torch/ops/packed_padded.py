"""Packed <-> padded conversions as differentiable ops, in PyTorch.

The port of ``pytorch3d_pointops_tpu/ops/packed_padded.py``. Both directions
are gathers whose indices come from ``first_idxs`` (the packed row where
each cloud starts), so plain PyTorch serves on every device; the JAX
package has no Pallas kernel here either. Each direction's gradient is the
other direction, wired with a pair of ``torch.autograd.Function``s as the
JAX package wires its ``custom_vjp`` pair.
"""

from __future__ import annotations

import torch

from .. import tracing


def _packed_to_padded_2d(inputs: torch.Tensor, first_idxs: torch.Tensor,
                         max_size: int) -> torch.Tensor:
    """(F, D) packed -> (N, max_size, D) padded; rows past each cloud's size
    are zero."""
    F, D = inputs.shape
    N = first_idxs.shape[0]
    if F == 0:
        return inputs.new_zeros((N, max_size, D))
    sizes = torch.diff(first_idxs, append=first_idxs.new_tensor([F]))
    p = torch.arange(max_size, device=inputs.device)
    gather_idx = (first_idxs[:, None] + p[None, :]).clamp(0, F - 1)
    valid = p[None, :] < sizes[:, None]
    return torch.where(valid[..., None], inputs[gather_idx], 0.0)


def _padded_to_packed_2d(inputs: torch.Tensor, first_idxs: torch.Tensor,
                         num_inputs: int) -> torch.Tensor:
    """(N, max_size, D) padded -> (num_inputs, D) packed."""
    f = torch.arange(num_inputs, device=inputs.device)
    n_of_f = torch.searchsorted(first_idxs, f, right=True) - 1
    p_of_f = f - first_idxs[n_of_f]
    return inputs[n_of_f, p_of_f]


class _PackedToPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, first_idxs, max_size):
        ctx.save_for_backward(first_idxs)
        ctx.num_inputs = inputs.shape[0]
        return _packed_to_padded_2d(inputs, first_idxs, max_size)

    @staticmethod
    @tracing.spanned("PackedToPadded.bwd")
    def backward(ctx, grad_out):
        (first_idxs,) = ctx.saved_tensors
        return _padded_to_packed_2d(grad_out, first_idxs, ctx.num_inputs), None, None


class _PaddedToPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, first_idxs, num_inputs):
        ctx.save_for_backward(first_idxs)
        ctx.max_size = inputs.shape[1]
        return _padded_to_packed_2d(inputs, first_idxs, num_inputs)

    @staticmethod
    @tracing.spanned("PaddedToPacked.bwd")
    def backward(ctx, grad_out):
        (first_idxs,) = ctx.saved_tensors
        return _packed_to_padded_2d(grad_out, first_idxs, ctx.max_size), None, None


def _first_idxs(first_idxs, device) -> torch.Tensor:
    return torch.as_tensor(first_idxs, device=device).to(torch.int64).contiguous()


@tracing.spanned("packed_to_padded")
def packed_to_padded(inputs: torch.Tensor, first_idxs, max_size: int) -> torch.Tensor:
    """Convert a packed (F,) or (F, ...) tensor to padded (N, max_size, ...).

    ``first_idxs[i]`` is the packed row where batch element i starts; rows
    past a cloud's size are zero. Differentiable; the gradient is
    ``padded_to_packed``. Raises ``ValueError`` if ``max_size`` is not an
    int.
    """
    input_shape = inputs.shape
    n_dims = inputs.dim()
    if n_dims == 1:
        inputs = inputs[:, None]
    else:
        inputs = inputs.reshape(input_shape[0], -1)
    first_idxs = _first_idxs(first_idxs, inputs.device)
    if not isinstance(max_size, int):
        raise ValueError("max_size has to be int.")
    out = _PackedToPadded.apply(inputs, first_idxs, max_size)
    if n_dims == 1:
        return out[..., 0]
    if n_dims == 2:
        return out
    return out.reshape(*out.shape[:2], *input_shape[1:])


@tracing.spanned("padded_to_packed")
def padded_to_packed(inputs: torch.Tensor, first_idxs, num_inputs: int,
                     max_size_dim: int = 1) -> torch.Tensor:
    """Convert a padded (N, ..., max_size, ...) tensor to packed (F, ...).

    ``max_size_dim`` names the padded dimension, moved next to the batch
    dimension first. Differentiable; the gradient is ``packed_to_padded``.
    Raises ``ValueError`` if ``num_inputs`` is not an int.
    """
    n_dims = inputs.dim()
    inputs = torch.movedim(inputs, max_size_dim, 1)
    input_shape = inputs.shape
    if n_dims == 2:
        inputs = inputs[..., None]
    else:
        inputs = inputs.reshape(*input_shape[:2], -1)
    first_idxs = _first_idxs(first_idxs, inputs.device)
    if not isinstance(num_inputs, int):
        raise ValueError("num_inputs has to be int.")
    out = _PaddedToPacked.apply(inputs, first_idxs, num_inputs)
    if n_dims == 2:
        return out[..., 0]
    return out.reshape(-1, *input_shape[2:])
