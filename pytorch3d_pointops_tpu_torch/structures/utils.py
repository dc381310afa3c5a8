"""Conversions between list, padded and packed forms of ragged batches.

The port of ``pytorch3d_pointops_tpu/structures/utils.py``. The helpers work
on tensors on any device and keep the device and dtype of their inputs.
"""

from __future__ import annotations

from numbers import Integral
from typing import List, Sequence, Tuple, Union

import torch

from .. import tracing


def _host_int(v, site: str) -> int:
    """``int(v)``, counted as a read to the host where v is a tensor."""
    if isinstance(v, torch.Tensor):
        tracing.sync(site)
    return int(v)


def list_to_padded(
    x: Union[List[torch.Tensor], Tuple[torch.Tensor, ...]],
    pad_size: Union[Sequence[int], None] = None,
    pad_value: float = 0.0,
    equisized: bool = False,
) -> torch.Tensor:
    """Stack a list of N tensors of shape ``(Si_0, ..., Si_D)`` into a padded
    tensor of shape ``(N, pad_size[0], ..., pad_size[D])``.

    With ``pad_size=None``, each output dim takes the max size over the list.
    """
    if equisized:
        return torch.stack(list(x), dim=0)

    if not all(isinstance(y, torch.Tensor) for y in x):
        raise ValueError("list_to_padded: every list entry must be a tensor.")

    items = list(x)
    rank = max(y.ndim for y in items)
    # A zero-size 1D placeholder stands in for "empty element of any rank".
    items = [
        y.new_zeros((0,) * rank) if (y.ndim == 1 and y.numel() == 0) else y
        for y in items
    ]
    if any(y.ndim != items[0].ndim for y in items):
        raise ValueError(
            "list_to_padded: list entries differ in rank; all non-empty "
            "entries must have the same number of dimensions."
        )

    if pad_size is None:
        # Entries with a nonzero leading dim take part in the size even if a
        # trailing dim is zero: (5, 0) still contributes 5 to dim 0.
        target = [
            max(y.shape[dim] for y in items if y.shape[0] > 0)
            for dim in range(items[0].ndim)
        ]
    else:
        if any(len(pad_size) != y.ndim for y in items):
            raise ValueError(
                "list_to_padded: pad_size must give a target size for every "
                "dimension of the list entries."
            )
        target = list(pad_size)

    out = items[0].new_full((len(items), *target), pad_value)
    for i, y in enumerate(items):
        if y.shape[0] > 0:
            out[(i, *(slice(0, s) for s in y.shape))] = y
    return out


def padded_to_list(
    x: torch.Tensor,
    split_size: Union[Sequence[int], Sequence[Sequence[int]], None] = None,
) -> List[torch.Tensor]:
    """Split a padded ``(N, S_1, ..., S_D)`` tensor back into a list of N
    tensors, trimming entry ``i`` to ``split_size[i]`` (an int trims the
    leading dim; a tuple trims every dim)."""
    out = [x[i] for i in range(x.shape[0])]

    if split_size is None:
        return out

    if x.shape[0] != len(split_size):
        raise ValueError(
            "padded_to_list: split_size needs one entry per batch element "
            f"(got {len(split_size)} for batch {x.shape[0]})."
        )

    for i, s in enumerate(split_size):
        if isinstance(s, Integral):
            out[i] = out[i][: int(s)]
        else:
            out[i] = out[i][tuple(slice(0, _host_int(d, "padded_to_list")) for d in s)]
    return out


def list_to_packed(x: List[torch.Tensor]):
    """Concatenate a list of N tensors of shape (Mi, ...) into (sum(Mi), ...).

    Returns ``(packed, num_items, first_idx, to_list_idx)``: the packed
    tensor, per-entry sizes (N,), the packed offset where each entry starts
    (N,), and for every packed row the list index it came from (sum(Mi),),
    all int64 on the device of the entries.
    """
    if not x:
        raise ValueError("list_to_packed: received an empty list.")
    dev = x[0].device
    counts = [int(xi.shape[0]) for xi in x]
    sizes = torch.tensor(counts, device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    owners = torch.repeat_interleave(torch.arange(len(x), device=dev), sizes,
                                     output_size=sum(counts))
    return torch.cat(list(x), dim=0), sizes, starts, owners


def packed_to_list(x: torch.Tensor, split_size: Union[list, int]):
    """Slice a packed (sum(Mi), ...) tensor back into a list of (Mi, ...)
    tensors. An int ``split_size`` means equal chunks."""
    if isinstance(split_size, int):
        split_size = [split_size] * (x.shape[0] // split_size)
    out = []
    offset = 0
    for s in split_size:
        s = _host_int(s, "packed_to_list")
        out.append(x[offset : offset + s])
        offset += s
    return out


def padded_to_packed(
    x: torch.Tensor,
    split_size: Union[list, tuple, None] = None,
    pad_value: Union[float, int, None] = None,
):
    """Flatten a padded (N, M, K) tensor into a packed (F, K) tensor.

    At most one of ``split_size`` / ``pad_value`` may be given: split_size
    keeps the first ``split_size[i]`` rows of entry i; pad_value drops rows
    equal to it everywhere. With neither, returns the dense (N*M, K)
    flattening.
    """
    if x.ndim != 3:
        raise ValueError("padded_to_packed: input must be a (N, M, K) tensor.")
    N, M, D = x.shape

    if split_size is not None and pad_value is not None:
        raise ValueError(
            "padded_to_packed: split_size and pad_value are mutually "
            "exclusive; give at most one."
        )

    flat = x.reshape(-1, D)

    if pad_value is None and split_size is None:
        return flat

    if pad_value is not None:
        tracing.sync("padded_to_packed.pad_value")  # a mask's size
        return flat[(flat != pad_value).any(-1)]

    if len(split_size) != N:
        raise ValueError(
            "padded_to_packed: split_size needs one entry per batch element "
            f"(got {len(split_size)} for batch {N})."
        )
    if not all(isinstance(s, Integral) for s in split_size):
        raise ValueError(
            "padded_to_packed: only scalar (leading-dim) split sizes are "
            "supported."
        )
    rows = torch.cat(
        [torch.arange(int(s), device=x.device) + i * M for i, s in enumerate(split_size)]
    )
    return flat[rows]
