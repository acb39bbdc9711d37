"""Tensor parallelism over the model axis (the JAX package's
``parallel/mesh.py::state_shardings`` with a model axis above 1).

The sharding rule is the JAX one: a 4-D leaf of the JAX state whose
output-channel dim (HWIO's dim 3) divides the model axis, and is at least
as large, is split column-parallel over it; every other leaf is replicated.
In the port's layout those leaves are the ``EqualizedConv2d`` weights
(OIHW, dim 0), the modulated-conv weights (``[1, Cout, Cin, kh, kw]``,
dim 1) and the generator's constant inputs (``[1, C, h, w]``, dim 1); each
of those modules names its leaf and dim as ``tp_param``.  Their Adam
moments and EMA mirrors follow, being made from the sharded parameters.
Biases (1-D in JAX) and the output block's scalar bias stay replicated.

Each model rank holds its contiguous block of a sharded leaf's channels and
computes that block of the layer's output; a channel gather over the model
group rebuilds the full activation right after the layer, so everything
between two sharded layers (bias and leaky ReLU, noise, blur, attention,
the heads) runs on the full channels on every model rank.  The layer's
input goes through :func:`copy`, whose backward sums the partial input
gradients over the model group (Megatron's column-parallel pair).  The four
autograd Functions come in pairs, each the other's backward, so R1's and
path length's double backward cross them:

* gather (forward: every rank's block into zeros, then an all-reduce) and
  slice (forward: this rank's block);
* copy (forward: identity) and reduce (forward: the all-reduce).

Every rank of a model group runs the same graph and so issues the same
collectives in the same order, the remat recompute included.  Without a
model axis every function here is the identity and no collective runs.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from multi_stylegan_torch.parallel import mesh


def shards(channels: int, n_model: int) -> bool:
    """The JAX rule: ``channels`` splits over a model axis of ``n_model``."""
    return n_model > 1 and channels % n_model == 0 and channels >= n_model


def _block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of ``x``'s full extent on ``dim``."""
    c = x.shape[dim] // mesh.model_world()
    return x.narrow(dim, mesh.model_rank() * c, c)


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor whose blocks on ``dim`` the model ranks hold: each
    writes its block into zeros laid out as ``x`` is (its dims in the same
    order in memory: planar for the generator's planar activations,
    channels-last for channels_last ones), then a sum, which is exact."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))  # outermost first
    buf = x.new_zeros([x.shape[d] * (mesh.model_world() if d == dim else 1) for d in order])
    full = buf.permute(*(order.index(d) for d in range(x.dim())))
    _block(full, dim).copy_(x)
    dist.all_reduce(buf, group=mesh.model_group())
    return full


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, ctx.dim), None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _block(x, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, group=mesh.model_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g)


def gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The full tensor from this rank's block on ``dim`` (differentiable;
    its backward keeps this rank's block of the cotangent)."""
    return x if mesh.model_world() == 1 else _Gather.apply(x, dim)


def copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a sharded layer: the identity, whose backward
    sums the model ranks' partial gradients."""
    return x if mesh.model_world() == 1 else _Copy.apply(x)


# ------------------------------------------------------------- the leaves


def _leaves(model: nn.Module):
    """(state-dict key, module, attribute, dim) of every leaf the rule may
    shard."""
    for prefix, module in model.named_modules():
        spec = getattr(type(module), "tp_param", None)
        if spec is not None:
            name, dim = spec
            yield (f"{prefix}.{name}" if prefix else name), module, name, dim


def shard_plan(model: nn.Module, n_model: int) -> Dict[str, int]:
    """State-dict key -> dim of every leaf a model axis of ``n_model``
    shards (shapes only: a model on the meta device will do)."""
    return {key: dim for key, module, name, dim in _leaves(model)
            if shards(getattr(module, name).shape[dim], n_model)}


def sharded_keys(model: nn.Module) -> Dict[str, int]:
    """State-dict key -> dim of the leaves ``model`` holds sharded."""
    return {key: dim for key, module, _, dim in _leaves(model) if module.tp_sharded}


def _keep_block(state_dict, prefix, *args, name: str, dim: int, full: int) -> None:
    """Load hook of a sharded module: a full-size tensor (a one-process
    checkpoint) loads as this rank's block."""
    key = prefix + name
    if key in state_dict and state_dict[key].shape[dim] == full:
        state_dict[key] = _block(state_dict[key], dim)


@torch.no_grad()
def shard_model(model: nn.Module) -> Dict[str, int]:
    """Split ``model``'s leaves over the model axis in place: every rank
    takes global rank 0's full tensors, then keeps its block of each leaf
    the rule shards, as a new ``Parameter``.  Returns the plan; nothing
    happens without a model axis."""
    n = mesh.model_world()
    if n == 1:
        return {}
    mesh.broadcast_everywhere(model)
    plan = shard_plan(model, n)
    for key, module, name, dim in _leaves(model):
        if key not in plan:
            continue
        full = getattr(module, name)
        setattr(module, name, nn.Parameter(_block(full, dim).clone(),
                                           requires_grad=full.requires_grad))
        module.tp_sharded = True
        module._register_load_state_dict_pre_hook(
            functools.partial(_keep_block, name=name, dim=dim, full=full.shape[dim]))
    return plan


def shard_dims(model: nn.Module, params: Sequence[nn.Parameter]) -> list:
    """The sharded dim of each of ``params`` (None where replicated)."""
    dims = {id(getattr(module, name)): dim for _, module, name, dim in _leaves(model)
            if module.tp_sharded}
    return [dims.get(id(p)) for p in params]


def local_block(full: torch.Tensor, like: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``full`` as this rank's block when it is the full size of ``like``'s
    sharded ``dim``, else as it is."""
    if dim is None or full.shape[dim] == like.shape[dim]:
        return full
    return _block(full, dim)


@torch.no_grad()
def full_tensor(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The whole of a sharded tensor (every model rank takes part); a
    replicated one (``dim`` None) as it is."""
    if dim is None or mesh.model_world() == 1:
        return x
    return _gather(x.detach(), dim).contiguous()


def full_module_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict in the one-process layout."""
    keys = sharded_keys(model)
    return {k: full_tensor(v, keys.get(k)) for k, v in model.state_dict().items()}
