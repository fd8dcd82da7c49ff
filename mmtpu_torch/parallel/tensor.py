"""Tensor parallelism over the model axis (counterpart of the
`PartitionSpec`s mmtpu puts on the AVMNIST fusion MLP,
`tests/test_parallel.py:114-128` and `__graft_entry__.py:174-180`).

mmtpu shards two of the head's kernels over the `model` axis and lets
XLA's SPMD partitioner insert the collectives: `fc_fusion` is
column-parallel (`P(None, MODEL)` on its (in, out) kernel, `P(MODEL)` on
its bias), `fc_intermediate` row-parallel (`P(MODEL, None)`; its bias is
replicated), everything else replicated. The port writes those
collectives out, as Megatron-LM does:

- `shard_module(model, mesh, rule)` keeps this rank's shard of each
  parameter the rule names, as its own contiguous `Parameter` under the
  same name, in torch's (out, in) layout: "column" splits `weight`'s rows
  and the bias, "row" splits `weight`'s columns and keeps the bias whole.
  Every rank must hold the same whole model first (one seed, one file):
  mmtpu places one array on the mesh;
- `copy_to_model` (identity forward, sum over the model group backward)
  goes in front of the column-parallel layer, so the gradient of its
  replicated input sums every shard's part; `reduce_from_model` (sum over
  the model group forward, identity backward) after the row-parallel
  layer; the row-parallel bias is added once, after the sum
  (`models/avmnist.py`);
- `gather_state_dict(model)` is the single-process `state_dict`
  (the same keys and shapes, as mmtpu's device_get of a sharded state
  yields whole arrays); `TrainState` gathers the optimizer's moments the
  same way for a checkpoint and takes its shard of both when it loads one;
- the model's `Sharding` is the one record of which parameters are
  sharded and along which dimension (`dims`, by name; `shard_dims(model)`
  reads it): the step's global-norm clip sums the shards' squares over the
  model group (`train/step.py`), so that the norm is optax's norm of the
  whole tensors;
- a shard is `mesh.put_global` of the whole tensor under the
  `NamedSharding` whose dimension `dim` lies on MODEL_AXIS
  (`leaf_sharding`), the slice mmtpu's `P(None, MODEL)` / `P(MODEL, None)`
  gives a device;
- `refuse_model_axis(mesh, what)` raises for a path that mmtpu never runs
  on a model axis (ROADMAP §1 lists them).

The gradients of every leaf are summed over the data group alone
(`Mesh.all_reduce_grads`): a replicated leaf has the same gradient on
every rank of a model group once `copy_to_model`'s backward has summed.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from mmtpu_torch.parallel.mesh import MODEL_AXIS, NamedSharding, put_global

# where the paths that mmtpu never runs on a model axis are listed
NOT_ON_A_MODEL_AXIS = "ROADMAP.md §1, what raises on a model axis"

# the model rank's slice of a whole tensor, by the rule's kind, in torch's
# (out, in) weight layout: {parameter: dimension it is split along}
SPLITS = {"column": {"weight": 0, "bias": 0}, "row": {"weight": 1}}


@dataclasses.dataclass(eq=False)
class Sharding:
    """That `shard_module` sharded a model: the mesh whose model group
    holds the other shards, and {name of a sharded parameter: the dimension
    it is split along}, the one record of both."""

    mesh: Any
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)


def refuse_model_axis(mesh, what: str) -> None:
    """Raise for a path that mmtpu never runs on a model axis, when `mesh`
    has one."""
    if mesh is not None and mesh.model_size > 1:
        raise NotImplementedError(
            f"{what} on a model axis (model_parallel={mesh.model_size}): mmtpu runs it "
            f"with model_parallel=1 only ({NOT_ON_A_MODEL_AXIS})")


def shard_dims(model: nn.Module) -> Dict[str, int]:
    """{name of a sharded parameter: the dimension it is split along}; {}
    for a model that is whole."""
    sh = sharding(model)
    return dict(sh.dims) if sh is not None else {}


def sharded_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The model's sharded parameters (the clip sums their squares over the
    model group)."""
    dims = shard_dims(model)
    return [p for n, p in model.named_parameters() if n in dims]


def sharding(model: nn.Module) -> Optional[Sharding]:
    """The model's `Sharding`, None for a model that is whole."""
    return getattr(model, "sharding", None)


def leaf_sharding(mesh, dim: int) -> NamedSharding:
    """A leaf split along `dim` over the model axis, whole along the rest."""
    return NamedSharding(mesh, (None,) * dim + (MODEL_AXIS,))


def shard_tensor(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's contiguous slice of `t` along `dim`, where `t`
    lies."""
    return put_global(t, leaf_sharding(mesh, dim), device=t.device)


def shard_module(model: nn.Module, mesh, rule: Mapping[str, str]) -> nn.Module:
    """Keep this rank's shard of the parameters `rule` names ({submodule:
    "column" | "row"}, mmtpu's spec); returns `model`. The model's class
    must run the sharded forward (its `TENSOR_PARALLEL_RULE` is `rule`):
    another split would compute something else."""
    if getattr(type(model), "TENSOR_PARALLEL_RULE", None) != dict(rule):
        raise ValueError(f"{type(model).__name__} has no tensor-parallel forward for "
                         f"the rule {dict(rule)}")
    if sharding(model) is not None:
        raise ValueError("the model is sharded already")
    dims = {}
    for prefix, kind in rule.items():
        if kind not in SPLITS:
            raise ValueError(f"{prefix}: no split {kind!r} (column or row)")
        layer = model.get_submodule(prefix)
        for attr, dim in SPLITS[kind].items():
            whole = getattr(layer, attr)
            if whole is None:
                continue
            part = nn.Parameter(shard_tensor(whole.detach(), dim, mesh).clone(),
                                requires_grad=whole.requires_grad)
            setattr(layer, attr, part)
            dims[f"{prefix}.{attr}"] = dim
    model.sharding = Sharding(mesh, dims)
    return model


def join_shards(parts: List[Mapping[str, torch.Tensor]],
                dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """The model ranks' shards (one dict per rank, in rank order) joined
    into the whole tensors, for each name of `dims`."""
    return {k: torch.cat([p[k] for p in parts], dim=d) for k, d in dims.items()}


def gather_state_dict(model: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The model's state_dict with every shard joined over the model group
    (collective: every rank of the group calls it), on the CPU: the
    single-process keys and shapes. A model that is whole gives its own."""
    state = OrderedDict((k, v.detach().cpu()) for k, v in model.state_dict().items())
    sh = sharding(model)
    if sh is None:
        return state
    dims = shard_dims(model)
    whole = join_shards(sh.mesh.model_gather({k: state[k] for k in dims}), dims)
    return OrderedDict((k, whole.get(k, v)) for k, v in state.items())


def optimizer_dims(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[int, int]:
    """{index of a sharded parameter in the optimizer's state_dict: its
    dimension}."""
    dims = shard_dims(model)
    ids = {id(p): dims[n] for n, p in model.named_parameters() if n in dims}
    flat = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: ids[id(p)] for i, p in enumerate(flat) if id(p) in ids}


def _moments(entry: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A parameter's per-element optimizer state (Adam's moments): its
    tensors of more than one element."""
    return {k: v for k, v in entry.items() if isinstance(v, torch.Tensor) and v.dim() > 0}


def gather_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                           state: Dict[str, Any]) -> Dict[str, Any]:
    """`state` (the optimizer's state_dict, on the CPU) with each sharded
    parameter's moments joined over the model group (collective)."""
    sh = sharding(model)
    dims = optimizer_dims(model, optimizer)
    local = {f"{i}/{k}": v for i in dims for k, v in _moments(state["state"].get(i, {})).items()}
    whole = join_shards(sh.mesh.model_gather(local), {k: dims[int(k.split("/")[0])]
                                                      for k in local})
    out = {**state, "state": {i: dict(e) for i, e in state["state"].items()}}
    for key, value in whole.items():
        i, k = key.split("/")
        out["state"][int(i)][k] = value
    return out


def shard_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          state: Dict[str, Any]) -> Dict[str, Any]:
    """A whole-model optimizer state_dict cut to this rank's shards."""
    mesh = sharding(model).mesh
    out = {**state, "state": {i: dict(e) for i, e in state["state"].items()}}
    for i, dim in optimizer_dims(model, optimizer).items():
        for k, v in _moments(out["state"].get(i, {})).items():
            out["state"][i][k] = shard_tensor(v, dim, mesh)
    return out


def shard_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> "OrderedDict[str, torch.Tensor]":
    """A whole model's state_dict cut to this rank's shards of `model`."""
    mesh, dims = sharding(model).mesh, shard_dims(model)
    return OrderedDict(
        (k, shard_tensor(v, dims[k], mesh) if k in dims else v) for k, v in state.items())


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward, the sum over the model group
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce_(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": the sum over the model group forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)
