"""Tensor parallelism: a 2-D (data, model) mesh with the state sharded over
``model`` (counterpart of ``clearvae_tpu/parallel/tp.py``).

The JAX package places its TrainState's leaves with ``NamedSharding`` by a
rule table and lets GSPMD insert the collectives. The port keeps the rule
table, in torch's layouts, and writes the collectives out in PyTorch's
FSDP idiom (sharded state, a full working copy for the compute):

- the sharded dimension is the output channel: ``Conv2d`` weight
  [out, in, kh, kw] dim 0, ``ConvTranspose2d`` weight [in, out, kh, kw]
  **dim 1**, ``Linear`` weight [out, in] dim 0, and every 1-D leaf (bias,
  BatchNorm weight and bias, running mean and variance) dim 0;
- a leaf whose dimension the model axis does not divide is replicated, as
  the decoder's 1-channel output conv is (JAX: "GSPMD re-shards at the
  boundary"; torch's ``fully_shard`` would pad it);
- each rank keeps its slice of the sharded parameters and BatchNorm
  buffers; its optimizer is built over those slices, so Adam's
  ``exp_avg`` / ``exp_avg_sq`` hold the slices too (the ZeRO-style
  memory win that JAX's docstring names);
- the batch shards over ``data`` only, as JAX's ``P('data')``: the ranks
  of one model group compute the same rows on the same full working copy
  of the weights (the modules' own parameters and buffers). After the
  backward, the gradient is summed over ``data`` (``mesh.Shard.step``);
  the ranks of a model group then hold equal sums, so each takes its
  slice of the sum with no model-axis collective (what a reduce-scatter
  of equal gradients, divided by the model size, would return); the
  rank's optimizer updates its slices; and the updated slices, with the
  BatchNorm buffers' slices that the forward moved, are all-gathered back
  into the working copy, so that the modules hold the current state
  between steps (evaluation, checkpoints and serving read them as they do
  without a mesh).

Numerics equal data parallelism's. The working copy stays allocated (a
captured CUDA graph holds its pointers), so the memory saved is the
optimizer's moments and the master slices, not the weights in use. As in
``mesh.py``, every collective is a ``dist.all_reduce``.
"""

from __future__ import annotations

import torch
from torch import nn

from clearvae_torch.parallel.mesh import (DATA_AXIS, _all_reduce, _device_type,
                                          _world)

MODEL_AXIS = "model"

# leaf name -> whether the rule table covers it (JAX's kernel, bias, scale,
# mean, var in torch's names)
_SHARDABLE_NAMES = frozenset({"weight", "bias", "running_mean", "running_var"})


def make_mesh2d(n_data: int, n_model: int, device_type: str | None = None):
    """(data, model) ``DeviceMesh`` over the ``n_data * n_model`` ranks of
    the default process group, ``model`` innermost (rank = d·n_model + m),
    as in JAX. Raises, like ``make_mesh``, unless the group has exactly
    that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    _world(n_data * n_model)
    return init_device_mesh(device_type or _device_type(), (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(module: nn.Module, name: str, leaf: torch.Tensor,
               n_model: int) -> int | None:
    """The dimension of ``module``'s leaf ``name`` that shards over a model
    axis of ``n_model``, or None (replicated): JAX's ``param_spec`` in
    torch's layouts."""
    if name not in _SHARDABLE_NAMES:
        return None
    if leaf.ndim == 4:
        dim = 1 if isinstance(module, nn.ConvTranspose2d) else 0
    elif leaf.ndim in (1, 2):
        dim = 0
    else:
        return None
    return dim if leaf.shape[dim] % n_model == 0 else None


def specs(module: nn.Module, n_model: int) -> dict:
    """{state-dict name: sharded dim or None} of every parameter and buffer
    of ``module``."""
    out = {}
    for prefix, m in module.named_modules():
        for name, t in (*m.named_parameters(recurse=False),
                        *m.named_buffers(recurse=False)):
            out[f"{prefix}.{name}" if prefix else name] = param_spec(
                m, name, t, n_model)
    return out


class _Leaf:
    """A sharded leaf: the module's full working copy, this rank's slice of
    it, and the dimension that it is cut along."""

    def __init__(self, full, shard, dim, lo, n):
        self.full, self.shard, self.dim, self.lo, self.n = (full, shard, dim,
                                                            lo, n)

    def slice_of(self, t):
        return t.narrow(self.dim, self.lo, self.n)


class TensorParallel:
    """The model-axis shards of a trainer's modules (see the module
    docstring)."""

    def __init__(self, mesh, modules):
        self.size = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
        self.rank = mesh.get_local_rank(MODEL_AXIS)
        self.group = mesh.get_group(MODEL_AXIS)
        self.leaves: dict = {}     # id(module) -> {full tensor id: _Leaf}
        for module in modules:
            self.leaves[id(module)] = self._shard(module)

    def _shard(self, module) -> dict:
        by_name = dict(module.named_parameters())
        by_name.update(module.named_buffers())
        out = {}
        for name, dim in specs(module, self.size).items():
            if dim is None:
                continue
            full = by_name[name]
            n = full.shape[dim] // self.size
            piece = full.detach().narrow(dim, self.rank * n, n).clone()
            shard = nn.Parameter(piece) if isinstance(full, nn.Parameter) \
                else piece
            out[id(full)] = _Leaf(full, shard, dim, self.rank * n, n)
        return out

    def parameters(self, module) -> list:
        """``module.parameters()`` with each sharded one replaced by this
        rank's slice: what its optimizer updates."""
        leaves = self.leaves[id(module)]
        return [leaves[id(p)].shard if id(p) in leaves else p
                for p in module.parameters()]

    def scatter_grads(self, module, flat: torch.Tensor) -> None:
        """``flat``: the gradients of ``module``'s parameters (those that
        have one, in order), summed over ``data``, and so equal on the ranks
        of a model group. Hands each sharded parameter's slice of it to its
        shard (the working copy's gradient is dropped) and each replicated
        one the whole."""
        leaves = self.leaves[id(module)]
        params = [p for p in module.parameters() if p.grad is not None]
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            g = g.view_as(p)
            leaf = leaves.get(id(p))
            if leaf is None:
                p.grad.copy_(g)
            else:
                leaf.shard.grad = leaf.slice_of(g).contiguous()
                p.grad = None

    def sync(self, module) -> None:
        """Write the BatchNorm buffers' slices from the working copy into
        their shards, then all-gather every shard of ``module`` into its
        working copy (one all-reduce of one zeroed flat buffer)."""
        leaves = list(self.leaves[id(module)].values())
        if not leaves:
            return
        with torch.no_grad():
            for leaf in leaves:
                if not isinstance(leaf.full, nn.Parameter):
                    leaf.shard.copy_(leaf.slice_of(leaf.full))
            flat = leaves[0].full.new_zeros(sum(l.full.numel() for l in leaves))
            chunks = flat.split([l.full.numel() for l in leaves])
            for leaf, c in zip(leaves, chunks):
                leaf.slice_of(c.view_as(leaf.full)).copy_(leaf.shard)
            _all_reduce(flat, self.group)
            for leaf, c in zip(leaves, chunks):
                leaf.full.copy_(c.view_as(leaf.full))

    def reshard(self, module) -> None:
        """Take each shard of ``module`` from its working copy (after the
        working copy was loaded whole)."""
        with torch.no_grad():
            for leaf in self.leaves[id(module)].values():
                leaf.shard.copy_(leaf.slice_of(leaf.full))

    def _gather(self, leaf, t: torch.Tensor) -> torch.Tensor:
        out = t.new_zeros(leaf.full.shape)
        leaf.slice_of(out).copy_(t)
        _all_reduce(out, self.group)
        return out

    def full_optimizer_state(self, optimizer, module) -> dict:
        """``optimizer.state_dict()`` with each slice-shaped state tensor
        (Adam's moments) of a sharded parameter gathered to the parameter's
        full shape: the single-device optimizer's state dict."""
        sd = optimizer.state_dict()
        leaves = self.leaves[id(module)]
        for i, p in enumerate(module.parameters()):
            leaf = leaves.get(id(p))
            if leaf is None or i not in sd["state"]:
                continue
            sd["state"][i] = {
                k: (self._gather(leaf, v) if torch.is_tensor(v)
                    and v.shape == leaf.shard.shape and v.ndim else v)
                for k, v in sd["state"][i].items()}
        return sd

    def shard_optimizer_state(self, sd: dict, module) -> dict:
        """The inverse of ``full_optimizer_state``: each full-shaped state
        tensor of a sharded parameter cut to this rank's slice."""
        leaves = self.leaves[id(module)]
        state = dict(sd["state"])
        for i, p in enumerate(module.parameters()):
            leaf = leaves.get(id(p))
            if leaf is None or i not in state:
                continue
            state[i] = {k: (leaf.slice_of(v).clone() if torch.is_tensor(v)
                            and v.shape == leaf.full.shape and v.ndim else v)
                        for k, v in state[i].items()}
        return {**sd, "state": state}
