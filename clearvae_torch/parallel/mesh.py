"""Data parallelism over a ``torch.distributed`` device mesh (counterpart of
``clearvae_tpu/parallel/mesh.py``).

The JAX package gets "data parallel = single device" from GSPMD: it shards
the batch and lets XLA insert the collectives. The port writes them out and
keeps one invariant, so that a step under a mesh computes the single-device
step's numbers up to the order of float sums:

1. **The same global batch on every rank.** Every rank draws the same
   global permutation and the same global noise from its trainer's
   generator, seeded alike on every rank. Rank r of the data axis takes its
   contiguous block of each global batch, ``torch.tensor_split(rows, W)[r]``
   (JAX's ``P('data')`` layout); the reparameterization noise is drawn at
   its global shape [2, B, z] and sliced the same way, so each row sees the
   single-device run's noise. Each rank keeps a whole resident copy of the
   dataset (where JAX shards the samples).
2. **Local forward, gathered latents.** Every term that couples rows of the
   batch (SNN / PS-SNN, fused or not; the GVAE / ML-VAE group evidence;
   CLEAR-TC's roll of z_s by one row; CLEAR-MIM's estimator and its
   permutation) runs on the latents gathered over ``data``, [B, z],
   identically on every rank.
3. **Each rank's loss is its share of the global objective.** Per-row terms
   (reconstruction, KL) are summed over the rank's rows and divided by the
   global B; a term computed on gathered latents enters divided by W, the
   size of the data axis. The gather's backward is a reduce-scatter-sum, so
   the ranks' shares of a gathered term's gradient add up to its gradient,
   and Σ_r ∂L_r/∂θ = ∂L/∂θ: one all-reduce (sum over ``data``) of the
   gradients, on one flat buffer before the optimizer, gives every rank the
   global gradient. The second players (CLEAR-TC's factor classifier,
   CLEAR-MIM's estimator updates) follow the same rule on gathered
   latents. A step's metrics are the all-reduced sums of the shares: the
   global values, equal on every rank.
4. **BatchNorm over the global batch.** Under a mesh every ``BatchNorm``
   holds the data group and all-reduces its per-channel Σx, Σx² and row
   count (one float32 buffer), keeping flax's one-pass ``E[x²] − E[x]²``
   and its running statistics; the all-reduce's backward is itself an
   all-reduce-sum, which under 3 makes BatchNorm's backward exact.

Every collective is a ``dist.all_reduce`` (and a ``broadcast`` of the
initial state): it exists on every backend, for CPU and CUDA tensors, and it
takes blocks of unequal size (B = 15 over 4 ranks), which
``all_gather_into_tensor`` does not. A gather fills a zeroed [B, ...]
buffer with the rank's block and sums it over the axis; a reduce-scatter
is an all-reduce and the rank's slice. What they move is small: latents of
[B, z] and the gradients of ~1.6 M parameters (the 28×28 VAE).

Without a mesh (``Shard()``, the default of every step) each of these
operations is the identity, and the single-device step is unchanged. A
one-rank mesh runs every collective.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist

from clearvae_torch.utils.logging import counter

DATA_AXIS = "data"

# the collectives the port issued, counted as the kernels' launches are
# (``ops/kernels/counts.py`` moves those of a capture to its replays)
COLLECTIVES = counter("collectives", ("all_reduce",))


def reset_collectives() -> None:
    COLLECTIVES["all_reduce"] = 0


def _all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (sum, in place), counted."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)


def make_mesh(n_devices: int | None = None, device_type: str | None = None):
    """1-D data mesh (a ``DeviceMesh`` with the axis ``"data"``) over the
    ranks of the default process group, which the caller has initialized.

    Raises when fewer ranks exist than ``n_devices`` asks for, as JAX's
    ``make_mesh`` does, and when more do: a rank outside the mesh would
    have no part in the run. ``device_type`` defaults to ``"cuda"`` under
    NCCL and ``"cpu"`` otherwise (gloo in the tests)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world(n_devices)
    return init_device_mesh(device_type or _device_type(), (world,),
                            mesh_dim_names=(DATA_AXIS,))


def _world(need: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's default process "
                           "group: call init_process_group first (torchrun "
                           "sets its rank and world size)")
    world = dist.get_world_size()
    if need is not None and need != world:
        raise RuntimeError(
            f"a mesh of {need} devices but the process group has {world} "
            f"ranks; start {need} ranks (torchrun --nproc_per_node {need}, "
            f"or init_process_group(world_size={need}))")
    return world


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh) -> torch.device:
    """The device of this rank: its card, ``cuda:{LOCAL_RANK}``, on a CUDA
    mesh (``LOCAL_RANK`` as torchrun sets it, else the rank modulo the
    cards), the CPU otherwise."""
    if mesh.device_type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else (
        dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", index)


def data_axis_size(mesh) -> int:
    """Extent of the ``data`` axis: the mesh's size for a 1-D mesh, the data
    extent of a 2-D (data, model) mesh."""
    return mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def data_rank(mesh) -> int:
    """This rank's coordinate on the ``data`` axis."""
    return mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    """The process group of this rank's ``data`` axis."""
    return mesh.get_group(DATA_AXIS)


def block(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of block ``rank`` of ``torch.tensor_split(range(n), size)``:
    the first n % size blocks hold one row more."""
    q, r = divmod(n, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def shard_rows(mesh, rows: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of a global batch along ``dim`` (a view)."""
    lo, hi = block(rows.shape[dim], data_axis_size(mesh), data_rank(mesh))
    return rows.narrow(dim, lo, hi - lo)


def warn_if_not_divisible(mesh, n: int, what: str = "dataset length") -> bool:
    """Warn (and return True) when ``n`` does not divide the data axis: the
    counterpart of JAX's ``shard_batch_checked`` warning. The numbers stay
    the single-device run's, but the ranks' blocks of each batch are
    uneven, so the ranks with one row less wait for the others."""
    w = data_axis_size(mesh)
    if n % w == 0:
        return False
    warnings.warn(
        f"{what} {n} does not divide the data axis ({w} devices); each "
        f"batch splits into uneven blocks (torch.tensor_split): numerics "
        f"stay the single-device run's, but the ranks with the smaller "
        f"block idle. Use a multiple of {w} for even data parallelism.",
        stacklevel=2)
    return True


# ---------------------------------------------------------------------------
# autograd collectives
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """Forward: this rank's rows placed in a zeroed [n, ...] buffer, summed
    over the group (an all-gather of blocks of any size). Backward: the
    gradient summed over the group, and this rank's slice of it (a
    reduce-scatter-sum)."""

    @staticmethod
    def forward(ctx, t, n, lo, group):
        ctx.lo, ctx.b, ctx.group = lo, t.shape[0], group
        out = t.new_zeros((n, *t.shape[1:]))
        out.narrow(0, lo, t.shape[0]).copy_(t)
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g.narrow(0, ctx.lo, ctx.b), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward is the same sum of the
    gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


def gather_rows(mesh, t: torch.Tensor, n: int) -> torch.Tensor:
    """The global [n, ...] batch of which ``t`` is this rank's block, on
    every rank of the data axis; differentiable (see ``_GatherRows``)."""
    lo, hi = block(n, data_axis_size(mesh), data_rank(mesh))
    if t.shape[0] != hi - lo:
        raise ValueError(f"rank {data_rank(mesh)} holds {t.shape[0]} rows of "
                         f"a batch of {n}; its block is [{lo}, {hi})")
    return _GatherRows.apply(t, n, lo, data_group(mesh))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group``."""
    return _AllReduceSum.apply(t, group)


# ---------------------------------------------------------------------------
# placement and the step's view of the mesh
# ---------------------------------------------------------------------------


def replicate_state(mesh, *modules) -> None:
    """Make every rank's parameters and buffers rank 0's (a broadcast over
    the whole mesh). The factories seed their modules alike on every rank,
    so this changes nothing there; it guards a caller who did not."""
    del mesh  # every rank of the default group is in the mesh
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            with torch.no_grad():
                dist.broadcast(t.data, src=0)


def set_batch_group(module, group) -> None:
    """Give every ``BatchNorm`` of ``module`` the data group whose batch its
    statistics cover (None: its own rows)."""
    from clearvae_torch.models.layers import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def place_state(mesh, *modules) -> "Shard":
    """Mesh-aware placement of a trainer's modules: their BatchNorms take
    the data group, rank 0's state is broadcast, and on a 2-D (data, model)
    mesh their parameters, BatchNorm buffers and (through the optimizers
    built over ``Shard.parameters``) Adam's moments shard over ``model``
    (``parallel/tp.py``). Returns the steps' ``Shard``; ``Shard()`` without
    a mesh."""
    if mesh is None:
        return Shard()
    from clearvae_torch.parallel.tp import MODEL_AXIS, TensorParallel

    for m in modules:
        set_batch_group(m, data_group(mesh))
    replicate_state(mesh, *modules)
    tp = (TensorParallel(mesh, modules) if MODEL_AXIS in mesh.mesh_dim_names
          else None)
    return Shard(mesh, tp)


class Shard:
    """A rank's part in a step under ``mesh`` (see the module docstring):
    its rows of each global batch, the collectives that make its share of
    the step and the global metrics, and, on a 2-D mesh, its shards of the
    state (``tp``, a ``parallel.tp.TensorParallel``). ``Shard()`` is the
    single device: every method is the identity, or the plain call."""

    def __init__(self, mesh=None, tp=None):
        self.mesh, self.tp = mesh, tp
        if mesh is not None:
            self.size, self.rank = data_axis_size(mesh), data_rank(mesh)
            self.group = data_group(mesh)

    def rows(self, t, dim: int = 0):
        """This rank's block of a global batch ``t`` along ``dim``."""
        return t if self.mesh is None else shard_rows(self.mesh, t, dim)

    def gather(self, t, n: int):
        """The global [n, ...] rows of this rank's block ``t``."""
        return t if self.mesh is None else gather_rows(self.mesh, t, n)

    def row_share(self, v, b: int, n: int):
        """A mean over this rank's ``b`` rows as its share of the mean over
        the global ``n``."""
        return v if self.mesh is None else v * (b / n)

    def rep_share(self, v):
        """A term computed on gathered rows, as this rank's share of it."""
        return v if self.mesh is None else v / self.size

    def total(self, shares: dict) -> dict:
        """The metrics {name: 0-d share} summed over the data axis: the
        global values, equal on every rank."""
        if self.mesh is None:
            return shares
        flat = torch.stack([v.detach().float() for v in shares.values()])
        _all_reduce(flat, self.group)
        return dict(zip(shares, flat.unbind()))

    def parameters(self, module):
        """What an optimizer of ``module`` updates: its parameters, or on a
        2-D mesh their shards."""
        return (list(module.parameters()) if self.tp is None
                else self.tp.parameters(module))

    def step(self, optimizer, module) -> None:
        """``optimizer.step()`` after the gradients of ``module`` are summed
        over the data axis (one all-reduce of one flat buffer) and, on a
        2-D mesh, reduce-scattered over ``model`` into the shards, whose
        update is then all-gathered into the module's working copy."""
        if self.mesh is not None:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads])
            _all_reduce(flat, self.group)
            if self.tp is not None:
                self.tp.scatter_grads(module, flat)
            else:
                torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])
        optimizer.step()
        if self.tp is not None:
            self.tp.sync(module)

    def warm(self, device) -> None:
        """One collective, so that the communicator exists before a CUDA
        graph captures the step's collectives."""
        if self.mesh is not None:
            _all_reduce(torch.zeros(1, device=device), self.group)

    @property
    def leader(self) -> bool:
        """True on the rank that prints and writes (global rank 0)."""
        return self.mesh is None or dist.get_rank() == 0

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()
