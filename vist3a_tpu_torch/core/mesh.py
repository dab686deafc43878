"""The device mesh and what rides on it: data parallelism, FSDP2 storage
and tensor parallelism.

Port of `vist3a_tpu/core/mesh.py`, with its names.  The JAX package lays
one 2-D `(data, model)` mesh over all devices of one controller, and GSPMD
inserts the collectives.  Here one process drives one GPU
(`core/distributed.py`), the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks, and the port
calls each collective itself:

  * ``data`` — the batch axis.  Every rank with the same data index sees
    the same batch rows (`data_index`, `data_size` for the samplers).
    Gradients of replicated trainables are averaged over it
    (`average_gradients`, DDP's all-reduce as one flat bucket).  Under
    `place_dit("fsdp")` the DiT's blocks keep 1/data of their weights
    (FSDP2 `fully_shard`).
  * ``model`` — the tensor-parallel axis (`nn/wan_dit.py::
    tensor_parallel`, Megatron's column / row layout).  Rank = data_index ·
    model + model_index, so the ranks of one model group are adjacent, as
    JAX keeps "model" on adjacent devices.

Draws that the JAX package makes once for the global batch are made for
the global batch on every rank, which keeps its own rows
(`randn_rows`, `rand_rows`), so a run over N data ranks equals one rank
over the concatenated batch.

Without a process group (one process), `create_mesh` gives a 1×1 mesh with
no groups, and every collective here is a no-op.  `pin` has no
counterpart: there is no GSPMD to steer, as each collective is explicit.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from vist3a_tpu_torch.core import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
DIT_SHARDINGS = ("fsdp", "tp", "tp_fsdp", "replicated")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh layout.  ``data * model`` must equal the device count."""

    data: int = -1  # -1: infer from device count / model
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not match {n_devices} devices"
            )
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the `(data, model)` mesh; `device_mesh` None
    for a single process (no groups, every collective a no-op)."""

    data: int
    model: int
    rank: int = 0
    device_mesh: object | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def group(self, axis: str):
        """The process group of `axis` through this rank; None without a
        process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def submesh(self, axis: str):
        return None if self.device_mesh is None else self.device_mesh[axis]


# --------------------------------------------------------------------------- #
# tensor parallelism: the model group and its autograd-aware collectives      #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model group a TP DiT's blocks reduce over, its size and this
    rank's index in it."""
    group: object
    size: int
    rank: int


class _CopyToModel(torch.autograd.Function):
    """A column-parallel input: identity forward, the gradient summed over
    the model group in the backward (each rank's heads add their part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """A row-parallel output: the partial products summed over the model
    group, identity backward (the gradient of the sum is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    """A statistic summed over the model group whose value every rank then
    reads (the qk-norm's mean of squares): summed both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverModel.apply(x, group)


def tensor_parallel_group(group) -> TensorParallel:
    return TensorParallel(group, dist.get_world_size(group),
                          dist.get_rank(group))


def tp_slice_state(state: dict[str, torch.Tensor], dim_of, size: int,
                   rank: int) -> dict[str, torch.Tensor]:
    """Full weights → this rank's slices: `dim_of(name)` is the dim a
    weight is split along (None: whole), cut in `size` equal parts of
    which rank `rank`'s is kept, as a view."""
    out = {}
    for name, t in state.items():
        dim = dim_of(name)
        if dim is not None:
            n = t.shape[dim] // size
            t = t.narrow(dim, rank * n, n)
        out[name] = t
    return out


def cut_to_slices(model: torch.nn.Module, dim_of, tp: TensorParallel
                  ) -> None:
    """Replace, in place, each parameter of `model` that `dim_of` splits
    by a copy of this rank's slice (`tp_slice_state`); the full tensor is
    freed with the old parameter."""
    params = dict(model.named_parameters())
    sliced = tp_slice_state(params, dim_of, tp.size, tp.rank)
    with torch.no_grad():
        for name, t in sliced.items():
            if t is params[name]:
                continue
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                t.clone(), requires_grad=params[name].requires_grad))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(config: MeshConfig | None = None, *,
                device_type: str | None = None) -> Mesh:
    """The `(data, model)` mesh over all ranks of the default group (one
    rank without one).  A layout whose product is not the world size
    raises on every rank, before any collective, so no rank hangs."""
    config = config or MeshConfig()
    world = distributed.get_world_size()
    data, model = config.resolve(world)
    if not dist.is_initialized():
        return Mesh(data, model)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type or _device_type(), (data, model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(data, model, dist.get_rank(), dm)


def mesh_from_args(args, *, device_type: str | None = None) -> Mesh:
    """The mesh of the `add_mesh_args` flags (`cli/arguments.py`)."""
    return create_mesh(MeshConfig(data=getattr(args, "mesh_data", -1),
                                  model=getattr(args, "mesh_model", 1)),
                       device_type=device_type)


def local_batch_size(per_device_batch: int, mesh: Mesh) -> int:
    """THIS process's loader batch.  Each process drives one device, so it
    is the per-device `--batch_size` (`model_stitching_training.py:286`);
    the JAX package's controller loads for all its devices at once."""
    return per_device_batch


def data_index(mesh: Mesh | None) -> int:
    """The sampler's rank: model peers share it, and so their batch."""
    return 0 if mesh is None else mesh.data_index


def data_size(mesh: Mesh | None) -> int:
    """The sampler's `num_replicas`."""
    return 1 if mesh is None else mesh.data


def local_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (rows data_index · b to
    (data_index + 1) · b, b = rows / data)."""
    n = data_size(mesh)
    if n == 1:
        return x
    b = x.shape[0] // n
    return x[data_index(mesh) * b:(data_index(mesh) + 1) * b]


def randn_rows(shape, generator: torch.Generator, mesh: Mesh | None, *,
               device=None, dtype=None) -> torch.Tensor:
    """N(0, 1) of the local `shape`: drawn for the global batch (`shape`
    with data·B rows) from `generator`, this rank's rows kept."""
    n = data_size(mesh)
    full = (shape[0] * n, *shape[1:])
    return local_rows(torch.randn(full, generator=generator, device=device,
                                  dtype=dtype), mesh)


def rand_rows(shape, generator: torch.Generator, mesh: Mesh | None, *,
              device=None) -> torch.Tensor:
    """U(0, 1) of the local `shape`, drawn as `randn_rows` draws."""
    n = data_size(mesh)
    full = (shape[0] * n, *shape[1:])
    return local_rows(torch.rand(full, generator=generator, device=device),
                      mesh)


# the data group the batch statistics of a step are taken over
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_group", default=None)


@contextlib.contextmanager
def batch_statistics_over(mesh: Mesh | None):
    """Inside, statistics over the batch (the decoder's confidence
    quantile, `nn/encoder.py`) are taken over the global batch, the rows
    of every data rank (`global_batch`), as the JAX package takes them
    over its global batch; the backward's recompute must run inside too."""
    token = _BATCH_GROUP.set(mesh.group(DATA_AXIS) if active(mesh)
                             else None)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def global_batch(x: torch.Tensor) -> torch.Tensor:
    """The rows of `x` of every data rank, in data-index order, without
    gradient inside `batch_statistics_over`; `x` itself outside."""
    group = _BATCH_GROUP.get()
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts)


def active(mesh: Mesh | None) -> bool:
    """Whether `mesh` has process groups (collectives to run)."""
    return mesh is not None and mesh.device_mesh is not None


def _all_reduce_flat(tensors: list[torch.Tensor], group, divisor: float
                     ) -> None:
    """Sum `tensors` over `group` as one flat bucket, divide by `divisor`,
    in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(divisor)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def average_gradients(grads: list[torch.Tensor], mesh: Mesh | None) -> None:
    """DDP: the mean of each gradient over the data group, in place, as one
    flat bucket (model peers hold equal gradients already)."""
    if active(mesh):
        _all_reduce_flat(grads, mesh.group(DATA_AXIS), mesh.data)


def reduce_lora_grads(grads: list[torch.Tensor], mesh: Mesh | None, *,
                      tensor_parallel: bool) -> None:
    """The LoRA factors' gradients of a DiT on the mesh, in place.  The
    factors live outside the DiT (no FSDP reduce-scatter reaches them) and
    are replicated.  Under tensor parallelism each rank's gradient is the
    part of its slices: summed over the model group, then averaged over
    the data group; else model peers hold equal gradients: averaged over
    all ranks.  Both are one sum over the world."""
    if active(mesh):
        _all_reduce_flat(grads, None,
                         mesh.data if tensor_parallel else mesh.size)


def mean_over_data(values: dict, mesh: Mesh | None) -> dict:
    """The mean over the data group of each tensor in `values` (a step's
    metrics); others pass through."""
    if not active(mesh):
        return values
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    ts = [values[k].detach().float().clone() for k in keys]
    _all_reduce_flat(ts, mesh.group(DATA_AXIS), mesh.data)
    return {**values, **dict(zip(keys, ts))}


def place_dit(dit, dit_cfg, mesh: Mesh | None, how: str):
    """DiT parameter placement over the mesh, in place, returned:
      * "fsdp" — FSDP2 `fully_shard` of each `WanBlock`, then of the root,
        over the data submesh (the reference's FSDP2 wrap of
        `WanTransformerBlock`, `train_vdm.py:296-304`);
      * "tp" — tensor parallelism over "model" (`wan_dit.
        tensor_parallel`; 14B inference);
      * "tp_fsdp" — both: TP over "model", then FSDP2 storage over "data"
        (the 14B training placement);
      * "replicated" — a full copy on every rank.
    A mesh without process groups places nothing (one device).  Initialise
    the LoRA state (`train/vdm.py::init_train_state`) before "tp": it reads
    the sites' full shapes."""
    if how not in DIT_SHARDINGS:
        raise ValueError(f"unknown dit_sharding {how!r}")
    if not active(mesh) or how == "replicated":
        return dit
    from vist3a_tpu_torch.nn import wan_dit

    if how in ("tp", "tp_fsdp"):
        wan_dit.tensor_parallel(dit, mesh.group(MODEL_AXIS))
    if how in ("fsdp", "tp_fsdp"):
        from torch.distributed.fsdp import fully_shard

        data_mesh = mesh.submesh(DATA_AXIS)
        for blk in dit.blocks:
            fully_shard(blk, mesh=data_mesh)
        fully_shard(dit, mesh=data_mesh)
    return dit
