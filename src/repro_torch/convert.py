"""Carries state across from the JAX package as numpy arrays.

Every function here takes the JAX package's objects by duck typing and reads
them through ``np.asarray``, so this module imports neither ``jax`` nor
``repro``.  The field layout (K, 9, M, M, M), the field order (strain xx..xy,
then v) and the face order (-x, +x, -y, +y, -z, +z) are shared, so nothing is
permuted:

* ``solver_from`` — a mesh (grid, extent, neighbours incl. periodic wraps),
  materials (rho, lam, mu), order and dtype become the port's ``DGSolver``;
* ``field_from`` — a field ``q`` becomes a tensor on a given device;
* ``plan_from`` — an executor's ``weights``/``counts`` become a ``Plan`` the
  port's ``NestedPartitionExecutor.apply`` takes;
* ``model_config_from`` — an LM config becomes the port's ``ModelConfig``;
* ``lm_params_from`` — an LM's nested parameter dict (layers stacked on axis
  0, float32 masters) becomes the port's ``LM`` state dict: matrices,
  embeddings and biases in the activation dtype, norm scales in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dg.mesh import BrickMesh
from repro_torch.dg.solver import DGSolver, torch_dtype
from repro_torch.models.common import ModelConfig
from repro_torch.runtime.executor import Plan


def mesh_from(mesh) -> BrickMesh:
    """A port ``BrickMesh`` from any object with the reference mesh's fields
    (``grid``, ``extent``, ``neighbors``, ``centers``, ``h``)."""
    return BrickMesh(
        grid=tuple(int(g) for g in mesh.grid),
        extent=tuple(float(e) for e in mesh.extent),
        neighbors=np.array(mesh.neighbors, dtype=np.int64),
        centers=np.array(mesh.centers, dtype=np.float64),
        h=tuple(float(x) for x in mesh.h),
    )


def solver_from(solver, kernel_impl: str = "auto", device: DeviceLike = None) -> DGSolver:
    """The port's ``DGSolver`` for a reference solver's mesh, materials,
    order and dtype."""
    return DGSolver(
        mesh=mesh_from(solver.mesh),
        order=int(solver.order),
        rho=np.array(solver.rho, dtype=np.float64),
        lam=np.array(solver.lam, dtype=np.float64),
        mu=np.array(solver.mu, dtype=np.float64),
        dtype=str(solver.dtype),
        kernel_impl=kernel_impl,
        device=device,
    )


def field_from(q, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A field (any array ``np.asarray`` reads) as a tensor on ``device``
    (``None`` means ``cuda``), in ``dtype`` or its own."""
    a = np.asarray(q)
    dt = torch_dtype(dtype) if dtype is not None else None
    return torch.as_tensor(np.array(a), dtype=dt, device=resolve_device(device))


def plan_from(executor) -> Plan:
    """A ``Plan`` carrying a reference executor's current ``weights`` and
    ``counts`` (and its ``round``)."""
    w = np.asarray(executor.weights, dtype=np.float64)
    counts = np.asarray(executor.counts, dtype=np.int64).copy()
    return Plan(weights=w / w.sum(), counts=counts, round=int(getattr(executor, "round", 0)))


def model_config_from(cfg, kernel_impl: str = "auto") -> ModelConfig:
    """The port's ``ModelConfig`` with every field of a reference config, and
    the port's ``kernel_impl``."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    kw["global_layers"] = tuple(kw["global_layers"])
    kw["kernel_impl"] = kernel_impl
    return ModelConfig(**kw)


def lm_params_from(params, cfg: ModelConfig, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's ``LM`` state dict from a reference LM's parameters (dense
    families).  Every leaf is read with ``np.asarray``."""
    dev = resolve_device(device)
    adt = cfg.activation_dtype

    def mat(a) -> torch.Tensor:
        return torch.as_tensor(np.array(np.asarray(a), dtype=np.float32), device=dev).to(adt)

    def norm(a) -> torch.Tensor:
        return torch.as_tensor(np.array(np.asarray(a), dtype=np.float32), device=dev)

    sd = {"embed": mat(params["embed"]), "final_ln": norm(params["final_ln"])}
    if "lm_head" in params:
        sd["lm_head"] = mat(params["lm_head"])
    layers = params["layers"]  # every leaf stacked on a leading layer axis
    stacked = {f"attn.{n}": np.asarray(a) for n, a in layers["attn"].items()}
    stacked.update({f"mlp.{n}": np.asarray(a) for n, a in layers["mlp"].items()})
    stacked["ln2"] = np.asarray(layers["ln2"])
    for i in range(cfg.n_layers):
        for name, a in stacked.items():
            sd[f"layers.{i}.{name}"] = (norm if name in ("attn.ln", "ln2") else mat)(a[i])
    return sd
