"""Static/dynamic split of the mesh state for the block engine.

Counterpart of `gen_fvgn_tpu/graph/packs.py`. The per-case `StaticPack`
(geometry + operators) is shared by every environment of a case; the
per-environment `DynamicPack` carries only what a boundary-condition
re-roll or a payback changes, stacked [B, ...].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from gen_fvgn_tpu_torch.graph.operators import (MeshOperators,
                                                build_mesh_operators)
from gen_fvgn_tpu_torch.utils.device import resolve_device


def _tree_to(obj, device):
    """Move every tensor / operator field of a dataclass to `device`."""
    return type(obj)(**{
        f.name: (getattr(obj, f.name).to(device)
                 if hasattr(getattr(obj, f.name), "to")
                 else getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@dataclass
class StaticPack:
    ops: MeshOperators
    pos: torch.Tensor            # [Np, 2]
    node_type: torch.Tensor      # [Np] i32
    node_mask: torch.Tensor      # [Np] bool
    cells_area: torch.Tensor     # [Nc, 1] (padded rows zero)
    edge_pos_feat: torch.Tensor  # [E, 3] pos_s − pos_r ⊕ ‖·‖ (padded zero)

    def to(self, device) -> "StaticPack":
        return _tree_to(self, device)


@dataclass
class DynamicPack:
    uvp: torch.Tensor            # [(B,) Np, 3]
    target_uv: torch.Tensor      # [(B,) Np, 2]
    theta: torch.Tensor          # [(B,) 9]
    sigma: torch.Tensor          # [(B,) 3]
    uvp_dim: torch.Tensor        # [(B,) 3]
    dt: torch.Tensor             # [(B,)]

    def to(self, device) -> "DynamicPack":
        return _tree_to(self, device)

    def replace(self, **kw) -> "DynamicPack":
        return dataclasses.replace(self, **kw)


def build_static_pack(mesh: Dict[str, np.ndarray], order: str, sizes,
                      tile: int = 256,
                      wlsq_rows: str = "grad",
                      node_agg: str = "split",
                      edge_gather: str = "take",
                      device="cuda") -> StaticPack:
    dev = resolve_device(device)
    ops = build_mesh_operators(mesh, order, sizes, tile,
                               wlsq_rows=wlsq_rows, node_agg=node_agg,
                               edge_gather=edge_gather)
    f32 = np.float32
    n = mesh["node|pos"].shape[0]
    e = mesh["face|face_node"].shape[1]
    c = mesh["cell|centroid"].shape[0]

    pos = np.zeros((sizes.n_nodes, 2), f32)
    pos[:n] = mesh["node|pos"]
    node_type = np.full(sizes.n_nodes, -1, np.int32)
    node_type[:n] = mesh["node|node_type"].reshape(-1)
    node_mask = np.zeros(sizes.n_nodes, bool)
    node_mask[:n] = True
    cells_area = np.zeros((sizes.n_cells, 1), f32)
    cells_area[:c, 0] = mesh["cell|cells_area"].reshape(-1)

    fn = mesh["face|face_node"]
    dp = (mesh["node|pos"][fn[0]] - mesh["node|pos"][fn[1]]).astype(f32)
    epf = np.zeros((sizes.n_faces, 3), f32)
    epf[:e, 0:2] = dp
    epf[:e, 2] = np.linalg.norm(dp, axis=1)

    return StaticPack(
        ops=ops,
        pos=torch.from_numpy(pos),
        node_type=torch.from_numpy(node_type),
        node_mask=torch.from_numpy(node_mask),
        cells_area=torch.from_numpy(cells_area),
        edge_pos_feat=torch.from_numpy(epf),
    ).to(dev)


def dynamic_from_sample(sample) -> DynamicPack:
    """Extract the dynamic fields from a (padded) MeshSample (host tensors)."""
    t = lambda a: torch.from_numpy(np.array(a))
    return DynamicPack(
        uvp=t(sample.uvp), target_uv=t(sample.target_uv),
        theta=t(sample.theta), sigma=t(sample.sigma),
        uvp_dim=t(sample.uvp_dim), dt=t(sample.dt))
