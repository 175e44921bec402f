"""Static-shape padded mesh samples and batch assembly.

Counterpart of `gen_fvgn_tpu/graph/sample.py`: every mesh is padded once to a
bucket shape (host-side NumPy) and a batch is a leading-axis stack
`[B, ...]` of torch tensors on a device (`stack_samples`).

Padding conventions:
  * index arrays point at slot 0 when padded; every padded slot carries a
    False mask;
  * shapes never depend on the boundary-condition re-roll — a reset changes
    array values only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from gen_fvgn_tpu_torch.utils.device import resolve_device, to_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class PadSizes:
    """Bucket shape for one mesh tier."""
    n_nodes: int      # Np
    n_faces: int      # Ef
    n_cells: int      # Nc
    n_slots: int      # Ck (flat cell→node incidence length)
    n_stencil: int    # Es (one-way WLSQ stencil edges)

    @staticmethod
    def for_meshes(meshes: Sequence[Dict[str, np.ndarray]], multiple: int = 128
                   ) -> "PadSizes":
        """Single bucket covering every mesh, rounded up to `multiple`."""
        def mx(fn):
            return _round_up(max(int(fn(m)) for m in meshes), multiple)
        return PadSizes(
            n_nodes=mx(lambda m: m["node|pos"].shape[0]),
            n_faces=mx(lambda m: m["face|face_node"].shape[1]),
            n_cells=mx(lambda m: m["cell|centroid"].shape[0]),
            n_slots=mx(lambda m: m["cells_node"].shape[0]),
            n_stencil=mx(lambda m: m["stencil"].shape[1]),
        )


@dataclass
class MeshSample:
    """One padded (mesh × boundary-condition) environment, NumPy arrays; or
    a batch of them, every field a [B, ...] torch tensor (`stack_samples`).
    """
    # nodes
    pos: np.ndarray           # [Np, 2] f32
    node_type: np.ndarray     # [Np] i32
    node_mask: np.ndarray     # [Np] bool
    uvp: np.ndarray           # [Np, 3] f32 — current (dimensional) state
    target_uv: np.ndarray     # [Np, 2] f32 — dimensionless Dirichlet targets
    # faces
    face_node: np.ndarray     # [2, Ef] i32
    face_type: np.ndarray     # [Ef] i32
    face_mask: np.ndarray     # [Ef] bool
    face_area: np.ndarray     # [Ef] f32
    face_center: np.ndarray   # [Ef, 2] f32
    # cells
    centroid: np.ndarray      # [Nc, 2] f32
    cells_area: np.ndarray    # [Nc] f32
    cell_mask: np.ndarray     # [Nc] bool
    # flat ragged cell slots
    cells_node: np.ndarray    # [Ck] i32
    cells_face: np.ndarray    # [Ck] i32
    cells_index: np.ndarray   # [Ck] i32
    slot_mask: np.ndarray     # [Ck] bool
    slot_unv: np.ndarray      # [Ck, 2] f32 — outward unit normals per slot
    # WLSQ stencil + precomputed moments
    stencil: np.ndarray       # [2, Es] i32 (one-way)
    stencil_mask: np.ndarray  # [Es] bool
    wlsq_S: np.ndarray        # [Np, k, k] f32 precomputed solve matrix
    wlsq_B: np.ndarray        # [Es, k] f32 (one-way rows, unscaled)
    wlsq_scale: np.ndarray    # [Np, k] f32 local column scaling
    # per-graph physics
    theta: np.ndarray         # [9] f32 — θ_PDE
    sigma: np.ndarray         # [3] f32 — output channel mask
    uvp_dim: np.ndarray       # [3] f32 — [U, U, U²]
    dt: np.ndarray            # [] f32 — dimensionless time step (dt·U)

    def replace(self, **kw) -> "MeshSample":
        return dataclasses.replace(self, **kw)


def _pad(arr: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    pad_n = size - arr.shape[axis]
    if pad_n < 0:
        raise ValueError(f"array of size {arr.shape[axis]} exceeds bucket {size}")
    if pad_n == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad_n)
    return np.pad(arr, widths, mode="constant", constant_values=fill)


def _mask(n_valid: int, size: int) -> np.ndarray:
    m = np.zeros(size, dtype=bool)
    m[:n_valid] = True
    return m


def pad_mesh_to_sample(mesh: Dict[str, np.ndarray], sizes: PadSizes,
                       order: str = "2nd") -> MeshSample:
    """Pad a compiled+prepared mesh dict into a MeshSample.

    Expects, beyond the compile_mesh outputs: "stencil" [2, Es],
    "wlsq_S" [N,k,k], "wlsq_B" [Es,k], "uvp" [N,3], "target|uvp" [N,2],
    "theta_PDE" [9], "sigma" [3], "uvp_dim" [3], "dt_graph" scalar.
    """
    f32, i32 = np.float32, np.int32
    n = mesh["node|pos"].shape[0]
    e = mesh["face|face_node"].shape[1]
    c = mesh["cell|centroid"].shape[0]
    ck = mesh["cells_node"].shape[0]
    es = mesh["stencil"].shape[1]

    return MeshSample(
        pos=_pad(mesh["node|pos"].astype(f32), sizes.n_nodes),
        node_type=_pad(mesh["node|node_type"].astype(i32), sizes.n_nodes),
        node_mask=_mask(n, sizes.n_nodes),
        uvp=_pad(mesh["uvp"].astype(f32), sizes.n_nodes),
        target_uv=_pad(mesh["target|uvp"].astype(f32), sizes.n_nodes),
        face_node=_pad(mesh["face|face_node"].astype(i32), sizes.n_faces, axis=1),
        face_type=_pad(mesh["face|face_type"].astype(i32), sizes.n_faces),
        face_mask=_mask(e, sizes.n_faces),
        face_area=_pad(mesh["face|face_area"].reshape(-1).astype(f32), sizes.n_faces),
        face_center=_pad(mesh["face|face_center_pos"].astype(f32), sizes.n_faces),
        centroid=_pad(mesh["cell|centroid"].astype(f32), sizes.n_cells),
        cells_area=_pad(mesh["cell|cells_area"].reshape(-1).astype(f32), sizes.n_cells),
        cell_mask=_mask(c, sizes.n_cells),
        cells_node=_pad(mesh["cells_node"].astype(i32), sizes.n_slots),
        cells_face=_pad(mesh["cells_face"].astype(i32), sizes.n_slots),
        cells_index=_pad(mesh["cells_index"].astype(i32), sizes.n_slots),
        slot_mask=_mask(ck, sizes.n_slots),
        slot_unv=_pad(mesh["unit_norm_v"].astype(f32), sizes.n_slots),
        stencil=_pad(mesh["stencil"].astype(i32), sizes.n_stencil, axis=1),
        stencil_mask=_mask(es, sizes.n_stencil),
        wlsq_S=_pad(mesh["wlsq_S"].astype(f32), sizes.n_nodes),
        wlsq_B=_pad(mesh["wlsq_B"].astype(f32), sizes.n_stencil),
        wlsq_scale=_pad(mesh["wlsq_scale"].astype(f32), sizes.n_nodes, fill=1),
        theta=mesh["theta_PDE"].reshape(-1).astype(f32),
        sigma=np.asarray(mesh["sigma"], dtype=f32).reshape(-1),
        uvp_dim=np.asarray(mesh["uvp_dim"], dtype=f32).reshape(-1),
        dt=np.asarray(mesh["dt_graph"], dtype=f32).reshape(()),
    )



def stack_samples(samples: List[MeshSample], device="cuda") -> MeshSample:
    """Stack samples into a [B, ...] batch of torch tensors on `device`
    (the JAX function stacks NumPy arrays on the host). device="cuda"
    without a card raises."""
    dev = resolve_device(device)
    return MeshSample(**{
        f.name: to_device(np.stack([getattr(s, f.name) for s in samples]),
                          dev)
        for f in dataclasses.fields(MeshSample)})
