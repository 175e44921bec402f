"""Environment pool: the (mesh × boundary-condition) environments of a
training run or a solve, on one device.

Counterpart of `gen_fvgn_tpu/training/pool.py`, for both engines: cases
come from case directories on disk (`load_case`: a `.h5` where one is
present, else the COMSOL `.mphtxt` or the Tecplot `.dat` parsed in place)
or in memory (`cases=[...]`). Environments hold an autoregressive uvp
state; every environment is a padded `MeshSample`, so a batch is a stack
and boundary-condition re-rolls change only values, never shapes. Stencils
and WLSQ moments are computed once per mesh.

`engine="block"` (this constructor's default; the JAX one defaults to
"segment") renumbers each mesh (RCM), pads each case to its own multiple of
the tile and keeps per case one `StaticPack` and one stacked `DynamicPack`;
batches hold one case each (`block_batches`), or are drawn from one
permutation across the cases and split into per-case groups
(`mixed_block_batches`, for `MixedTrainStepBlock`). `engine="segment"` pads
every case to one `PadSizes` of `pad_multiple` (128), keeps the mesh order,
and holds the whole pool as one stacked `MeshSample` on the device (the
JAX pool's `device_resident` form, which its training loop uses); batches
are cut from one permutation of all environments (`batch_indices`) and
gathered on the device (`gather_batch`). Both engines pay states back in
place, re-roll the oldest environment's boundary condition (`reset_env`,
with the retiring solution exported to Tecplot where asked) and add the
wave family's point pressure source to its environments' p channel once an
epoch (`inject_wave_sources`).

Host-to-device copies inside a training epoch (batch indices, re-rolled
values, wave signals) go through pinned memory without blocking, so they
do not wait for the device.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.physics import (init_environment,
                                             pressure_point_source,
                                             theta_vector)
from gen_fvgn_tpu_torch.graph.sample import (MeshSample, PadSizes,
                                             pad_mesh_to_sample,
                                             stack_samples)
from gen_fvgn_tpu_torch.meshes.bc import (ThetaSample,
                                          generate_theta_combinations,
                                          load_bc)
from gen_fvgn_tpu_torch.meshes.geometry import build_stencil, compile_mesh
from gen_fvgn_tpu_torch.utils.device import resolve_device, to_device

# what a boundary-condition re-roll changes (the geometry is static)
_REROLL_FIELDS = ("uvp", "target_uv", "theta", "sigma", "uvp_dim", "dt")


def prepare_mesh_statics(mesh: Dict[str, np.ndarray], order: str,
                         k_hop: int = 2) -> Dict[str, np.ndarray]:
    """Attach the WLSQ stencil and precomputed moments (once per mesh)."""
    from gen_fvgn_tpu_torch.ops.wlsq import wlsq_moments, wlsq_solve_matrix
    if "stencil" in mesh:
        return mesh
    n_nodes = mesh["node|pos"].shape[0]
    stencil = build_stencil(mesh["face|face_node"].astype(np.int64),
                            mesh["face_node_x"].astype(np.int64),
                            n_nodes, k_hop=k_hop)
    mesh["stencil"] = stencil
    A, wB, colscale = wlsq_moments(
        mesh["node|pos"].astype(np.float32), stencil.astype(np.int32), order)
    mesh["wlsq_S"] = wlsq_solve_matrix(A, colscale, order=order)
    mesh["wlsq_B"] = np.asarray(wB, dtype=np.float32)
    mesh["wlsq_scale"] = np.asarray(colscale, dtype=np.float32)
    return mesh


def ensure_rcm(mesh: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Re-derive a compiled mesh with RCM node ordering (banded operators)."""
    from gen_fvgn_tpu_torch.graph.operators import rcm_reorder
    raw = {
        "node|pos": mesh["node|pos"],
        "node|node_type": np.asarray(mesh["node|node_type"]).reshape(-1),
        "node|surf_mask": np.asarray(
            mesh.get("node|surf_mask",
                     np.zeros(mesh["node|pos"].shape[0], bool))).reshape(-1),
        "cells_node": mesh["cells_node"],
        "cells_index": mesh["cells_index"],
    }
    return compile_mesh(rcm_reorder(raw))


def _read_case(case_dir: str) -> Dict:
    """One case directory without the WLSQ statics: the compiled mesh of
    its `.h5` where one is present (which needs h5py: without it this
    raises, and never reads another mesh file instead), else of its COMSOL
    `.mphtxt`, else of its Tecplot `.dat`; and its BC.json."""
    from gen_fvgn_tpu_torch.meshes.comsol import comsol_to_mesh
    from gen_fvgn_tpu_torch.meshes.hdf5 import read_mesh_h5
    from gen_fvgn_tpu_torch.meshes.tecplot import tecplot_to_mesh
    bc = load_bc(os.path.join(case_dir, "BC.json"))
    name = os.path.basename(os.path.abspath(case_dir))
    files = os.listdir(case_dir)
    h5s = [f for f in files if f.endswith(".h5")]
    mphtxt = [f for f in files if f.endswith(".mphtxt")]
    dats = [f for f in files if f.endswith(".dat")]
    if h5s:
        mesh = read_mesh_h5(os.path.join(case_dir, h5s[0]))
    elif mphtxt:
        mesh = compile_mesh(
            comsol_to_mesh(os.path.join(case_dir, mphtxt[0]), bc))
    elif dats:
        mesh = compile_mesh(
            tecplot_to_mesh(os.path.join(case_dir, dats[0]), name))
    else:
        raise FileNotFoundError(f"{case_dir}: no .h5, .mphtxt, or .dat mesh")
    return {"mesh": mesh, "bc": bc,
            "combos": generate_theta_combinations(bc["theta_PDE"]),
            "case_name": name}


def load_case(case_dir: str, order: str = "2nd") -> Dict:
    """Load one case directory (`_read_case`) with its WLSQ stencil and
    moments attached. Returns {"mesh", "bc", "combos", "case_name"}, the
    JAX package's `load_case` (`gen_fvgn_tpu/training/pool.py:89-119`)."""
    case = _read_case(case_dir)
    case["mesh"] = prepare_mesh_statics(
        case["mesh"], order, k_hop=int(case["bc"].get("stencil|khops", 2)))
    return case


@dataclass
class Environment:
    case: Dict                       # shared per-case statics
    sample: MeshSample               # padded arrays (NumPy), mutable uvp
    theta_sample: ThetaSample
    case_idx: int = 0
    age: int = 0


class EnvPool:
    """Pool of padded environments on `device`, for `engine` "block" or
    "segment" (see the module's docstring). The cases are `cases` where
    given, else read from `case_dirs`. `bucket_tiers` (per-size tiers of
    the segment engine) raises NotImplementedError. device="cuda" without a
    card raises."""

    def __init__(self, case_dirs: Sequence[str], cfg: Config,
                 seed: int = 0, pad_multiple: int = 128,
                 dataset_size: Optional[int] = None,
                 cases: Optional[List[Dict]] = None,
                 engine: str = "block",
                 tile: int = 256,
                 bucket_tiers: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if engine not in ("block", "segment"):
            raise ValueError(f"unknown engine {engine!r}")
        if bucket_tiers:
            raise NotImplementedError(
                "bucket_tiers=True: the segment engine's per-size padding "
                "tiers belong to a later slice of the port")
        block = engine == "block"
        if cases is None:
            # the block engine renumbers each mesh (RCM) before its statics
            # are made, so the statics of load_case would be thrown away
            cases = [_read_case(d) if block else load_case(d, cfg.order)
                     for d in case_dirs]
        self.cfg = cfg
        self.engine = engine
        self.tile = tile
        self.rng = np.random.default_rng(seed)
        if block:
            pad_multiple = max(pad_multiple, tile)
        self.cases = [dict(c) for c in cases]
        for c in self.cases:
            mesh = dict(c["mesh"])
            if block:
                mesh = ensure_rcm(mesh)
            c["mesh"] = prepare_mesh_statics(
                mesh, cfg.order, k_hop=int(c["bc"].get("stencil|khops", 2)))

        size = dataset_size if dataset_size is not None else cfg.dataset_size
        size = max(size, cfg.batch_size)

        self.sizes = PadSizes.for_meshes([c["mesh"] for c in self.cases],
                                         multiple=pad_multiple)
        # block engine: per-case buckets (batches are single-case, so every
        # case uses its own minimal padded shape); segment engine: one
        # bucket for all
        self.case_sizes = (
            [PadSizes.for_meshes([c["mesh"]], multiple=pad_multiple)
             for c in self.cases] if block
            else [self.sizes] * len(self.cases))
        self.envs: List[Environment] = []
        i = 0
        while len(self.envs) < size:
            ci = i % len(self.cases)
            self.envs.append(self._make_env(self.cases[ci], ci))
            i += 1
        self._age_order = list(range(len(self.envs)))   # oldest first
        if block:
            self._init_block_pool()
        else:
            self._device_data = stack_samples([e.sample for e in self.envs],
                                              self.device)

    def _slot(self, i: int):
        """(the device pool that holds environment i, its row there): the
        case's DynamicPack (block) or the one stacked MeshSample
        (segment)."""
        if self.engine == "block":
            return self._dyn_pools[self.envs[i].case_idx], self._env_local[i]
        return self._device_data, i

    def _rows(self, idxs: np.ndarray):
        """The pool of environments `idxs` (all in one pool) and their rows
        there, on the device."""
        pool, _ = self._slot(int(idxs[0]))
        rows = [self._slot(int(i))[1] for i in idxs]
        return pool, to_device(np.asarray(rows, np.int64), self.device)

    def _gather(self, idxs: np.ndarray):
        pool, rows = self._rows(idxs)
        return type(pool)(**{
            f.name: getattr(pool, f.name).index_select(0, rows)
            for f in dataclasses.fields(pool)})

    # ---- block engine: per-case StaticPacks + device dynamic pool ----

    def _init_block_pool(self) -> None:
        from gen_fvgn_tpu_torch.graph.packs import (DynamicPack,
                                                    build_static_pack,
                                                    dynamic_from_sample)
        self.statics = [
            build_static_pack(
                c["mesh"], self.cfg.order, self.case_sizes[ci], self.tile,
                wlsq_rows=self.cfg.wlsq_block_rows,
                node_agg=self.cfg.node_agg,
                edge_gather=self.cfg.edge_gather, device=self.device)
            for ci, c in enumerate(self.cases)]

        # one device dynamic pool per case (shapes differ across cases)
        self._env_local: List[int] = [0] * len(self.envs)
        per_case: Dict[int, list] = {}
        for i, env in enumerate(self.envs):
            self._env_local[i] = len(per_case.setdefault(env.case_idx, []))
            per_case[env.case_idx].append(i)
        self._dyn_pools = {}
        for ci, env_ids in per_case.items():
            dyns = [dynamic_from_sample(self.envs[i].sample) for i in env_ids]
            self._dyn_pools[ci] = DynamicPack(**{
                f.name: torch.stack([getattr(d, f.name) for d in dyns])
                .to(self.device)
                for f in dataclasses.fields(DynamicPack)})

    def block_batches(self, step_seed: int):
        """Per-case batches: a list of (case_idx, env index array). Each
        batch holds environments of one case (so one StaticPack serves it);
        the draw is NumPy's, from `step_seed`, so it is the JAX pool's."""
        rng = np.random.default_rng(step_seed)
        bs = self.cfg.batch_size
        out = []
        by_case: Dict[int, list] = {}
        for i, env in enumerate(self.envs):
            by_case.setdefault(env.case_idx, []).append(i)
        for ci, idxs in by_case.items():
            perm = rng.permutation(idxs)
            for j in range(len(perm) // bs):
                out.append((ci, perm[j * bs:(j + 1) * bs].astype(np.int32)))
        rng.shuffle(out)
        return out

    def mixed_block_batches(self, step_seed: int):
        """Batches from ONE permutation of all environments (the JAX pool's
        draw, from `step_seed`), cut into batch_size chunks, each chunk
        split into per-case groups so that one StaticPack serves each
        group. Returns a list of batches; a batch is a list of (case_idx,
        idxs, weights, n_real), groups in case order. A group is padded to
        the next power of two by repeating its rows at weight 0; real rows
        weigh 1/batch_size, so the sum of the groups' weighted gradients is
        the batch-mean gradient of the mixed batch."""
        rng = np.random.default_rng(step_seed)
        bs = self.cfg.batch_size
        perm = rng.permutation(len(self.envs))
        out = []
        for j in range(len(perm) // bs):
            groups: Dict[int, list] = {}
            for i in perm[j * bs:(j + 1) * bs]:
                groups.setdefault(self.envs[int(i)].case_idx,
                                  []).append(int(i))
            batch = []
            for ci in sorted(groups):
                ix = groups[ci]
                g = len(ix)
                gp = 1 << (g - 1).bit_length()
                idxs = np.asarray(ix + [ix[k % g] for k in range(gp - g)],
                                  np.int32)
                w = np.zeros(gp, np.float32)
                w[:g] = 1.0 / bs
                batch.append((ci, idxs, w, g))
            out.append(batch)
        return out

    def gather_block(self, idxs: np.ndarray):
        """The stacked DynamicPack [B, ...] of environments `idxs` (all of
        one case), gathered on the device."""
        return self._gather(idxs)

    def payback_block(self, idxs: np.ndarray, uvp_new: torch.Tensor) -> None:
        """`payback` for a batch of one case."""
        self.payback(idxs, uvp_new)

    def reset_env_block(self, export_dir: Optional[str] = None) -> None:
        """`reset_env` (the block loop's name for it)."""
        self.reset_env(export_dir)

    # ---- segment engine: one device-resident stacked pool ----

    def batch_indices(self, step_seed: int) -> List[np.ndarray]:
        """A permutation of all environments from `step_seed` (NumPy's draw,
        so the JAX pool's), cut into batches of batch_size; the ragged tail
        is dropped."""
        rng = np.random.default_rng(step_seed)
        bs = self.cfg.batch_size
        perm = rng.permutation(len(self.envs))
        return [perm[i * bs:(i + 1) * bs]
                for i in range(len(self.envs) // bs)]

    def gather_batch(self, idxs: np.ndarray) -> MeshSample:
        """The stacked MeshSample [B, ...] of environments `idxs`, gathered
        on the device."""
        return self._gather(idxs)

    # ---- both engines ----

    def payback(self, idxs: np.ndarray, uvp_new: torch.Tensor) -> None:
        """Write the new states uvp_new [B, Np, 3] of environments `idxs`
        into the device pool, in place (the JAX pool donates its buffer
        instead), and age them by one step."""
        pool, rows = self._rows(idxs)
        pool.uvp.index_copy_(0, rows, uvp_new.detach().to(pool.uvp.dtype))
        for i in idxs:
            self.envs[int(i)].age += 1

    def reset_env(self, export_dir: Optional[str] = None) -> None:
        """Re-roll the boundary condition of the oldest environment (values
        only: uvp, target_uv, theta, sigma, uvp_dim and dt of its slot in
        the device pool, written in place). The new condition is drawn from
        `self.rng` as the JAX pool draws it. With `export_dir` set, the
        retiring solution is exported first (a failing export warns)."""
        if export_dir is not None:
            self._try_export(self._age_order[0], export_dir)
        pos = self._age_order.pop(0)
        new_env = self._make_env(self.envs[pos].case, self.envs[pos].case_idx)
        self.envs[pos] = new_env
        self._age_order.append(pos)
        pool, row = self._slot(pos)
        for f in _REROLL_FIELDS:
            getattr(pool, f)[row].copy_(to_device(
                np.asarray(getattr(new_env.sample, f)), self.device))

    def has_wave_envs(self) -> bool:
        return any(e.theta_sample.source_frequency != 0 for e in self.envs)

    def inject_wave_sources(self) -> None:
        """Add each wave environment's Gaussian point pressure source, at
        time index age + 1, to its p channel in the device pool: the
        signals are computed on the host, and each pool takes one in-place
        add for all of its wave environments. No-op for the other
        families."""
        groups: Dict[int, list] = {}
        for i, env in enumerate(self.envs):
            ts = env.theta_sample
            if ts.source_frequency == 0:
                continue
            pos = env.case["mesh"]["node|pos"].astype(np.float32)
            signal = pressure_point_source(
                pos, pos.mean(axis=0), ts.source_frequency,
                ts.source_strength, ts.dt, env.age + 1
            ).reshape(-1).astype(np.float32)
            key = env.case_idx if self.engine == "block" else 0
            groups.setdefault(key, []).append((i, signal))
        for items in groups.values():
            pool, rows = self._rows(np.asarray([i for i, _ in items]))
            sigs = np.zeros((len(items), pool.uvp.shape[1]), np.float32)
            for row, (_, signal) in enumerate(items):
                sigs[row, : signal.shape[0]] = signal
            pool.uvp[:, :, 2].index_add_(0, rows,
                                         to_device(sigs, self.device))

    def host_uvp(self, idx: int) -> np.ndarray:
        """One environment's current state [Np, 3], on the host."""
        pool, row = self._slot(idx)
        return pool.uvp[row].cpu().numpy()

    def _try_export(self, pos: int, export_dir: str) -> None:
        """Export on reset: a failing export (full disk, a mixed mesh)
        must not stop training, but it warns."""
        try:
            self.export_env(pos, export_dir, tag="_reset")
        except Exception as exc:                      # noqa: BLE001
            env = self.envs[pos]
            warnings.warn(
                f"export-on-reset failed for case "
                f"{env.case.get('case_name', '?')} (env {pos}, "
                f"dir {export_dir!r}): {type(exc).__name__}: {exc}")

    def export_env(self, pos: int, out_dir: str, tag: str = "") -> str:
        """Write environment `pos`'s current solution as a Tecplot zone
        `<case name><tag>_age<age>.dat` in `out_dir`; returns the path."""
        from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_zone
        env = self.envs[pos]
        mesh = env.case["mesh"]
        n = mesh["node|pos"].shape[0]
        uvp = self.host_uvp(pos)[:n]
        path = os.path.join(
            out_dir, f"{env.case['case_name']}{tag}_age{env.age}.dat")
        write_tecplot_zone(
            path, mesh["node|pos"], mesh["cells_node"], mesh["cells_index"],
            {"U": uvp[:, 0], "V": uvp[:, 1], "P": uvp[:, 2]},
            zone_title=env.case["case_name"], solution_time=float(env.age))
        return path

    # ---- environment construction ----

    def _make_env(self, case: Dict, case_idx: int = 0) -> Environment:
        ts = case["combos"][self.rng.integers(len(case["combos"]))]
        mesh = case["mesh"]
        vals = theta_vector(case["bc"]["theta_PDE"], ts)
        uvp, target = init_environment(
            mesh["node|pos"].astype(np.float32),
            mesh["node|node_type"].reshape(-1), ts,
            inlet_type=case["bc"].get("inlet_type", "uniform"),
            init_field_type=case["bc"].get("init_field_type", "uniform"))
        prepared = dict(mesh)
        prepared.update(vals)
        prepared["uvp"] = uvp
        prepared["target|uvp"] = target
        prepared["sigma"] = np.asarray(case["bc"]["sigma"], dtype=np.float32)
        sample = pad_mesh_to_sample(prepared, self.case_sizes[case_idx],
                                    self.cfg.order)
        return Environment(case=case, sample=sample, theta_sample=ts,
                           case_idx=case_idx)

    def __len__(self) -> int:
        return len(self.envs)

