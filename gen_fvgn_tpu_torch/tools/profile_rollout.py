"""The port's main path set up at full width, and a device profile of a
window of its steps: the pieces that `kernel_times.py`, `pair_probe.py`,
`dp_check.py` and `chip_smoke.py` time with. A cell's step, traced, with
the program's spans, is `benchmark/run.py --trace 1`.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def build_main_path(batch: int = 8, mesh_n: int = 100, device="cuda",
                    seed: int = 0, net: str = "TransFVGN_v2",
                    gather_pair: bool = False, node_pair: bool = False,
                    engine: str = "block", node_agg: str = "composed",
                    edge_gather: str = "take"):
    """(cfg, pool, static, dyn, simulator, norm_state) of the main path at
    full width: the Config defaults (net "TransFVGN_v2"), or another net
    at the same widths, or other block-engine forms (node_agg,
    edge_gather); the simulator with the paired sparse applies
    where asked. With engine "segment": the segment pool, static None, the
    stacked MeshSample batch and the segment simulator (the same
    weights)."""
    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net=net, hidden_size=128, message_passing_num=3,
                 mxu_dtype="bfloat16", node_agg=node_agg,
                 edge_gather=edge_gather, fv_packed=True, order="2nd",
                 integrator="imex", batch_size=batch, dataset_size=batch,
                 engine=engine)
    case = synthetic_case(cavity_quad_mesh(mesh_n), continuity=1,
                          convection=1, grad_p=1, mu=0.05, sigma=(1, 1, 1))
    norm_state = init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                                 device=device)
    if engine == "segment":
        from gen_fvgn_tpu_torch.models.simulator import make_simulator
        pool = EnvPool([], cfg, seed=seed, cases=[case], dataset_size=batch,
                       engine="segment", device=device)
        return (cfg, pool, None, pool.gather_batch(np.arange(batch)),
                make_simulator(cfg, device=device, seed=seed), norm_state)
    pool = EnvPool([], cfg, seed=seed, cases=[case], dataset_size=batch,
                   device=device)
    dyn = pool.gather_block(np.arange(batch))
    sim = make_simulator_block(cfg, device=device, seed=seed,
                               gather_pair=gather_pair, node_pair=node_pair)
    return cfg, pool, pool.statics[0], dyn, sim, norm_state


def device_profile(window, n: int):
    """`window(n)` under torch.profiler: (wall ms a step with the profiler
    on, its start-up included; [(device ms a step, calls a step, kernel
    name)], largest first). Device kernels only: the operator rows of
    key_averages() repeat their kernels' device time, and so does the
    device-side range of the optimizer's step annotation
    ("Optimizer.step#Adam.step"). An empty list where the profiler
    reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        window(n)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == DeviceType.CUDA \
                and not ev.key.startswith("Optimizer."):
            rows.append((dev_us / 1e3 / n, ev.count / n, ev.key))
    rows.sort(reverse=True)
    return wall_ms, rows
