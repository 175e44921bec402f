"""Where a rollout step's, or a train step's, time goes on the card.

    python -m gen_fvgn_tpu_torch.tools.profile_rollout [--net TransFVGN_v2]
        [--steps 20] [--batch 8] [--train] [--engine block|segment]
        [--gather-pair] [--node-pair]

Sets up the port's main path (the Config defaults: TransFVGN_v2, hidden
128, 2 processors of 3 blocks and a Transolver block, 8 heads, 32 slices,
bf16 stream; or --net FVGN / TransFVGN_v1 at the same widths; batch 8,
101x101-node synthetic cavity, seeded random weights; with --gather-pair
and --node-pair the GraphNet blocks take the paired sparse applies, kernels
K8 and K9, on the same weights; with --engine segment the segment engine's
step on the same cavity, padded to multiples of 128, with the same
weights), then prints

  * the card's name and power limit;
  * ms per step on the host clock (ending in a synchronize) for
    `rollout_block_scan` (state stays on the device) and `rollout_block`
    (records copied to the host each step), or on the segment engine for
    its eval step fed back on the device and `rollout`; with --train
    instead for `make_train_step_block` (forward, backward through the
    kernels' backward passes, Adam) on the batch `EnvPool.block_batches`
    gives, from `init_train_state_block`, or `make_train_step` on the
    segment pool's first batch, from `init_train_state`;
  * from torch.profiler over one more such window: device-busy ms per step
    (device kernels only), the device's idle share (1 - busy / unprofiled
    wall), and the device time by kernel name, largest first;
  * peak device memory.

Needs one CUDA card. If the profiler reports no device time the idle share
is printed as "not measured".
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def build_main_path(batch: int = 8, mesh_n: int = 100, device="cuda",
                    seed: int = 0, net: str = "TransFVGN_v2",
                    gather_pair: bool = False, node_pair: bool = False,
                    engine: str = "block"):
    """(cfg, pool, static, dyn, simulator, norm_state) of the main path at
    full width: the Config defaults (net "TransFVGN_v2"), or another net
    at the same widths; the simulator with the paired sparse applies where
    asked. With engine "segment": the segment pool, static None, the
    stacked MeshSample batch and the segment simulator (the same
    weights)."""
    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net=net, hidden_size=128, message_passing_num=3,
                 mxu_dtype="bfloat16", node_agg="composed",
                 edge_gather="take", fv_packed=True, order="2nd",
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", default="TransFVGN_v2",
                    choices=["TransFVGN_v2", "TransFVGN_v1", "FVGN"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of rollout steps")
    ap.add_argument("--gather-pair", action="store_true",
                    help="the EdgeBlocks' paired gather (kernel K8)")
    ap.add_argument("--node-pair", action="store_true",
                    help="the NodeBlocks' paired aggregation (K8, K9)")
    ap.add_argument("--engine", default="block", choices=["block", "segment"],
                    help="the sparse-op engine whose step is timed")
    args = ap.parse_args(argv)
    segment = args.engine == "segment"
    if segment and (args.gather_pair or args.node_pair):
        raise SystemExit("the paired applies are block-engine forms")
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gen_fvgn_tpu_torch.solve.rollout_block import (rollout_block,
                                                        rollout_block_scan)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    pairs = dict(gather_pair=args.gather_pair, node_pair=args.node_pair)
    cfg, pool, static, dyn, sim, ns = build_main_path(
        batch=args.batch, net=args.net, engine=args.engine, **pairs)
    print(f"net {cfg.net}, engine {args.engine}, batch {args.batch}, "
          f"{dyn.uvp.shape[1]} padded nodes, {pairs}")
    n = args.steps

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    if args.train and segment:
        from gen_fvgn_tpu_torch.training.train import (init_train_state,
                                                       make_train_step)
        state, tsim = init_train_state(cfg, seed=0)
        seg_step = make_train_step(cfg, tsim)
        tbatch = pool.gather_batch(pool.batch_indices(step_seed=0)[0])
        train_step = lambda st, b, _: seg_step(st, b)
    elif args.train:
        from gen_fvgn_tpu_torch.training.train_block import (
            init_train_state_block, make_train_step_block)
        state, tsim = init_train_state_block(cfg, seed=0, **pairs)
        train_step = make_train_step_block(cfg, tsim)
        _, idxs = pool.block_batches(step_seed=0)[0]
        tbatch = pool.gather_block(idxs)
    if args.train:
        def window(k):
            nonlocal state
            for _ in range(k):
                state, _, _ = train_step(state, tbatch, static)
        window(3)                                           # warm-up
        torch.cuda.reset_peak_memory_stats()
        runs = [timed(lambda: window(n)) for _ in range(3)]
        print(f"train step:         {min(runs):.3f} ms/step (best of 3 runs "
              f"of {n} steps: {[round(v, 3) for v in runs]})")
    else:
        if segment:
            from gen_fvgn_tpu_torch.solve.rollout import (make_eval_step,
                                                          rollout)
            eval_step = make_eval_step(cfg, sim)

            def window(k):
                b = dyn
                for _ in range(k):
                    b = b.replace(uvp=eval_step(ns, b).uvp_node_new)
            with_host = lambda: rollout(cfg, sim, ns, dyn, n)
            names = ("eval step fed back", "rollout")
        else:
            def window(k):
                rollout_block_scan(cfg, sim, ns, dyn, static, k)
            with_host = lambda: rollout_block(cfg, sim, ns, dyn, static, n)
            names = ("rollout_block_scan", "rollout_block")
        window(3)                                           # warm-up
        torch.cuda.reset_peak_memory_stats()
        runs = [timed(lambda: window(n)) for _ in range(3)]
        host_ms = [timed(with_host) for _ in range(3)]
        print(f"{names[0]}: {min(runs):.3f} ms/step (best of 3 runs "
              f"of {n} steps: {[round(v, 3) for v in runs]})")
        print(f"{names[1]}: {min(host_ms):.3f} ms/step (best of 3 "
              f"runs of {n} steps: {[round(v, 3) for v in host_ms]})")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        window(n)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    # device kernels only: the operator rows of key_averages() repeat their
    # kernels' device time, and so does the device-side range of the
    # optimizer's step annotation ("Optimizer.step#Adam.step")
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == DeviceType.CUDA \
                and not ev.key.startswith("Optimizer."):
            rows.append((dev_us / 1e3 / n, ev.count / n, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    wall = min(runs)
    print(f"profiled window: {wall_ms:.3f} ms/step wall with the profiler "
          f"on (its start-up included); idle share is taken against the "
          f"unprofiled {wall:.3f} ms/step")
    if busy <= 0:
        print("device busy: not measured (the profiler reported no device "
              "time); idle share: not measured")
        return 0
    ours = sum(r[0] for r in rows if any(
        k in r[2] for k in ("spmm_csr_kernel", "pair_sum_kernel",
                            "pair_transpose_kernel", "fused_mlp_", "premlp_",
                            "slice_pool_", "lane_reduce", "chunk_reduce")))
    print(f"device busy: {busy:.3f} ms/step ({ours:.3f} in the port's "
          f"kernels); idle share {1 - busy / wall:.3f}; "
          f"{sum(r[1] for r in rows):.0f} device kernels/step")
    print(f"{'ms/step':>9} {'calls/step':>10}  kernel")
    for ms, calls, key in rows[: args.top]:
        print(f"{ms:9.4f} {calls:10.1f}  {key[:110]}")
    rest = rows[args.top:]
    if rest:
        print(f"{sum(r[0] for r in rest):9.4f} "
              f"{sum(r[1] for r in rest):10.1f}  ({len(rest)} more)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
