"""Rank functions of the spatially parallel port tests
(tests/test_torch_sp*.py), run by `gen_fvgn_tpu_torch.parallel.launch.
spawn` in fresh interpreters. This module imports neither JAX nor the JAX
package: a spawned rank imports it by name."""


def several(rank, world, jobs):
    """Each (kind, spec) of `jobs` in turn: "steps" is `tools/sp_check.
    run_steps`, "routes" `apply_routes`."""
    from gen_fvgn_tpu_torch.tools import sp_check
    fns = {"steps": sp_check.run_steps, "routes": apply_routes}
    return [fns[kind](rank, world, spec) for kind, spec in jobs]


def apply_routes(rank, world, spec):
    """Every apply route of `ops/blocksparse.py` on the sp group of the
    whole world (sp = world): forward and backward on the rank's rows of
    random operands (NumPy, seed 0, the same on every rank) through the
    sp applies. Returns, per route, the rank's output and operand
    gradient rows, with their row ranges."""
    import numpy as np
    import torch

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.ops.blocksparse import (apply_half_agg,
                                                    apply_linop,
                                                    apply_node_agg)
    from gen_fvgn_tpu_torch.parallel import sp as sp_mod
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(**spec["cfg"])
    lay = sp_mod.groups(1, world)
    pool = EnvPool([], cfg, seed=0, cases=[dict(c) for c in spec["cases"]],
                   engine="block", tile=cfg.tile, device="cpu")
    ops = sp_mod.shard_static_sp(pool.statics[0], world, rank).ops
    rng = np.random.default_rng(0)
    out = {}
    for name, fn, op_in, width, dtype in spec["routes"]:
        x = rng.normal(size=(2, op_in, width)).astype(np.float32)
        g_rows = None
        lo, hi = sp_mod.entity_rows(op_in, world, rank)
        xt = torch.from_numpy(x[:, lo:hi]).to(getattr(torch, dtype))
        xt.requires_grad_(True)
        with sp_mod.sp_context(lay):
            if fn == "half":
                y = apply_half_agg(getattr(ops, name[0]),
                                   getattr(ops, name[1]), xt)
            elif fn == "node_agg":
                y = apply_node_agg(ops, xt)
            else:
                y = apply_linop(getattr(ops, name), xt)
            g = rng.normal(size=(2, y.shape[1] * world, y.shape[2]))
            ylo, yhi = sp_mod.entity_rows(g.shape[1], world, rank)
            g_rows = torch.from_numpy(g[:, ylo:yhi].astype(np.float32)) \
                .to(y.dtype)
            y.backward(g_rows)
        key = name if isinstance(name, str) else "+".join(name)
        out[key] = dict(y=y.detach().float().numpy(),
                        dx=xt.grad.float().numpy(), rows=(lo, hi),
                        out_rows=(ylo, yhi))
    return out



def cli_rank(rank, world, runs, bad_argv):
    """Each (script, argv) of `runs` in turn (`scripts.pre_train.main` or
    `scripts.solve.main`), keeping what each returns, then `pre_train`
    with `bad_argv`, whose RuntimeError message is returned too. An
    argument holding "*" is globbed when its run starts (a checkpoint
    that an earlier run of the list wrote)."""
    import glob

    import numpy as np

    from gen_fvgn_tpu_torch.scripts import pre_train, solve
    out = []
    for script, argv in runs:
        argv = [sorted(glob.glob(a))[0] if "*" in a else a for a in argv]
        hist = {"pre_train": pre_train, "solve": solve}[script].main(argv)
        out.append(None if hist is None else [
            {k: np.asarray(v) for k, v in rec.items()} for rec in hist])
    try:
        pre_train.main(list(bad_argv))
    except RuntimeError as exc:
        return out, str(exc)
    return out, None
