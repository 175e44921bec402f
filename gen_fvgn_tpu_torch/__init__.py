"""gen_fvgn_tpu_torch — the PyTorch/CUDA port of the JAX package.

A second package beside the JAX one, with the same module and function
names so a reader finds each counterpart. It imports torch, numpy and scipy
only. Entry points take `device=` and default to "cuda"; with no card they
raise instead of running on the CPU.

Ported so far, on both engines (the segment engine, the Config's
default, and the block engine): the rollout and the train step of the
FVGN and Transolver nets, the training run around the step, the
instance-optimisation solves, and the `pre_train` / `solve` CLIs

    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train import (init_train_state,
                                                   make_train_step)
    from gen_fvgn_tpu_torch.solve.rollout import rollout
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam, solve_lbfgs
    from gen_fvgn_tpu_torch.training.loop import train
    # the block engine: make_simulator_block, make_train_step_block,
    # rollout_block, solve_adam_block, solve_lbfgs_block

with hand-written CUDA kernels (csrc/*.cu) built by nvcc at first use into
`_build/`.
"""

from gen_fvgn_tpu_torch.config import Config, load_config, save_config

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "save_config", "__version__"]
