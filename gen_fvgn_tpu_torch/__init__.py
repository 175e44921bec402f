"""gen_fvgn_tpu_torch — the PyTorch/CUDA port of the JAX package.

A second package beside the JAX one, with the same module and function
names so a reader finds each counterpart. It imports torch, numpy and scipy
only. Entry points take `device=` and default to "cuda"; with no card they
raise instead of running on the CPU.

Ported so far, on the block engine: the rollout and the train step of
the FVGN and Transolver nets, the training run around the step, and the
instance-optimisation solves

    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block
    from gen_fvgn_tpu_torch.training.train_block import make_train_step_block
    from gen_fvgn_tpu_torch.training.loop import train
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam_block

with hand-written CUDA kernels (csrc/*.cu) built by nvcc at first use into
`_build/`.
"""

from gen_fvgn_tpu_torch.config import Config, load_config, save_config

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "save_config", "__version__"]
