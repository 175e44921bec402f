"""parallel — counterpart of the JAX package's sub-package of the same name:
data parallelism over `torch.distributed`, one process a rank
(`multihost.py`, `dp.py`), and the spawning of ranks on one machine
(`launch.py`). Spatial parallelism (`sp.py`) is not ported yet."""
