"""parallel — counterpart of the JAX package's sub-package of the same name:
data parallelism over `torch.distributed`, one process a rank
(`multihost.py`, `dp.py`), and the spawning of ranks on one machine
(`launch.py`), and spatial parallelism of the block engine, one mesh cut
by rows over the ranks (`sp.py`)."""
