"""io — counterpart of the JAX package's sub-package of the same name."""
