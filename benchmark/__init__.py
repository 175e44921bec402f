"""The benchmark of the PyTorch/CUDA port (`gen_fvgn_tpu_torch`)."""
