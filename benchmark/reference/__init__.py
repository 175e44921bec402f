"""The benchmark's plain reference of the system under test.

Plain PyTorch and NumPy, written from the model's equations and the
finite-volume scheme: it imports nothing of the program (`gen_fvgn_tpu_torch`)
and nothing of the JAX package. It works every mesh static out again from
the raw mesh that the benchmark wrote, and runs in float32 with TF32 off.
"""
