"""The port's CPU tests share the machine with the JAX tests' worker
processes: one intra-op thread per process keeps PyTorch from
oversubscribing the cores (each test's tensors are small)."""

import torch

torch.set_num_threads(1)
