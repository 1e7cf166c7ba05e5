"""zkdl-tpu ported to PyTorch and CUDA: the zkDL prover (commit, infer,
chained Fiat-Shamir prove) on an NVIDIA H100, with hand-written CUDA kernels
for the Montgomery products, lazy dots and the G1 comb (see PERF.md)."""
