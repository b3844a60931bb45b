"""The benchmark harness of the PyTorch and CUDA port: cells, traffic,
the closed loop, the trace's reduction and the output check."""
