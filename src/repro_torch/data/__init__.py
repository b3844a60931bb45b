"""Synthetic stream sources (the paper's §V workloads)."""
