"""Inference steps of the model zoo (``train_step``); training waits."""
