"""Multi-device rendering on torch.distributed: the row-sharded frame
with halo exchanges through the hand kernels (halo.py, spmd.py) and the
(dp, sp) mesh with the multi-view training step (sharding.py)."""
