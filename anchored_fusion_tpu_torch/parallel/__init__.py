"""Multi-device runtime on torch.distributed (process group, (dp, mp) mesh,
collectives, rank launcher) and the sharded genome index."""
