"""Multi-device decode (``mesh.py``): GOP sharding, MB-row bands with
halo exchange and the cross-GOP DPB page exchange on torch.distributed."""
