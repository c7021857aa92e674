"""Row-sharded rendering and training over the ranks of a
`torch.distributed` group: the port of ``haskell_path_tracer_tpu/parallel``.
`mesh.py` lays the ranks out as a (tile, sample) mesh, `shard.py` runs the
renderers and the gradient step on each rank's row block, and
`multihost.py` starts the group and moves host data onto the ranks."""
