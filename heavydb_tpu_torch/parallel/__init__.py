"""Multi-device and multi-host execution: the mesh, the shard-map steps, the gloo runtime and DistEngine."""
