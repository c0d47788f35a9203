"""Training of the port (``train.py``): one device for now; meshes, sharding
and the distributed bootstrap come with the parallelism slice."""
