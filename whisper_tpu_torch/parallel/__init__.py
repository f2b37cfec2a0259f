"""Training steps (train.py); meshes and sharding come with the parallel
slice of the port."""
