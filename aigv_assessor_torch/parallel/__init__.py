"""Sharding over the mesh (`sharding.py`) and the tensor axis' split
projections (`tensor.py`). Import the submodules: the model modules import
`parallel.tensor`, and `parallel.sharding` imports the model modules."""
