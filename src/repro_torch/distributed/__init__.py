"""Shard collectives on a leading shard dimension of one device or of
each of several cards (`collectives.py`) and the dispatch context of a
mesh shape (`sharding.py`).

The reference's `distributed/compat.py` has no counterpart: it holds jax
version shims (`shard_map`, `axis_size`, `pvary` across jax releases), and
the port calls PyTorch directly."""
