"""Shard collectives on a leading shard dimension of one device."""
