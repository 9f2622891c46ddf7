"""Command-line drivers of the port: `serve` (the LM Engine), `train` (graph
-> walk corpus -> LM training) and `cluster` (the cluster runtime's hosts,
runs and job queue)."""
