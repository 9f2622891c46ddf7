"""Command-line drivers of the port: `serve` (the LM Engine) and `cluster`
(the cluster runtime's hosts, runs and job queue)."""
