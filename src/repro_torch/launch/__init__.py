"""Command-line drivers of the port, `serve` (the LM Engine), `train` (graph
-> walk corpus -> LM training) and `cluster` (the cluster runtime's hosts,
runs and job queue); and the one-card launch tooling: `mesh` (the H100's
roofline constants, the reference's mesh shapes as axis sizes), `roofline`
(a step's roofline terms from a measured step; kernel bounds), `attribution`
(the profiler's device time ranked by kernel and by kind), `cells` (one
arch x shape cell), `dryrun` (every cell on the meta device) and `perf`
(named variants of a cell, run and measured on the card).

The reference's `hlo_cost.py` has no counterpart: it walks XLA's optimized
HLO text for flops and bytes with loop trip counts, and eager PyTorch
compiles no module to walk.  `roofline.from_measured` counts the flops of a
real step instead, and `attribution` reads the profiler."""
