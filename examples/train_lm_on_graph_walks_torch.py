"""End-to-end driver of the PyTorch port (twin of
examples/train_lm_on_graph_walks.py): generate a graph with the paper's
pipeline, stream random-walk token batches from it, and train a small LM
with checkpointing; then resume once to prove restartability, and finally
train from the OUT-OF-CORE data path (disk-tier generation + external_walks
corpus: the CSR never materializes in RAM).

    PYTHONPATH=src python examples/train_lm_on_graph_walks_torch.py [--device cpu]

`--device` defaults to cuda (and raises without it); `--device cpu` runs the
plain PyTorch path.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = ["--device", ap.parse_args().device]

with tempfile.TemporaryDirectory() as ck:
    # phase 1: 120 steps, checkpoint every 40
    losses1 = train_main([
        "--arch", "internlm2-1.8b", "--scale", "11",
        "--steps", "120", "--batch", "8", "--seq", "64",
        "--lr", "2e-3", "--ckpt-dir", ck, "--ckpt-every", "40",
    ] + device)
    # phase 2: ask for 200 steps -> resumes at 120, runs the remaining 80
    losses2 = train_main([
        "--arch", "internlm2-1.8b", "--scale", "11",
        "--steps", "200", "--batch", "8", "--seq", "64",
        "--lr", "2e-3", "--ckpt-dir", ck, "--ckpt-every", "40",
    ] + device)

print(f"\nphase-1 loss: {np.mean(losses1[:10]):.3f} -> {np.mean(losses1[-10:]):.3f}")
print(f"phase-2 (resumed) continued to {np.mean(losses2[-10:]):.3f} "
      f"over {len(losses2)} additional steps")
assert len(losses2) < 200, "second run must resume, not restart"
assert np.mean(losses2[-10:]) < np.mean(losses1[:10])
print("end-to-end train + resume OK")

# phase 3: the same training loop fed from the external-memory tier:
# out-of-core generation, walk corpus streamed from a disk memmap
with tempfile.TemporaryDirectory() as wd:
    losses3 = train_main([
        "--arch", "internlm2-1.8b", "--scale", "11",
        "--steps", "60", "--batch", "8", "--seq", "64",
        "--lr", "2e-3", "--data", "external", "--workdir", wd,
    ] + device)
print(f"external-data loss: {np.mean(losses3[:10]):.3f} -> "
      f"{np.mean(losses3[-10:]):.3f}")
assert np.mean(losses3[-10:]) < np.mean(losses3[:10])
print("out-of-core data path train OK")
