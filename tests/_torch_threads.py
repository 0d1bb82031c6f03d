"""Pins torch's intra-op threads of a test process once, on import. The
tier-1 run starts six xdist workers on eight cores, each beside XLA's own
pool: torch's default of one thread a core oversubscribes them. Every
`tests/test_torch_*.py` but the card's imports this module, so every worker
that collects them runs at THREADS. Two, not one: the reduction order moves
with the thread count, and at one thread `test_torch_stage1`'s two Adam
steps land one weight 3e-5 from JAX's, past its 1e-5 bound."""

import torch

THREADS = 2
torch.set_num_threads(THREADS)
