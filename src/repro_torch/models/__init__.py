"""Model code of the port: BERT and the decoder family.

torch.utils.checkpoint (per-layer and per-period recomputation) imports
torch._dynamo at its first call, and that import keeps the calling
frames, and with them the train step's params, alive until Python's
collector runs (at full size, a whole parameter tree on the card).
Importing it here, once, keeps the first training step like the others.
"""
import torch._dynamo  # noqa: F401
