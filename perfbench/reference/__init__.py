"""Plain float32 PyTorch references of the benchmark's models and
optimizers.  They import nothing of the program: every weight, batch and
dropout seed comes from the benchmark, and whatever the program derives
from them (casts, flat buffers, masks) is worked out here again."""
