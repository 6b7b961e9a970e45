from lorads_torch.io.sdpa import read_sdpa, write_sdpa
from lorads_torch.io import generators

__all__ = ["read_sdpa", "write_sdpa", "generators"]
