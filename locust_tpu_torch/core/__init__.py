"""Core data model and byte/lane primitives of the PyTorch port."""
