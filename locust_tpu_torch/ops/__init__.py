"""Map, Process and Reduce stages of the PyTorch port."""
