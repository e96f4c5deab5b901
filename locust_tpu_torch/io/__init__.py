"""Host-side ingest of the PyTorch port."""
