"""analysis layer of the PyTorch port."""
