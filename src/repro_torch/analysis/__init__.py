"""zenlint for the PyTorch port."""
