"""runtime of the PyTorch port."""
