"""server of the PyTorch port."""
