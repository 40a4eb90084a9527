"""Models of the PyTorch port: hyperparameters, loader, forward passes."""

from .loader import LoadedModel, load_model

__all__ = ["LoadedModel", "load_model"]
