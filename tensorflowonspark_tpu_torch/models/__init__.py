"""Model definitions of the port (PyTorch ``nn.Module``s)."""
